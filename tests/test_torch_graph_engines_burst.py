"""``step(n_tokens=k)`` as one replay of a k-step graph, on the CPU, where no
CUDA graph can be captured. With ``require_graph`` lifted (``StepGraph``
then runs its body eagerly over the same buffers, the form a replay
computes; no host read in it):

- the dense and paged bursts against k ``step()`` calls of the eager
  engine, call by call: the tokens, the engine generator's state, and the
  device lengths and output counts the host records; one graph call a
  burst, keyed (k, the picker's form);
- rows that retire inside a burst: at EOS, at a stop sequence, at their
  budget, at the window's end (a row at ``block_size - 1`` beside one of
  headroom 8), and an unseeded sampler whose retirement stops the single
  steps' draws (the generator is left where they leave it); a second wave
  admitted into the freed slots, whose state the burst left stale;
- a constrained co-tenant, and a beam group, turning the call into k
  one-step replays;
- greedy bursts against JAX's ``step(n_tokens=k)`` up to each row's first
  near tie: the dense engine, and the paged engine under preemption;
- Whisper's burst against the port's single steps and JAX's
  ``step(n_tokens=k)``.
"""

import jax
import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu.serving import PagedDecodeEngine as JaxPaged
from mop_tpu.serving import WhisperServingEngine as JaxWhisperEngine
from mop_tpu_torch.serving import DecodeEngine, PagedDecodeEngine, WhisperServingEngine, choices
from mop_tpu_torch.serving import engine as E
from mop_tpu_torch.serving import whisper as W

from _torch_decode_common import lift_graphs
from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of, to_torch)
from test_torch_serving_whisper import BOS, TIE, _margins, _setup

K = 8
BLOCK = 16  # the pair's block_size


@pytest.fixture
def lifted(monkeypatch):
    """The graphed engines on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, E, W)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


@pytest.fixture(scope="module")
def pair():
    return lm_pair("quartet", scale=3.0)


def _first_new(ref, start=2):
    """The first index from ``start`` whose token (with the next) did not
    occur before it in ``ref``."""
    return next(i for i in range(start, len(ref) - 1) if ref[i] not in ref[:i]
                and ref[i:i + 2] not in [ref[j:j + 2] for j in range(i)])


def _jobs(pm, case):
    """One wave's (prompt, budget, options): a row that retires inside the
    burst beside rows that outlive it."""
    p = prompts_of([5, 4, 6], seed=40)
    ref, _ = cached_ref(pm, None, p[0], 10)
    i = _first_new(ref)
    first = {"eos": (p[0], 10, dict(eos_id=ref[i])),
             "stop": (p[0], 10, dict(stop=[ref[i:i + 2]])),
             "budget": (p[0], 3, {}),
             "window": (prompts_of([BLOCK - 1], seed=41)[0], 10, {}),
             "sampler": (p[0], 3, dict(temperature=0.9, top_k=20))}[case]
    return [first, (p[1], 9, dict(temperature=1.0, seed=17, repetition_penalty=1.3)),
            (p[2], 9, dict(logit_bias={4: 2.5}))]


# the second wave: other options in the slots the first left
WAVE2 = [(8, dict(temperature=0.8)), (9, {}), (7, dict(temperature=1.1, seed=3, top_p=0.9))]


def _waves(make, jobs, k=K):
    """Two waves of one-wave jobs (every request admitted at the call's
    start) through the graphed engine's ``step(n_tokens=k)`` and the eager
    engine's k ``step()`` calls, side by side: each call's tokens equal, the
    generators' states equal, and the graphed engine's device lengths and
    output counts what its host recorded. Returns both engines."""
    eager, graphed = make(False), make(True)
    for wave in (jobs, [(p, n, kw) for (p, _, _), (n, kw) in zip(jobs, WAVE2)]):
        for eng in (eager, graphed):
            for prompt, n, kw in wave:
                eng.submit(prompt, n, **kw)
        while graphed.n_queued or graphed.n_active or eager.n_queued or eager.n_active:
            got = graphed.step(n_tokens=k)
            want = {}
            for _ in range(k):
                for rid, toks in eager.step().items():
                    want.setdefault(rid, []).extend(toks)
            assert got == want
            assert torch.equal(graphed._gen.get_state(), eager._gen.get_state())
            for mirror in (graphed._dlens, graphed._dntok):
                assert torch.equal(mirror.dev, torch.from_numpy(mirror._held))
    assert graphed.results == eager.results
    return eager, graphed


@pytest.mark.parametrize("case", ["eos", "stop", "budget", "window", "sampler"])
def test_dense_burst_is_k_single_steps(pair, case, lifted):
    pm = pair[2]
    jobs = _jobs(pm, case)

    def make(graphed):
        return DecodeEngine(pm, None, max_batch=3, cuda_graph=graphed,
                            generator=torch.Generator().manual_seed(8))

    eager, graphed = _waves(make, jobs)
    bursts = [k for k, _ in graphed._graph.graphs if k > 1]
    assert bursts and max(bursts) == K  # the second wave's rows outlive K
    if case == "window":  # headroom 1 beside 8: one burst of 8 for the first wave
        assert (K, "sample") in graphed._graph.graphs
    if case == "sampler":  # the sampler's block, drawn on after it retired
        assert (K, "draw") in graphed._graph.graphs
    assert len(graphed.results[0]) < 10  # the first row retired inside a burst


@pytest.mark.parametrize("case", ["eos", "budget", "window", "sampler"])
def test_paged_burst_is_k_single_steps(pair, case, lifted):
    """Pages enough for every burst: a row retiring inside one writes on into
    its own pages, then the scratch page, until its pages are freed."""
    pm = pair[2]

    def make(graphed):
        return PagedDecodeEngine(pm, None, max_batch=3, n_pages=16, page_size=4,
                                 cuda_graph=graphed, generator=torch.Generator().manual_seed(8))

    eager, graphed = _waves(make, _jobs(pm, case))
    assert max(k for k, _ in graphed._graph.graphs) == K
    assert graphed.pages_in_use == eager.pages_in_use == 0
    assert torch.equal(graphed._table_dev, torch.zeros_like(graphed._table_dev))


def test_paged_burst_under_pool_pressure(pair, lifted):
    """Five pages cut the bursts to what they cover, or leave single steps
    that preempt: the graphed engine's tokens, preemptions and pages are the
    eager engine's ``step(n_tokens=4)``."""
    pm = lm_pair("mop_causal", scale=3.0)[2]
    prompts = prompts_of([3, 3, 3], seed=42)
    runs = []
    for graphed in (False, True):
        eng = PagedDecodeEngine(pm, None, max_batch=3, n_pages=5, page_size=4,
                                cuda_graph=graphed, generator=torch.Generator().manual_seed(1))
        rids = [eng.submit(p, 10, temperature=0.9 if i == 1 else 0.0, seed=i)
                for i, p in enumerate(prompts)]
        res = eng.run(n_tokens=4)
        runs.append(([res[r] for r in rids], eng.preemptions, eng.peak_pages_in_use,
                      eng.engine_steps, eng._gen.get_state()))
    assert runs[1][:4] == runs[0][:4] and torch.equal(runs[1][4], runs[0][4])
    assert runs[0][1] > 0


@pytest.mark.parametrize("cotenant", ["constraint", "beam"])
def test_constrained_or_beam_cotenant_makes_single_replays(pair, cotenant, lifted):
    pm = pair[2]
    p = prompts_of([5, 4, 3], seed=43)
    runs = []
    for graphed in (False, True):
        eng = DecodeEngine(pm, None, max_batch=4, max_beams=2, eos_id=0, cuda_graph=graphed,
                           generator=torch.Generator().manual_seed(4))
        rids = [eng.submit(p[0], 9, temperature=0.9), eng.submit(p[1], 8)]
        if cotenant == "constraint":  # outlives the others
            rids.append(eng.submit(p[2], 12, temperature=1.0,
                                   constraint=choices([list(range(3, 13)), [3, 7]])))
        else:
            rids.append(eng.submit(p[2], 12, num_beams=2))
        calls = []
        while eng.n_queued or eng.n_active:
            before = eng._graph.calls if graphed else 0
            eng.step(n_tokens=4)
            calls.append(eng._graph.calls - before if graphed else 0)
        runs.append(([eng.results[r] for r in rids], eng.engine_steps))
    assert runs[1] == runs[0]
    assert all(k == 1 for k, _ in eng._graph.graphs)  # no burst graph was made
    assert calls[0] == 4  # the first call: 4 one-step replays, host control between


def test_dense_greedy_bursts_equal_jax(pair, lifted):
    jm, jp, pm = pair
    prompts = prompts_of([5, 3, 7, 4], seed=44)
    budgets = [9, 6, 8, 5]
    # the bucket bounds JAX's compiles; the tokens are those without it
    jeng = JaxEngine(jm, jp, max_batch=2, prefill_buckets=[16])
    rids = [jeng.submit(q, n) for q, n in zip(prompts, budgets)]
    want = jeng.run(n_tokens=4)
    eng = DecodeEngine(pm, None, max_batch=2, prefill_buckets=[16], cuda_graph=True)
    got = [eng.submit(q, n) for q, n in zip(prompts, budgets)]
    res = eng.run(n_tokens=4)
    assert any(k == 4 for k, _ in eng._graph.graphs)
    assert eng.engine_steps == jeng.engine_steps
    for i, (q, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, q, n)
        assert_stream(res[got[i]], want[rids[i]], margins, f"request {i}")


def test_paged_greedy_bursts_equal_jax_under_preemption(pair, lifted):
    jm, jp, pm = pair
    prompts = prompts_of([6, 5, 3, 7], seed=3)
    budgets = [9, 10, 8, 6]
    jeng = JaxPaged(jm, jp, max_batch=2, n_pages=5, page_size=4, prefill_buckets=[16])
    rids = [jeng.submit(q, n) for q, n in zip(prompts, budgets)]
    want = jeng.run(n_tokens=3)
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=4,
                            prefill_buckets=[16], cuda_graph=True)
    got = [eng.submit(q, n) for q, n in zip(prompts, budgets)]
    res = eng.run(n_tokens=3)
    assert eng.preemptions == jeng.preemptions > 0
    assert any(k > 1 for k, _ in eng._graph.graphs)
    for i, (q, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, q, n)
        assert_stream(res[got[i]], want[rids[i]], margins, f"request {i}")


@pytest.fixture(scope="module")
def whisper():
    return _setup()


def test_whisper_burst_equals_single_steps_and_jax(whisper, lifted):
    """Four clips over two slots, ``step(n_tokens=4)``: one replay of 4 steps
    while every budget and window holds 4 more, fewer when one does not; the
    tokens of the eager engine's single steps, and JAX's up to each row's
    first near tie."""
    jm, jp, pm, mels = whisper
    budgets = [12, 7, 9, 5]

    def serve(eng, n_tokens):
        rids = [eng.submit(m, n) for m, n in zip(mels, budgets)]
        replays = []
        while eng.n_queued or eng.n_active:
            before = eng._step_graph.calls if getattr(eng, "_step_graph", None) else 0
            eng.step(n_tokens=n_tokens)
            if getattr(eng, "_step_graph", None):
                replays.append(eng._step_graph.calls - before)
        return [eng.results[r] for r in rids], replays

    single, _ = serve(WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS), 1)
    graphed = WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS, cuda_graph=True)
    got, replays = serve(graphed, 4)
    assert got == single and len({tuple(t) for t in got}) > 1
    assert 4 in graphed._step_graph.graphs and replays[0] == 1
    want, _ = serve(JaxWhisperEngine(jm, jp, max_batch=2, bos_token=BOS), 4)
    pp = to_torch(jax.device_get(jp))
    for i, mel in enumerate(mels):
        margins = _margins(pm, pp, mel, want[i])
        stop = next((j for j, m in enumerate(margins) if m < TIE), len(want[i]))
        assert stop > 0 and got[i][:stop] == want[i][:stop], (i, got[i], want[i])
