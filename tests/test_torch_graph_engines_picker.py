"""The dense and paged engines' picker inside the captured step, on the CPU,
where no CUDA graph can be captured. With ``require_graph`` lifted
(``StepGraph`` then runs its body eagerly over the same buffers, the form a
replay computes; no host read in it):

- the graphed dense engine against the eager one, call by call and bit for
  bit (tokens, logprobs and their top alternatives), with the engine
  generator's state equal after every call, over greedy, unseeded and
  seeded sampled, penalised, biased, min-p, LoRA and ``logprobs_topk`` rows;
  each single step one graph call, in the picker's form for its rows;
- a seeded request under the device draw (``seeded_gumbel``): its tokens
  depend only on (seed, prompt, params), alone, co-batched with sampled
  traffic, under another engine generator, under ``step(n_tokens=3)``,
  eager and graphed, and across a paged preemption;
- the device draw's frequencies within 0.05 of ``sampling_dist``'s
  probabilities over 4,000 (seed, ntok) pairs, every draw in the kept set.
"""

import numpy as np
import pytest
import torch

from mop_tpu_torch.models.generate import decode_params
from mop_tpu_torch.serving import DecodeEngine, PagedDecodeEngine
from mop_tpu_torch.serving import engine as E
from mop_tpu_torch.serving.engine import seeded_gumbel
from mop_tpu_torch.training import lora as PL

from _torch_decode_common import lift_graphs
from _torch_serving_common import _one_torch_thread, lm_pair, prompts_of  # noqa: F401
from test_torch_serving_sampling import ROWS, V, _inputs, _port_dist


@pytest.fixture
def lifted(monkeypatch):
    """The graphed engines on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, E)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


@pytest.fixture(scope="module")
def quartet():
    return lm_pair("quartet")[2]


def _adapters(pm):
    params = decode_params(pm)
    out = {}
    for j, name in enumerate(("x", "y")):
        ad = PL.lora_init(torch.Generator().manual_seed(j), params, rank=2)
        g = torch.Generator().manual_seed(20 + j)
        out[name] = {p: {"a": f["a"] * 10.0, "b": torch.randn(f["b"].shape, generator=g) * 0.3}
                     for p, f in ad.items()}
    return out


# each mix: the engine's options and the requests' (budget, options), one prompt each
MIXES = {
    "greedy": ({}, [(9, {}), (7, {}), (8, {}), (6, {}), (9, {})]),
    "unseeded": ({}, [(9, dict(temperature=0.8, top_k=12)), (7, {}),
                      (8, dict(temperature=1.2, top_p=0.9)), (6, dict(temperature=0.7)),
                      (9, {})]),
    "seeded": ({}, [(9, dict(temperature=1.0, top_k=20, seed=5)), (7, {}),
                    (8, dict(temperature=0.9, seed=6, top_p=0.8)), (6, {}),
                    (9, dict(temperature=1.1, seed=7))]),
    "penalised_biased": (dict(eos_id=0), [
        (9, dict(repetition_penalty=1.6, presence_penalty=0.7, frequency_penalty=0.3)),
        (7, dict(temperature=0.9, min_p=0.05, logit_bias={3: 2.0, 5: -100.0})),
        (8, dict(temperature=1.0, seed=11, repetition_penalty=1.3, min_p=0.1)),
        (6, dict(logit_bias={7: 3.0})), (9, dict(temperature=0.8, frequency_penalty=0.5))]),
    "lora": ("adapters", [(9, dict(adapter="x", temperature=0.9)), (7, dict(adapter="y")),
                          (8, {}), (6, dict(adapter="x", seed=3, temperature=1.0)),
                          (9, dict(adapter="y", temperature=0.7))]),
    "logprobs": (dict(logprobs_topk=3), [(9, dict(temperature=0.9)), (7, {}),
                                         (8, dict(temperature=1.0, seed=8)), (6, {}),
                                         (9, dict(temperature=1.3, top_k=5))]),
}


def _lockstep(make, jobs, prompts, n_tokens=1):
    """The eager and the graphed engine stepped side by side over the same
    requests: each call's tokens equal, the generators' states equal after
    it. Returns both engines and the request ids."""
    engs = [make(False), make(True)]
    rids = [[e.submit(p, n, **kw) for p, (n, kw) in zip(prompts, jobs)] for e in engs]
    while any(e.n_queued or e.n_active for e in engs):
        outs = [e.step(n_tokens=n_tokens) for e in engs]
        assert outs[1] == outs[0]
        assert torch.equal(engs[1]._gen.get_state(), engs[0]._gen.get_state())
    return engs, rids


@pytest.mark.parametrize("mix", list(MIXES))
def test_graphed_dense_is_the_eager_engine_bit_for_bit(quartet, mix, lifted):
    opts, jobs = MIXES[mix]
    if opts == "adapters":
        opts = dict(adapters=_adapters(quartet))
    prompts = prompts_of([5, 3, 6, 4, 2], seed=30)

    def make(graphed):
        return DecodeEngine(quartet, None, max_batch=3, cuda_graph=graphed,
                            generator=torch.Generator().manual_seed(13), **opts)

    (eager, graphed), (re, rg) = _lockstep(make, jobs, prompts)
    assert [graphed.results[r] for r in rg] == [eager.results[r] for r in re]
    if graphed.logprobs_topk:
        assert [graphed.logprobs[r] for r in rg] == [eager.logprobs[r] for r in re]
        assert [graphed.top_logprobs[r] for r in rg] == [eager.top_logprobs[r] for r in re]
    # one graph call a decode step, each keyed (1, the picker's form of its rows):
    # the engine generator's block drawn only where an unseeded row samples
    assert graphed._graph.calls == graphed.engine_steps
    assert all(k == 1 for k, _ in graphed._graph.graphs)
    forms = {f for _, f in graphed._graph.graphs}
    sampled = [kw for _, kw in jobs if kw.get("temperature", 0) > 0]
    assert ("draw" in forms) == any("seed" not in kw for kw in sampled)
    if not sampled:
        assert forms == {"greedy"}
    elif all("seed" in kw for kw in sampled):
        assert "sample" in forms
    if mix != "greedy":
        assert len({t for r in re for t in eager.results[r]}) > 3


def test_graphed_paged_is_the_eager_engine_bit_for_bit(quartet, lifted):
    """The paged engine's step is the dense engine's ``_advance`` over its
    page table: sampled, seeded and penalised rows, call by call."""
    _, jobs = MIXES["penalised_biased"]
    prompts = prompts_of([5, 3, 6, 4, 2], seed=31)

    def make(graphed):
        return PagedDecodeEngine(quartet, None, max_batch=3, n_pages=16, page_size=4, eos_id=0,
                                 cuda_graph=graphed, generator=torch.Generator().manual_seed(2))

    (eager, graphed), (re, rg) = _lockstep(make, jobs, prompts)
    assert [graphed.results[r] for r in rg] == [eager.results[r] for r in re]
    assert graphed.peak_pages_in_use == eager.peak_pages_in_use


SEEDED = dict(temperature=1.0, top_k=20, seed=1234)


def _co_batched(pm, graphed, gen_seed, n_tokens):
    """The seeded request among unseeded and seeded sampled traffic."""
    eng = DecodeEngine(pm, None, max_batch=4, eos_id=0, cuda_graph=graphed,
                       generator=torch.Generator().manual_seed(gen_seed))
    p = prompts_of([5, 3, 6, 4], seed=92)
    eng.submit(p[1], 9, temperature=1.2, top_p=0.95)
    eng.submit(p[2], 7, temperature=0.9)
    rid = eng.submit(p[0], 10, **SEEDED)
    eng.submit(p[3], 8, temperature=0.8, seed=77, repetition_penalty=1.3)
    return eng.run(n_tokens=n_tokens)[rid]


def test_seeded_request_depends_only_on_seed_prompt_and_params(quartet, lifted):
    p0 = prompts_of([5, 3, 6, 4], seed=92)[0]
    alone = []
    for graphed in (False, True):
        eng = DecodeEngine(quartet, None, max_batch=1, eos_id=0, cuda_graph=graphed)
        rid = eng.submit(p0, 10, **SEEDED)
        alone.append(eng.run()[rid])
    assert alone[1] == alone[0] and len(set(alone[0])) > 2
    for graphed in (False, True):
        for gen_seed, n_tokens in ((0, 1), (99, 1), (5, 3)):
            assert _co_batched(quartet, graphed, gen_seed, n_tokens) == alone[0], (
                graphed, gen_seed, n_tokens)
    other = DecodeEngine(quartet, None, max_batch=1, eos_id=0)
    rid = other.submit(p0, 10, **{**SEEDED, "seed": 1235})
    assert other.run()[rid] != alone[0]


class _Recorded(PagedDecodeEngine):
    """The paged engine, recording the ids of the requests it preempts."""

    _captures_step = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.preempted = []

    def _preempt_slot(self, victim):
        self.preempted.append(self._slot_rid[victim])
        super()._preempt_slot(victim)


def test_seeded_stream_across_a_paged_preemption(lifted):
    """GPT-MoP with the causal gate re-prefills into the state its steps
    built: a seeded request preempted mid-decode continues its stream at its
    position, eagerly and graphed, with the tokens of the dense engine's run
    of it alone."""
    pm = lm_pair("mop_causal", scale=3.0)[2]
    prompts = prompts_of([7, 6], seed=9)
    samp = dict(temperature=0.9, top_k=10)
    alone = []
    for i, p in enumerate(prompts):
        eng = DecodeEngine(pm, None, max_batch=1)
        rid = eng.submit(p, 8, seed=50 + i, **samp)
        alone.append(eng.run()[rid])
    for graphed in (False, True):
        eng = _Recorded(pm, None, max_batch=2, n_pages=4, page_size=4, cuda_graph=graphed,
                        generator=torch.Generator().manual_seed(42))
        rids = [eng.submit(p, 8, seed=50 + i, **samp) for i, p in enumerate(prompts)]
        res = eng.run()
        assert [res[r] for r in rids] == alone
        assert rids[1] in eng.preempted


def test_device_draw_frequencies_match_sampling_dist():
    """Each sampled row drawn with ``seeded_gumbel`` over 4,000 (seed, ntok)
    pairs: every draw in ``sampling_dist``'s kept set, the frequencies within
    0.05 of its probabilities; the noise a pure function of its inputs."""
    logits, ocounts, pseen, lbias, cols = _inputs(seed=1)
    _, order, masked = _port_dist(logits, ocounts, pseen, lbias, cols)
    probs = torch.softmax(masked, -1)
    p_vocab = torch.zeros_like(probs).scatter_(1, order, probs).numpy()
    rng = np.random.default_rng(5)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31, 4000))
    ntoks = torch.from_numpy(rng.integers(0, 4096, 4000))
    noise = seeded_gumbel(seeds, ntoks, V)
    assert torch.equal(noise, seeded_gumbel(seeds.clone(), ntoks.clone(), V))
    assert torch.isfinite(noise).all()
    assert not torch.equal(noise[:, 0], seeded_gumbel(seeds, ntoks + 1, V)[:, 0])
    for r, name in enumerate(ROWS):
        if cols[0, r] == 0.0:
            continue
        draws = order[r][(masked[r][None] + noise).argmax(-1)].numpy()
        kept = set(np.nonzero(p_vocab[r] > 0)[0].tolist())
        assert set(draws.tolist()) <= kept, name
        freq = np.bincount(draws, minlength=V) / len(draws)
        np.testing.assert_allclose(freq, p_vocab[r], atol=0.05, err_msg=name)
