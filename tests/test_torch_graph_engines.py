"""The serving engines' ``cuda_graph=True`` forms on the CPU, where no CUDA
graph can be captured: the refusals of every engine, and the paged engine
(the speculative and Whisper engines in ``test_torch_graph_engines_spec.py``
and ``test_torch_graph_engines_whisper.py``).

- The refusals: the paged, speculative and Whisper engines on the CPU; a
  tensor-parallel model; a subclass that does not declare a captured step
  (``_captures_step``, read from the class's own body, is not inherited).
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes; no host read in
  it): the paged step over the device page table, which every grant and
  free writes in place (held equal to the host table after every step),
  against the eager engine token for token with equal preemptions and
  pages (greedy under preemption, sampled, LoRA, logprobs,
  ``step(n_tokens=k)``), and against JAX's paged engine under preemption up
  to each row's first near tie.
"""

from types import SimpleNamespace

import pytest
import torch

import mop_tpu_torch.models as PM
from mop_tpu.serving import PagedDecodeEngine as JaxPaged
from mop_tpu_torch.models.generate import decode_params
from mop_tpu_torch.serving import DecodeEngine, PagedDecodeEngine, SpecDecodeEngine
from mop_tpu_torch.serving import engine as E
from mop_tpu_torch.serving import whisper as W
from mop_tpu_torch.training import lora as PL

from _torch_decode_common import lift_graphs
from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of)

PROMPTS, BUDGETS = [6, 5, 3, 7, 4], [9, 10, 8, 6, 7]


@pytest.fixture
def lifted(monkeypatch):
    """The graphed engines on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, E)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


@pytest.fixture(scope="module")
def quartet():
    return lm_pair("quartet", scale=3.0)


def test_cuda_graph_refuses_the_cpu(quartet):
    pm = quartet[2]
    with pytest.raises(ValueError, match="PagedDecodeEngine: cuda_graph=True needs a CUDA"):
        PagedDecodeEngine(pm, None, max_batch=2, n_pages=8, page_size=4, cuda_graph=True)
    with pytest.raises(ValueError, match="SpecDecodeEngine: cuda_graph=True needs a CUDA"):
        SpecDecodeEngine(pm, None, pm, None, max_batch=2, cuda_graph=True)
    wm = PM.create_whisper_mop(PM.WhisperConfig(
        n_mels=8, n_audio_ctx=16, vocab_size=40, n_text_ctx=16, n_embd=32, n_head=2,
        n_layer_enc=1, n_layer_dec=1, dropout=0.0), device="cpu")
    with pytest.raises(ValueError, match="WhisperServingEngine: cuda_graph=True needs a CUDA"):
        W.WhisperServingEngine(wm, None, max_batch=2, cuda_graph=True)


def test_cuda_graph_refuses_tensor_parallel_and_undeclared_subclasses(quartet, monkeypatch):
    pm = quartet[2]

    class SubPaged(PagedDecodeEngine):
        pass

    class SubSpec(SpecDecodeEngine):
        pass

    with pytest.raises(ValueError, match="SubPaged: cuda_graph=True is the dense DecodeEngine's"):
        SubPaged(pm, None, max_batch=2, n_pages=8, page_size=4, cuda_graph=True)
    with pytest.raises(ValueError, match="SubSpec: cuda_graph=True is the dense DecodeEngine's"):
        SubSpec(pm, None, pm, None, max_batch=2, cuda_graph=True)
    SubPaged(pm, None, max_batch=2, n_pages=8, page_size=4)  # eager: no declaration needed
    # a tensor-parallel model raises before the device is looked at
    monkeypatch.setattr(pm, "decode_split", SimpleNamespace(n_head=2), raising=False)
    for name, make in (
            ("DecodeEngine", lambda: DecodeEngine(pm, None, max_batch=2, cuda_graph=True)),
            ("PagedDecodeEngine", lambda: PagedDecodeEngine(pm, None, max_batch=2, n_pages=8,
                                                            page_size=4, cuda_graph=True)),
            ("SpecDecodeEngine", lambda: SpecDecodeEngine(pm, None, pm, None, max_batch=2,
                                                          cuda_graph=True))):
        with pytest.raises(ValueError, match=f"{name}: cuda_graph=True does not take a "
                                             "tensor-parallel model"):
            make()


def _run_checked(eng, prompts, budgets, n_tokens=1, **kw):
    """Every request's tokens; after each step the device page table equals
    the host's."""
    rids = [eng.submit(p, n, **kw) for p, n in zip(prompts, budgets)]
    while eng.n_queued or eng.n_active:
        eng.step(n_tokens=n_tokens)
        assert torch.equal(eng._table_dev, torch.from_numpy(eng._table))
    return [eng.results[r] for r in rids]


def _paged(pm, graphed, n_pages=5, **kw):
    return PagedDecodeEngine(pm, None, max_batch=2, n_pages=n_pages, page_size=4,
                             cuda_graph=graphed, **kw)


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_graphed_paged_is_the_eager_engine_under_preemption(kind, lifted):
    pm = lm_pair(kind, scale=3.0)[2]
    prompts = prompts_of(PROMPTS, seed=3)
    runs = []
    for graphed in (False, True):
        eng = _paged(pm, graphed)
        runs.append((_run_checked(eng, prompts, BUDGETS), eng.preemptions,
                     eng.peak_pages_in_use, eng.pages_in_use))
        assert (eng._graph is not None) == graphed
    assert runs[1] == runs[0] and runs[0][1] > 0 and runs[0][3] == 0
    assert eng._graph.calls > 2


def test_graphed_paged_sampled_lora_logprobs_and_bursts(quartet, lifted):
    """Sampled rows among greedy ones, two LoRA adapters, top-2 logprobs,
    then ``step(n_tokens=3)``: the graphed engine's tokens, logprobs and
    pages are the eager engine's."""
    pm = quartet[2]
    params = decode_params(pm)
    adapters = {}
    for j, name in enumerate(("x", "y")):
        ad = PL.lora_init(torch.Generator().manual_seed(j), params, rank=2)
        g = torch.Generator().manual_seed(20 + j)
        adapters[name] = {p: {"a": f["a"] * 10.0, "b": torch.randn(f["b"].shape, generator=g)
                              * 0.3} for p, f in ad.items()}
    prompts = prompts_of(PROMPTS, seed=4)
    runs = []
    for graphed in (False, True):
        eng = PagedDecodeEngine(pm, params, max_batch=3, n_pages=8, page_size=4,
                                adapters=adapters, logprobs_topk=2, cuda_graph=graphed,
                                generator=torch.Generator().manual_seed(6))
        rids = [eng.submit(p, n, adapter=(None, "x", "y")[i % 3],
                           temperature=0.8 if i % 2 else None)
                for i, (p, n) in enumerate(zip(prompts, BUDGETS))]
        eng.run()
        burst = _run_checked(eng, prompts[:3], BUDGETS[:3], n_tokens=3)
        runs.append(([eng.results[r] for r in rids], [eng.logprobs[r] for r in rids], burst,
                     eng.preemptions, eng.peak_pages_in_use))
    assert runs[1] == runs[0]


def test_graphed_paged_equals_jax_under_preemption(quartet, lifted):
    jm, jp, pm = quartet
    prompts = prompts_of(PROMPTS[:4], seed=3)
    budgets = BUDGETS[:4]
    # the bucket bounds JAX's compiles; the tokens are those without it
    jeng = JaxPaged(jm, jp, max_batch=2, n_pages=5, page_size=4, prefill_buckets=[16])
    rids = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = jeng.run()
    want = [res[r] for r in rids]
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=4,
                            prefill_buckets=[16], cuda_graph=True)
    got = _run_checked(eng, prompts, budgets)
    assert eng.preemptions == jeng.preemptions > 0
    assert eng.peak_pages_in_use == jeng.peak_pages_in_use == 5
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")
