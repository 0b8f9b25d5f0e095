"""The port's ``PagedDecodeEngine`` against the port's dense ``DecodeEngine``
(the counterparts of ``tests/test_serving_paged.py`` and of the paged cases of
the sampling, seed, LoRA, logprobs, kv-dtype and GPT-MoP serving tests):
with pages to spare, the tokens equal the dense engine's exactly (the page
table and its gather change the layout, not the math); under pool pressure
the youngest request is preempted and re-admitted with its prefix, penalty
counts, constraint state, seeded stream and adapter, and the tokens equal
the dense engine's up to the first near tie of the single-stream
reference (a re-prefilled prefix standardizes each score row over the whole
prefix where the decode steps standardized over the live one); pages grow,
are reclaimed and counted; the validation, int8 and beams raise."""

import numpy as np
import pytest
import torch

from mop_tpu_torch.models.generate import decode_params
from mop_tpu_torch.serving import DecodeEngine, PagedDecodeEngine, token_set
from mop_tpu_torch.training import lora as PL

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of)

PROMPTS, BUDGETS = [6, 5, 3, 7], [9, 10, 8, 6]


def _run(eng, prompts, budgets, n_tokens=1, **kw):
    rids = [eng.submit(p, n, **kw) for p, n in zip(prompts, budgets)]
    res = eng.run(n_tokens=n_tokens)
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def quartet():
    return lm_pair("quartet", scale=3.0)[2]


@pytest.fixture(scope="module")
def causal():
    """GPT-MoP with the causal gate and causal standardization: a prefill
    builds each row as the decode steps do, so a re-prefilled prefix is the
    state the steps built (up to rounding) and a preempted stream can be held
    to the unpreempted one."""
    return lm_pair("mop_causal", scale=3.0)[2]


@pytest.mark.parametrize("kind", ["quartet", "baseline"])
def test_paged_equals_dense_engine(kind):
    pm = lm_pair(kind, scale=3.0)[2]
    prompts = prompts_of(PROMPTS, seed=3)
    want = _run(DecodeEngine(pm, None, max_batch=3), prompts, BUDGETS)
    eng = PagedDecodeEngine(pm, None, max_batch=3, n_pages=16, page_size=4)
    assert _run(eng, prompts, BUDGETS) == want
    assert eng.preemptions == 0 and eng.pages_in_use == 0
    assert eng._cache is None  # no dense slabs


def test_paged_equals_dense_engine_sampled(quartet):
    prompts = prompts_of([3, 5, 2], seed=4)
    opts = [dict(temperature=0.9, top_k=12), dict(temperature=0.7, top_p=0.9), {}]

    def run(eng):
        rids = [eng.submit(p, 8, **o) for p, o in zip(prompts, opts)]
        res = eng.run()
        return [res[r] for r in rids]

    want = run(DecodeEngine(quartet, None, max_batch=3,
                            generator=torch.Generator().manual_seed(7)))
    got = run(PagedDecodeEngine(quartet, None, max_batch=3, n_pages=16, page_size=4,
                                generator=torch.Generator().manual_seed(7)))
    assert got == want


def test_page_growth_and_reclaim(quartet):
    eng = PagedDecodeEngine(quartet, None, max_batch=2, n_pages=8, page_size=4)
    eng.submit([5, 17, 3], max_new_tokens=12)
    eng.step()  # admission (positions 0..3: one page) and the first decode
    assert eng.pages_in_use == 1
    eng.step()
    assert eng.pages_in_use == 2  # position 4 opened the second page
    eng.run()
    # 3 + 12 tokens: the last decode writes position 13, in the fourth page
    assert eng.peak_pages_in_use == 4 and eng.pages_in_use == 0
    assert not eng._table.any() and not eng._n_alloc.any()


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_preemption_keeps_greedy_tokens(kind):
    """Four requests over two slots and 5 pages of 4 rows (each request ends
    at 4 pages): the pool runs dry mid-decode, the youngest is preempted and
    re-prefilled, and every stream ends as the dense engine's."""
    pm = lm_pair(kind, scale=3.0)[2]
    prompts = prompts_of(PROMPTS, seed=3)
    want = _run(DecodeEngine(pm, None, max_batch=2), prompts, BUDGETS)
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=4)
    got = _run(eng, prompts, BUDGETS)
    assert eng.preemptions > 0 and eng.peak_pages_in_use == 5 and eng.pages_in_use == 0
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")


def test_preemption_skips_full_window_victims():
    """A victim whose prefix fills the window cannot be re-prefilled: the
    growing request preempts itself instead, and both streams finish as the
    dense engine's."""
    pm = lm_pair("quartet", scale=3.0, block_size=8)[2]
    jobs = [([5, 17, 3, 21, 2], 3), ([1, 2], 6)]  # the first fills the window to 8
    prompts, budgets = zip(*jobs)
    want = _run(DecodeEngine(pm, None, max_batch=2), prompts, budgets)
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=2)
    got = _run(eng, prompts, budgets)
    for i, (p, n) in enumerate(jobs):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")
    assert eng.pages_in_use == 0


def test_oversubscribed_memory_footprint(quartet):
    """Eight slots at a quarter of the dense slabs' rows: 16 pages of 2 rows
    (and the scratch page) against 8 x 16, every request resident at once."""
    prompts = [list(range(2 + i, 4 + i)) for i in range(8)]
    want = _run(DecodeEngine(quartet, None, max_batch=8), prompts, [2] * 8)
    eng = PagedDecodeEngine(quartet, None, max_batch=8, n_pages=16, page_size=2)
    assert eng.cache_bytes() < eng.dense_equivalent_bytes() // 3
    assert eng.cache_bytes() == 3 * 2 * 17 * 2 * 2 * 16 * 4  # L, pages + 1, H, ps, dk, fp32
    assert eng.dense_equivalent_bytes() == 3 * 2 * 8 * 16 * 32 * 4
    assert _run(eng, prompts, [2] * 8) == want
    assert eng.peak_pages_in_use == 16 and eng.preemptions == 0


def test_paged_with_prefill_buckets(quartet):
    prompts = prompts_of([3, 7, 5], seed=5)
    want = _run(DecodeEngine(quartet, None, max_batch=3, prefill_buckets=[4, 8]), prompts,
                [6, 6, 6])
    eng = PagedDecodeEngine(quartet, None, max_batch=3, n_pages=16, page_size=4,
                            prefill_buckets=[4, 8])
    assert _run(eng, prompts, [6, 6, 6]) == want


def test_paged_cancel_frees_pages(quartet):
    eng = PagedDecodeEngine(quartet, None, max_batch=2, n_pages=8, page_size=4)
    r0 = eng.submit([5, 17, 3], max_new_tokens=12)
    r1 = eng.submit([4, 4], max_new_tokens=12)
    eng.step()
    assert eng.pages_in_use == 2
    assert eng.cancel(r0) and eng.pages_in_use == 1
    assert eng.cancel(r1) and eng.pages_in_use == 0
    assert not eng.cancel(r1)
    eng.step()
    assert eng.pages_in_use == 0 and not eng.n_active


def test_paged_validation(quartet):
    with pytest.raises(ValueError, match="divide"):
        PagedDecodeEngine(quartet, None, page_size=5)
    with pytest.raises(ValueError, match="never fit"):
        PagedDecodeEngine(quartet, None, n_pages=3, page_size=4)
    with pytest.raises(ValueError, match="fp32/bfloat16"):
        PagedDecodeEngine(quartet, None, n_pages=8, page_size=4, kv_dtype=torch.int8)
    eng = PagedDecodeEngine(quartet, None, max_batch=2, n_pages=8, page_size=4)
    with pytest.raises(ValueError, match="max_beams"):  # beams are the dense engine's
        eng.submit([1, 2, 3], 4, num_beams=2)


def test_bf16_pools_equal_dense_bf16(quartet):
    prompts = prompts_of(PROMPTS, seed=6)
    want = _run(DecodeEngine(quartet, None, max_batch=3, kv_dtype=torch.bfloat16), prompts,
                BUDGETS)
    eng = PagedDecodeEngine(quartet, None, max_batch=3, n_pages=16, page_size=4,
                            kv_dtype=torch.bfloat16)
    assert eng._pool["k"].dtype == torch.bfloat16
    assert eng.cache_bytes() == 3 * 2 * 17 * 2 * 4 * 16 * 2
    assert _run(eng, prompts, BUDGETS) == want


@pytest.mark.parametrize("kind", ["mop", "mop_causal"])
def test_gpt_mop_view_history_pages(kind):
    """GPT-MoP's view history pages with the K/V tables: the paged engine
    equals the dense one (under pool pressure: ``mop_causal`` in
    ``test_preemption_keeps_greedy_tokens``; the centred gate's prefill reads
    views past each position, which its decode steps do not, so a re-prefilled
    prefix is another state)."""
    pm = lm_pair(kind, scale=3.0)[2]
    prompts = prompts_of(PROMPTS, seed=7)
    want = _run(DecodeEngine(pm, None, max_batch=2), prompts, BUDGETS)
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=16, page_size=4)
    assert eng._pool["mv"].shape == (2, 17, 4, pm.n_views)
    assert _run(eng, prompts, BUDGETS) == want


def test_penalized_greedy_under_preemption(causal):
    """Re-admission rebuilds the penalty counts from the emitted tokens: each
    penalized stream equals its dense run through a preemption."""
    pen = dict(repetition_penalty=1.4, presence_penalty=0.6, frequency_penalty=0.3)
    prompts = prompts_of([7, 6], seed=8)
    want = _run(DecodeEngine(causal, None, max_batch=2), prompts, [8, 8], **pen)
    eng = PagedDecodeEngine(causal, None, max_batch=2, n_pages=4, page_size=4)
    got = _run(eng, prompts, [8, 8], **pen)
    assert eng.preemptions > 0
    assert got == want


def test_seeded_replay_across_preemption(causal):
    """A seeded sampled request preempted mid-decode continues its stream at
    its position: the tokens of an unpreempted run."""
    pm = causal
    prompts = prompts_of([7, 6], seed=9)
    samp = dict(temperature=0.9, top_k=10)

    def run(eng):
        rids = [eng.submit(p, 8, seed=50 + i, **samp) for i, p in enumerate(prompts)]
        res = eng.run()
        return [res[r] for r in rids]

    big = PagedDecodeEngine(pm, None, max_batch=2, n_pages=16, page_size=4)
    want = run(big)
    small = PagedDecodeEngine(pm, None, max_batch=2, n_pages=4, page_size=4,
                              generator=torch.Generator().manual_seed(42))
    assert run(small) == want
    assert big.preemptions == 0 and small.preemptions > 0


def _adapters(pm, seeds, rank=2):
    """Adapters over the attention projections with a nonzero ``b``."""
    out = {}
    for s in seeds:
        g = torch.Generator().manual_seed(s)
        ad = PL.lora_init(g, decode_params(pm), rank=rank)
        out[f"a{s}"] = {p: {"a": f["a"] * 10.0, "b": torch.randn(f["b"].shape, generator=g) * 0.3}
                        for p, f in ad.items()}
    return out


def test_mixed_adapters_with_preemption(causal):
    """Re-admission keeps the victim's adapter: each stream equals the dense
    engine's with the same bank."""
    ads = _adapters(causal, (0, 7))
    prompts = prompts_of([5, 6, 4], seed=10)
    names = ["a0", "a7", None]

    def run(eng):
        rids = [eng.submit(p, 8, adapter=nm) for p, nm in zip(prompts, names)]
        res = eng.run()
        return [res[r] for r in rids]

    want = run(DecodeEngine(causal, None, max_batch=3, adapters=ads))
    eng = PagedDecodeEngine(causal, None, max_batch=3, n_pages=5, page_size=4, adapters=ads)
    got = run(eng)
    assert eng.preemptions > 0
    assert got == want


def test_logprobs_through_preemption(causal):
    prompts = prompts_of([3, 2, 3], seed=11)
    dense = DecodeEngine(causal, None, max_batch=3, logprobs_topk=2)
    want = _run(dense, prompts, [10, 10, 10])
    paged = PagedDecodeEngine(causal, None, max_batch=3, n_pages=5, page_size=4,
                              logprobs_topk=2)
    got = _run(paged, prompts, [10, 10, 10])
    assert paged.preemptions > 0 and got == want
    for rid in range(3):
        assert len(paged.logprobs[rid]) == len(got[rid])
        # a re-prefilled prefix sums in another order than the steps: close, not equal
        np.testing.assert_allclose(paged.logprobs[rid], dense.logprobs[rid], atol=2e-3)
        for pa, da in zip(paged.top_logprobs[rid], dense.top_logprobs[rid]):
            assert [t for t, _ in pa] == [t for t, _ in da]


def test_bias_stop_and_constraint_replay(quartet, causal):
    """Logit bias and stops work as in the dense engine; a constrained
    request preempted mid-output replays its DFA state on re-admission, so
    its output still satisfies the constraint and equals the dense run."""
    base = _run(DecodeEngine(quartet, None, max_batch=2), [[5, 17, 3]], [10])[0]
    eng = PagedDecodeEngine(quartet, None, max_batch=2, n_pages=4, page_size=4)
    stop = base[5:7]
    end = next(i for i in range(1, len(base)) if base[i - 1:i + 1] == stop)
    assert _run(eng, [[5, 17, 3]], [10], stop=[stop])[0] == base[:end + 1]
    banned = _run(eng, [[5, 17, 3]], [6], logit_bias={base[0]: -1e9})[0]
    assert base[0] not in banned
    eos = 39
    con = token_set([10, 11, 12, 13], min_len=9, max_len=10)
    jobs = [([1, 2, 3, 4, 5, 6], 10), ([7, 8, 9, 1, 2], 11)]

    def run(e):
        r0 = e.submit(*jobs[0], eos_id=eos)
        r1 = e.submit(*jobs[1], eos_id=eos, constraint=con)
        res = e.run()
        return res[r0], res[r1]

    want = run(DecodeEngine(causal, None, max_batch=2))
    tight = PagedDecodeEngine(causal, None, max_batch=2, n_pages=5, page_size=4)
    got = run(tight)
    assert tight.preemptions > 0
    assert got == want
    assert set(got[1][:-1]) <= {10, 11, 12, 13} and 9 <= len(got[1]) - 1 <= 10
    assert got[1][-1] == eos
