"""``PagedDecodeEngine.step(n_tokens=k)`` in the port (the counterparts of
``tests/test_serving_paged_multistep.py``): a burst of k steps gives the
tokens of k single steps for greedy, seeded-sampled and penalized rows
together, with every page the burst writes allocated before it (so the pool
bounds k and no preemption happens inside a burst); under pool pressure,
with an EOS inside a burst, with logprobs tracked, and with a constrained
co-tenant, which sits the burst out and takes one step after it while the
others keep theirs."""

import numpy as np
import pytest

from mop_tpu_torch.serving import PagedDecodeEngine, choices

from _torch_serving_common import _one_torch_thread, lm_pair  # noqa: F401

JOBS = [(dict(prompt=[5, 17, 3], max_new_tokens=12), {}),
        (dict(prompt=[9, 8, 7, 6], max_new_tokens=9), dict(temperature=0.9, seed=42)),
        (dict(prompt=[1, 4], max_new_tokens=11),
         dict(temperature=0.7, top_k=12, seed=7, repetition_penalty=1.3))]


@pytest.fixture(scope="module")
def models():
    return {kind: lm_pair(kind, scale=3.0)[2] for kind in ("quartet", "mop_causal")}


def _serve(pm, n_tokens, jobs=JOBS, n_pages=16, page_size=4, max_batch=4, **ekw):
    eng = PagedDecodeEngine(pm, None, max_batch=max_batch, n_pages=n_pages,
                            page_size=page_size, **ekw)
    rids = [eng.submit(**j, **kw) for j, kw in jobs]
    out = eng.run(n_tokens=n_tokens)
    return [out[r] for r in rids], eng


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
@pytest.mark.parametrize("k", [2, 4])
def test_paged_multistep_equals_single_step(models, kind, k):
    ref, one = _serve(models[kind], 1)
    got, eng = _serve(models[kind], k)
    assert got == ref
    assert eng.engine_steps < one.engine_steps
    assert eng.pages_in_use == 0 and eng.preemptions == 0


def test_paged_multistep_under_pool_pressure(models):
    """5 pages of 4 rows cannot hold three 13-token streams: bursts shrink to
    what the free pages cover, or single steps preempt; the tokens are the
    single steps' (which preempt too)."""
    jobs = [(dict(prompt=p, max_new_tokens=10), {}) for p in ([5, 17, 3], [9, 8, 7], [1, 4, 2])]
    ref, e1 = _serve(models["mop_causal"], 1, jobs=jobs, n_pages=5, max_batch=3)
    got, e4 = _serve(models["mop_causal"], 4, jobs=jobs, n_pages=5, max_batch=3)
    assert got == ref
    assert e1.preemptions > 0 and e1.peak_pages_in_use == 5
    assert e4.peak_pages_in_use <= 5 and e4.pages_in_use == 0


def test_paged_multistep_eos_mid_burst(models):
    pm = models["quartet"]
    ref, _ = _serve(pm, 1)
    eos = int(ref[0][5])
    jobs = [(dict(prompt=[5, 17, 3], max_new_tokens=12, eos_id=eos), {}),
            (dict(prompt=[9, 8, 7, 6], max_new_tokens=9), {})]
    r1, _ = _serve(pm, 1, jobs=jobs)
    r4, _ = _serve(pm, 4, jobs=jobs)
    assert r4 == r1
    assert len(r4[0]) < 12 and r4[0][-1] == eos


def test_paged_multistep_logprobs_stay_aligned(models):
    ref, e1 = _serve(models["quartet"], 1, logprobs_topk=2)
    got, e4 = _serve(models["quartet"], 4, logprobs_topk=2)
    assert got == ref
    for rid in e1.results:
        assert len(e4.logprobs[rid]) == len(e4.results[rid])
        np.testing.assert_allclose(e4.logprobs[rid], e1.logprobs[rid], atol=1e-5)
        assert e4.top_logprobs[rid] == e1.top_logprobs[rid]


def test_paged_constrained_cotenant_keeps_burst(models):
    """A constrained co-tenant takes one token a call while the other row
    bursts: the constrained output satisfies its DFA, the other equals its
    solo burst run, and the call count stays near budget / k."""
    pm = models["quartet"]
    eos, n = 39, 12
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=8, page_size=4, eos_id=eos)
    r_g = eng.submit([9, 8, 7], max_new_tokens=n)
    r_c = eng.submit([5, 1], max_new_tokens=6, constraint=choices([[4, 2], [4, 9, 9]]))
    out = eng.run(n_tokens=4)
    assert out[r_c] in ([4, 2, eos], [4, 9, 9, eos])
    solo = PagedDecodeEngine(pm, None, max_batch=2, n_pages=8, page_size=4, eos_id=eos)
    sr = solo.submit([9, 8, 7], max_new_tokens=n)
    assert solo.run(n_tokens=4)[sr] == out[r_g]
    assert eng.engine_steps <= n // 4 + 3


def test_burst_preallocates_its_pages(models):
    """Before a burst of k, every page its rows write is allocated: a row at
    length 3 with 4 rows a page takes its second page in the same call."""
    eng = PagedDecodeEngine(models["quartet"], None, max_batch=2, n_pages=8, page_size=4)
    eng.submit([5, 17, 3], max_new_tokens=12)
    eng.step(n_tokens=4)  # admission (page 1), then positions 3..6
    assert eng.pages_in_use == 2 and int(eng._lens[0]) == 7
    assert eng._burst_page_need([0], 4) == 1 and eng._burst_last_pos(0, 4) == 10
