"""The port's ``SpecDecodeEngine`` against the port's plain ``DecodeEngine``
(the counterparts of ``tests/test_serving_speculative.py`` and of the
speculative cases of the prefix-cache, bucket, sampling and logprobs tests):
greedy streams of a mixed batch equal the plain engine's for gamma 1 and 3
with a distinct draft, up to the first near tie (the verify is one
``decode_chunk_rows``, which sums in another order than single steps); a
perfect draft takes at most ``1 + ceil((n - 1) / (gamma + 1))`` steps; an
EOS inside a chunk ends the stream where the plain engine's ends; the
window's edge truncates; the prefix cache, buckets and logprobs; the
constructor's and ``submit``'s checks."""

import numpy as np
import pytest
import torch

from mop_tpu_torch.serving import DecodeEngine, SpecDecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   chunked_ref, lm_pair, prefill_rows)

JOBS = [([5, 17, 3, 21], 8), ([1, 2], 7), ([30, 31, 32, 33, 34, 35], 5), ([9], 8),
        ([25, 24, 23], 5)]


@pytest.fixture(scope="module")
def pair():
    """(target, draft): the 2-layer Quartet LM and a 1-layer, 16-wide one."""
    return lm_pair("quartet", scale=3.0)[2], lm_pair("quartet", seed=7, scale=3.0, n_layer=1,
                                                      n_embd=16)[2]


def _run(eng, jobs=JOBS, **kw):
    rids = [eng.submit(p, n, **kw) for p, n in jobs]
    res = eng.run()
    return [res[r] for r in rids]


def _agree(pm, got, want, jobs=JOBS):
    for i, (p, n) in enumerate(jobs):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")


@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_equals_plain_engine(pair, gamma):
    target, draft = pair
    want = _run(DecodeEngine(target, None, max_batch=3))
    eng = SpecDecodeEngine(target, None, draft, None, max_batch=3, gamma=gamma)
    got = _run(eng)
    _agree(target, got, want)
    assert eng.tokens_generated == sum(len(g) for g in got) and not eng._lens.any()


def test_perfect_draft_takes_fewer_steps(pair):
    target = pair[0]
    gamma, n = 3, 12
    eng = SpecDecodeEngine(target, None, target, None, max_batch=2, gamma=gamma)
    rid = eng.submit([4, 8, 15], n)
    steps = 0
    while not eng.is_done(rid):
        eng.step()
        steps += 1
    want = _run(DecodeEngine(target, None, max_batch=2), [([4, 8, 15], n)])[0]
    _agree(target, [eng.results[rid]], [want], [([4, 8, 15], n)])
    assert steps <= 1 + -(-(n - 1) // (gamma + 1))


def test_eos_mid_chunk(pair):
    target, draft = pair
    prompt = [3, 1, 4, 1, 5]
    toks = _run(DecodeEngine(target, None, max_batch=2), [(prompt, 10)])[0]
    eos = toks[len(toks) // 2]
    want = _run(DecodeEngine(target, None, max_batch=2, eos_id=eos), [(prompt, 10)])
    got = _run(SpecDecodeEngine(target, None, draft, None, max_batch=2, gamma=4, eos_id=eos),
               [(prompt, 10)])
    _agree(target, got, want, [(prompt, 10)])
    assert got[0][-1] == eos and len(got[0]) <= len(toks) // 2 + 1


def test_window_edge_truncates(pair):
    """A slot retires once the next round would pass the window (``len +
    gamma + 1 > block_size``): with a perfect draft a 10-token prompt gets
    tok0 and one round of 4, where the plain engine fills the window."""
    target = pair[0]
    job = [(list(range(1, 11)), 6)]
    plain = _run(DecodeEngine(target, None, max_batch=1), job)[0]
    eng = SpecDecodeEngine(target, None, target, None, max_batch=1, gamma=3)
    got = _run(eng, job)[0]
    assert len(plain) == 6 and len(got) == 5 and got == plain[:5]
    assert eng.is_done(0) and not eng.n_active


def test_validation(pair):
    target, draft = pair
    with pytest.raises(ValueError, match="gamma"):
        SpecDecodeEngine(target, None, draft, None, gamma=0)
    small = lm_pair("quartet", seed=2, n_layer=1, block_size=8)[2]
    with pytest.raises(ValueError, match="block_size"):
        SpecDecodeEngine(target, None, small, None)
    with pytest.raises(ValueError, match="fp32/bfloat16"):
        SpecDecodeEngine(target, None, draft, None, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="cache_sharding"):
        SpecDecodeEngine(target, None, draft, None, cache_sharding=object())


def test_rejects_sampling_overrides(pair):
    target, draft = pair
    eng = SpecDecodeEngine(target, None, draft, None, max_batch=2, gamma=2)
    for kw in (dict(temperature=1.0), dict(top_k=5), dict(top_p=0.5), dict(min_p=0.1),
               dict(repetition_penalty=1.2), dict(logit_bias={3: 1.0}), dict(adapter="x")):
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit([1, 2, 3], 4, **kw)
    with pytest.raises(TypeError):  # no beams
        eng.submit([1, 2, 3], 4, num_beams=2)
    base = _run(DecodeEngine(target, None, max_batch=2), [([5, 17, 3], 10)])[0]
    stop = base[5:7]
    end = next(i for i in range(1, len(base)) if base[i - 1:i + 1] == stop)
    rid = eng.submit([5, 17, 3], 10, stop=[stop], seed=123)  # the seed is ignored
    assert eng.run()[rid] == base[:end + 1]


def test_prefix_cache_and_buckets(pair):
    """The target reuses a cached prefix (the draft prefills the whole
    prompt): the plain engine with the same cache gives the same tokens;
    buckets give the tokens without them."""
    target, draft = pair
    system = [7, 3, 9, 11, 2, 5]
    jobs = [(system + [20 + i], 6) for i in range(4)]
    want = _run(DecodeEngine(target, None, max_batch=2, prefix_cache_entries=4), jobs)
    eng = SpecDecodeEngine(target, None, draft, None, max_batch=2, gamma=3,
                           prefix_cache_entries=4)
    got = _run(eng, jobs)
    base = prefill_rows(target, None, jobs[0][0], len(system))
    for i, (p, n) in enumerate(jobs):  # a hit's tail is fed after the system prompt's rows
        margins = (chunked_ref(target, None, p, n, 0, base=base) if i
                   else cached_ref(target, None, p, n))[1]
        assert_stream(got[i], want[i], margins, f"request {i}")
    assert eng.prefix_cache_hits == 3 and eng.prefix_tokens_reused == 3 * len(system)
    ref = _run(SpecDecodeEngine(target, None, draft, None, max_batch=3, gamma=3))
    out = _run(SpecDecodeEngine(target, None, draft, None, max_batch=3, gamma=3,
                                prefill_buckets=[8, 16]))
    _agree(target, out, ref)


def test_logprobs_equal_plain_engine(pair):
    target, draft = pair
    plain = DecodeEngine(target, None, max_batch=2, logprobs_topk=2)
    want = _run(plain, JOBS[:2])
    spec = SpecDecodeEngine(target, None, draft, None, max_batch=2, gamma=3, logprobs_topk=2)
    got = _run(spec, JOBS[:2])
    assert got == want
    for rid in range(2):
        assert len(spec.logprobs[rid]) == len(got[rid])
        np.testing.assert_allclose(spec.logprobs[rid], plain.logprobs[rid], atol=1e-5)
        assert [[t for t, _ in a] for a in spec.top_logprobs[rid]] == \
            [[t for t, _ in a] for a in plain.top_logprobs[rid]]
