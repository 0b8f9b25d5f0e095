"""The port's ``DecodeEngine`` options against the port's own references
(JAX's engine with the same options in ``test_torch_serving_buckets_jax.py``,
``_prefix_jax.py`` and ``_chunked_jax.py``), each held to the plain engine
where it must not change the tokens: ``prefill_buckets`` (the pads masked
out of every row statistic) and greedy ``step(n_tokens=k)``; the prefix
cache and ``chunk_prefill``, held to the single-stream ``decode_chunk``
composition they compute (a fed row standardizes over its live prefix, a
prefilled one over the whole prompt), with a prefix entry owning its rows
and co-batched streams emitting while a long prompt feeds; and the
engine's control: EOS, the window bound, a budget of one, cancel, the
counters and the input checks."""

import numpy as np
import pytest
import torch

from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   chunked_ref, lm_pair, prefill_rows, prompts_of,
                                   shared_prefix_prompts)


def _run(eng, prompts, budgets, n_tokens=1):
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = eng.run(n_tokens=n_tokens)
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind", ["quartet", "mop", "baseline"])
def test_buckets_keep_the_tokens(kind):
    _, _, pm = lm_pair(kind, scale=3.0)
    prompts = prompts_of([3, 5, 9, 12, 2], seed=30)
    budgets = [4, 6, 3, 4, 8]
    plain = _run(DecodeEngine(pm, None, max_batch=3), prompts, budgets)
    bucketed = _run(DecodeEngine(pm, None, max_batch=3, prefill_buckets=[4, 8]),
                    prompts, budgets)  # 9 and 12 fall past the last bucket: exact prefill
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(bucketed[i], plain[i], margins, f"request {i}")
    with pytest.raises(ValueError, match="exceeds block_size"):
        DecodeEngine(pm, None, prefill_buckets=[8, 32])


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_prefix_cache_reuses_rows_and_owns_them(kind):
    """A hit pastes an entry's rows and feeds the tail through
    ``decode_chunk_rows``: its tokens are those of that single-stream
    composition over a fresh prefill of the first prompt's rows
    (``chunked_ref``, ``prefill_rows``); with ``causal_std`` (GPT-MoP
    causal) they are also the plain engine's, since no row statistic sees a
    later token."""
    _, _, pm = lm_pair(kind, scale=3.0)
    prompts = shared_prefix_prompts(7, [2, 4, 1, 3], seed=40)
    budgets = [4] * len(prompts)
    plain = _run(DecodeEngine(pm, None, max_batch=2), prompts, budgets)
    eng = DecodeEngine(pm, None, max_batch=2, prefix_cache_entries=2)
    base = prefill_rows(pm, None, prompts[0], 7)
    cached = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):  # one at a time: each later one hits
        rid = eng.submit(p, n)
        cached.append(eng.run()[rid])
        assert eng.prefix_cache_hits == i and eng.prefix_tokens_reused == 7 * i
        want, margins = (cached_ref(pm, None, p, n) if i == 0
                         else chunked_ref(pm, None, p, n, None, base=base))
        assert_stream(cached[i], want, margins, f"request {i}")
        if kind == "mop_causal":
            assert_stream(cached[i], plain[i], margins, f"request {i} vs no cache")
    # an entry owns its rows: traffic through its slot leaves it as it was
    entry = next(iter(eng._prefix_lru.values()))
    before = {k: entry[k].clone() for k in eng._pool_keys}
    for key in eng._pool_keys:
        assert entry[key].data_ptr() != eng._cache[key].data_ptr()
    _run(eng, prompts_of([11, 12], seed=42), [4, 4])
    for key in eng._pool_keys:
        assert torch.equal(entry[key], before[key]), key


@pytest.mark.parametrize("kind", ["quartet", "mop"])
def test_chunked_prefill_feeds_beside_the_stream(kind):
    _, _, pm = lm_pair(kind, scale=3.0)
    prompts = prompts_of([2, 13, 11, 3], seed=50)
    budgets = [8, 3, 2, 5]
    eng = DecodeEngine(pm, None, max_batch=2, chunk_prefill=4)
    r0 = eng.submit(prompts[0], budgets[0])
    eng.step()  # the short request is decoding
    rids = [r0] + [eng.submit(p, n) for p, n in zip(prompts[1:], budgets[1:])]
    out = eng.step()  # the 13-token prompt reserves a slot and feeds 4 tokens
    assert eng._chunk_state and out.get(r0)  # the decode stream emitted meanwhile
    res = eng.run()
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        want, margins = (chunked_ref(pm, None, p, n, 4) if len(p) > 4
                         else cached_ref(pm, None, p, n))
        assert_stream(res[rids[i]], want, margins, f"request {i}")
    with pytest.raises(ValueError, match="chunk_prefill"):
        DecodeEngine(pm, None, chunk_prefill=17)


def test_multistep_greedy_equals_single_steps():
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompts = prompts_of([3, 6, 4, 8], seed=60)
    budgets = [9, 2, 7, 5]
    one = _run(DecodeEngine(pm, None, max_batch=4), prompts, budgets)
    eng = DecodeEngine(pm, None, max_batch=4)
    four = _run(eng, prompts, budgets, n_tokens=4)
    assert four == one
    assert eng.engine_steps < sum(budgets) // 2


def test_eos_window_and_budget_of_one():
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompt = prompts_of([3], seed=70)[0]
    ref, _ = cached_ref(pm, None, prompt, 12)
    first = {t: i for i, t in reversed(list(enumerate(ref)))}
    eos, idx = max(first.items(), key=lambda kv: kv[1])
    eng = DecodeEngine(pm, None, max_batch=2, eos_id=eos)
    rid = eng.submit(prompt, 12)
    assert eng.run()[rid] == ref[:idx + 1] and eng.is_done(rid)
    eng = DecodeEngine(pm, None, max_batch=1)
    rid = eng.submit(list(range(1, 13)), 50)  # t0 = 12 of block 16
    assert len(eng.run()[rid]) == 16 - 12 + 1
    rid = eng.submit(prompt, 1)
    out = eng.step()
    assert eng.is_done(rid) and out[rid] == ref[:1]


def test_cancel_counters_and_checks():
    _, _, pm = lm_pair("quartet", scale=3.0)
    eng = DecodeEngine(pm, None, max_batch=1)
    p0, p1, p2 = prompts_of([3, 2, 4], seed=80)
    r0, r1, r2 = eng.submit(p0, 12), eng.submit(p1, 5), eng.submit(p2, 3)
    assert eng.cancel(r1)  # queued: never runs
    eng.step()
    eng.step()
    got = len(eng.results[r0])
    assert 0 < got < 12 and eng.cancel(r0)  # active: its slot frees
    assert eng._lens[0] == 0
    res = eng.run()
    assert res[r1] == [] and res[r0] == cached_ref(pm, None, p0, 12)[0][:got]
    assert res[r2] == cached_ref(pm, None, p2, 3)[0]
    assert not eng.cancel(r2) and not eng.cancel(999)
    eng = DecodeEngine(pm, None, max_batch=2)
    eng.submit([1, 2, 3], 4)
    eng.submit([4, 5], 6)
    eng.run()
    assert eng.tokens_generated == 10 and eng.engine_steps == 5
    for bad, match in (((list(range(16)), 4), "prompt length"), (([1, 2], 0), "max_new_tokens"),
                       (([1, 40], 2), "outside vocab")):
        with pytest.raises(ValueError, match=match):
            eng.submit(*bad)
    with pytest.raises(ValueError, match="seed"):
        eng.submit([1], 2, seed=-1)
    with pytest.raises(ValueError, match="eos_id"):
        eng.submit([1], 2, eos_id=40)
    assert not np.any(eng._lens)
