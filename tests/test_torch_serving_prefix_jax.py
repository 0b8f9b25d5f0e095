"""The port's ``DecodeEngine`` with a prefix cache against JAX's
``DecodeEngine`` with the same cache, over the same weights: the same hits
and reused rows, and greedy tokens equal up to each row's first near tie of
the port's single-stream reference, a hit's built from a fresh prefill of
the first prompt (never from an engine's entry) and its tail fed through
``decode_chunk``."""

import pytest

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   chunked_ref, lm_pair, prefill_rows, shared_prefix_prompts)


def _run(eng, prompts, budgets):
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_prefix_cache_equals_jax(kind):
    jm, jp, pm = lm_pair(kind, scale=3.0)
    prompts = shared_prefix_prompts(7, [2, 4, 1, 3], seed=43)
    budgets = [4] * len(prompts)
    jeng = JaxEngine(jm, jp, max_batch=2, prefix_cache_entries=2)
    eng = DecodeEngine(pm, None, max_batch=2, prefix_cache_entries=2)
    base = prefill_rows(pm, None, prompts[0], 7)
    for i, (p, n) in enumerate(zip(prompts, budgets)):  # one at a time: each later one hits
        want = _run(jeng, [p], [n])[0]
        got = _run(eng, [p], [n])[0]
        assert (eng.prefix_cache_hits, eng.prefix_tokens_reused) == (i, 7 * i)
        assert (jeng.prefix_cache_hits, jeng.prefix_tokens_reused) == (i, 7 * i)
        _, margins = (cached_ref(pm, None, p, n) if i == 0
                      else chunked_ref(pm, None, p, n, None, base=base))
        assert_stream(got, want, margins, f"request {i}")
