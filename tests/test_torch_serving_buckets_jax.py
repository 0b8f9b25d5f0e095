"""The port's ``DecodeEngine`` with ``prefill_buckets`` against JAX's
``DecodeEngine`` with the same buckets, over the same weights: greedy tokens
equal up to each row's first near tie of the port's single-stream
``generate_cached`` (the pads masked out of every row statistic)."""

import pytest

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of)


def _run(eng, prompts, budgets):
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind", ["quartet", "mop"])
def test_buckets_equal_jax(kind):
    jm, jp, pm = lm_pair(kind, scale=3.0)
    prompts = prompts_of([3, 5, 9, 12, 2], seed=30)
    budgets = [4, 6, 3, 4, 8]
    want = _run(JaxEngine(jm, jp, max_batch=3, prefill_buckets=[4, 8]), prompts, budgets)
    got = _run(DecodeEngine(pm, None, max_batch=3, prefill_buckets=[4, 8]), prompts, budgets)
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")
