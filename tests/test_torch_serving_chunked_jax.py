"""The port's ``DecodeEngine`` with ``chunk_prefill`` against JAX's
``DecodeEngine`` with the same chunk, over the same weights: greedy tokens
equal up to each row's first near tie of the port's single-stream
``decode_chunk`` feed."""

import pytest

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   chunked_ref, lm_pair, prompts_of)


@pytest.mark.parametrize("kind", ["quartet", "mop"])
def test_chunked_prefill_equals_jax(kind):
    """A short request decodes while longer prompts feed in 4-token chunks
    beside it."""
    jm, jp, pm = lm_pair(kind, scale=3.0)
    prompts = prompts_of([2, 13, 11, 3], seed=51)
    budgets = [8, 3, 2, 5]

    def staggered(eng):
        rids = [eng.submit(prompts[0], budgets[0])]
        eng.step()
        rids += [eng.submit(p, n) for p, n in zip(prompts[1:], budgets[1:])]
        res = eng.run()
        return [res[r] for r in rids]

    want = staggered(JaxEngine(jm, jp, max_batch=2, chunk_prefill=4))
    got = staggered(DecodeEngine(pm, None, max_batch=2, chunk_prefill=4))
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = (chunked_ref(pm, None, p, n, 4) if len(p) > 4
                      else cached_ref(pm, None, p, n))
        assert_stream(got[i], want[i], margins, f"request {i}")
