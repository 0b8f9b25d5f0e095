"""The port's continuous-batching ``DecodeEngine`` against the JAX package's
and against the port's single-stream decoder: greedy tokens of staggered,
oversubscribed traffic equal to JAX's ``DecodeEngine`` over the same weights
(the int8 / int4 weights in ``test_torch_serving_quant.py``), and each request's
tokens equal to the port's ``generate_cached`` alone at the same KV dtype
(fp32, bf16, int8 with per-row scales), up to the first near tie."""

import jax
import pytest
import torch

from mop_tpu.ops.quant import quantize_params as jax_quantize
from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of, to_torch)

LENGTHS = [3, 7, 5, 9, 4]
BUDGETS = [6, 4, 8, 5, 7]


def _staggered(eng, prompts, budgets):
    """Two requests, two steps, then the rest: the later ones join rows
    already mid-stream."""
    rids = [eng.submit(p, n) for p, n in zip(prompts[:2], budgets[:2])]
    eng.step()
    eng.step()
    rids += [eng.submit(p, n) for p, n in zip(prompts[2:], budgets[2:])]
    res = eng.run()
    return [res[r] for r in rids]


def engines_agree(kind, quant=None):
    """JAX's engine and the port's over the same weights (``quant``: every
    kernel of both as int8 / int4 from one JAX ``quantize_params``) on
    staggered traffic over 3 slots: tokens equal up to the first near tie."""
    jm, jp, pm = lm_pair(kind, scale=3.0)
    if quant is not None:
        jp = jax_quantize(jp, min_size=0, bits=quant)
    pp = to_torch(jax.device_get(jp))
    prompts = prompts_of(LENGTHS)
    # JAX's buckets only bound its compiles; the tokens are those without
    want = _staggered(JaxEngine(jm, jp, max_batch=3, prefill_buckets=[16]), prompts, BUDGETS)
    got = _staggered(DecodeEngine(pm, pp, max_batch=3), prompts, BUDGETS)
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        _, margins = cached_ref(pm, pp, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_greedy_tokens_equal_jax_engine(kind):
    engines_agree(kind)


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["quartet", "mop"])
def test_each_request_equals_generate_cached(kind, kv):
    kv_dtype = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[kv]
    _, jp, pm = lm_pair(kind, scale=3.0)
    prompts = prompts_of(LENGTHS, seed=10)
    eng = DecodeEngine(pm, None, max_batch=2, kv_dtype=kv_dtype)
    got = _staggered(eng, prompts, BUDGETS)
    if kv == "int8":
        assert eng._cache["k"].dtype == torch.int8 and "k_s" in eng._pool_keys
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        want, margins = cached_ref(pm, None, p, n, kv_dtype)
        assert_stream(got[i], want, margins, f"request {i}")


def test_engine_device_follows_params_and_sharding_raises():
    _, _, pm = lm_pair("quartet")
    eng = DecodeEngine(pm, None, max_batch=2)
    assert eng.device == torch.device("cpu") and eng._cache["k"].device.type == "cpu"
    with pytest.raises(ValueError, match="cache_sharding"):
        DecodeEngine(pm, None, max_batch=2, cache_sharding=object())
