"""The port's ``DecodeEngine`` over int8 / int4 weights: greedy tokens of
staggered traffic equal to JAX's ``DecodeEngine`` over the same quantized
tree (one JAX ``quantize_params``, every kernel quantized), and each
request's tokens equal to the port's single-stream ``generate_cached`` over
the port's own ``quantize_params`` tree, up to the first near tie."""

import pytest

from mop_tpu_torch.models.generate import decode_params
from mop_tpu_torch.ops.quant import quantize_params
from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of)
from test_torch_serving_engine import BUDGETS, LENGTHS, _staggered, engines_agree


@pytest.mark.parametrize("kind,bits", [("baseline", 8), ("quartet", 4)])
def test_quantized_tokens_equal_jax_engine(kind, bits):
    engines_agree(kind, quant=bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_equals_generate_cached(bits):
    _, _, pm = lm_pair("mop", scale=3.0)
    qp = quantize_params(decode_params(pm), min_size=0, bits=bits)
    prompts = prompts_of(LENGTHS, seed=20)
    got = _staggered(DecodeEngine(pm, qp, max_batch=2), prompts, BUDGETS)
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        want, margins = cached_ref(pm, qp, p, n)
        assert_stream(got[i], want, margins, f"request {i}")
