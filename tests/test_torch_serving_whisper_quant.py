"""The port's ``WhisperServingEngine`` over int8 / int4 weights (one JAX
``quantize_params`` tree on both sides, every kernel of 1,024 elements or
more quantized): the decode reads the quantized kernels through ``_lin``,
the admission's encoder pass their dequantized copy, and the tokens of
staggered traffic equal JAX's engine's and the port's single-stream
``whisper_transcribe_cached`` over the same tree, up to the first near
tie."""

import pytest

from _torch_serving_common import _one_torch_thread  # noqa: F401
from test_torch_serving_whisper import engines_agree


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_tokens_equal_jax_engine(bits):
    engines_agree(bits)
