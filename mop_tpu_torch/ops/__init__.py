"""Ops of the PyTorch port: score algebra, kernels, the log-mel frontend,
preprocessing and weight-only int8 / int4 quantization."""

from . import attention, fused, mel, preprocess, quant

__all__ = ["attention", "fused", "mel", "preprocess", "quant"]
