"""Ops of the PyTorch port: score algebra, kernels and preprocessing."""

from . import attention, fused, preprocess

__all__ = ["attention", "fused", "preprocess"]
