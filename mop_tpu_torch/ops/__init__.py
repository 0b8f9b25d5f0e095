"""Ops of the PyTorch port: score algebra, kernels, the log-mel frontend and
preprocessing."""

from . import attention, fused, mel, preprocess

__all__ = ["attention", "fused", "mel", "preprocess"]
