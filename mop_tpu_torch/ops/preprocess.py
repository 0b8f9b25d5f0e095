"""Input preprocessing on the device — the CIFAR eval transform.

The port of the eval half of ``mop_tpu/ops/preprocess.py``: batches are NCHW,
uint8 in and float32 out. The train augment comes with the training slice.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)


def normalize(x: Tensor, mean, std) -> Tensor:
    """(B,C,H,W) in [0,1] -> normalized."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    std = torch.tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return (x - mean) / std


def to_float(x: Tensor) -> Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return x.to(torch.float32) / 255.0


def cifar_eval_transform(x_uint8: Tensor, mean, std) -> Tensor:
    return normalize(to_float(x_uint8), mean, std)
