"""Input preprocessing on the device — the CIFAR train and eval transforms.

The port of the CIFAR part of ``mop_tpu/ops/preprocess.py``: batches are
NCHW, uint8 in and float32 out. Every random op takes an explicit
``torch.Generator`` (on the batch's device) where the JAX op takes a key;
the two draw different numbers from the same seed.
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


def random_crop(generator: torch.Generator, x: Tensor, padding: int = 4) -> Tensor:
    """Pad-and-crop (torchvision ``RandomCrop(size, padding)``): per-sample
    offsets in [0, 2 * padding], zero padding, two index gathers on the
    device."""
    b, c, h, w = x.shape
    xp = torch.nn.functional.pad(x, (padding, padding, padding, padding))
    off_h = torch.randint(0, 2 * padding + 1, (b,), device=x.device, generator=generator)
    off_w = torch.randint(0, 2 * padding + 1, (b,), device=x.device, generator=generator)
    rows = off_h[:, None] + torch.arange(h, device=x.device)  # (B, H)
    cols = off_w[:, None] + torch.arange(w, device=x.device)  # (B, W)
    out = xp.gather(2, rows[:, None, :, None].expand(b, c, h, w + 2 * padding))
    return out.gather(3, cols[:, None, None, :].expand(b, c, h, w))


def random_hflip(generator: torch.Generator, x: Tensor, p: float = 0.5) -> Tensor:
    """Per-sample horizontal flip with probability ``p``."""
    flip = torch.rand(x.shape[0], device=x.device, generator=generator) < p
    return torch.where(flip[:, None, None, None], x.flip(-1), x)


def cifar_train_augment(generator: torch.Generator, x_uint8: Tensor, mean, std) -> Tensor:
    """The reference CIFAR train transform: RandomCrop(32, pad 4) + flip +
    normalize, on the device."""
    x = random_crop(generator, to_float(x_uint8), padding=4)
    return normalize(random_hflip(generator, x), mean, std)


def cifar_eval_transform(x_uint8: Tensor, mean, std) -> Tensor:
    return normalize(to_float(x_uint8), mean, std)


def label_smoothing_onehot(y: Tensor, n_classes: int, smoothing: float = 0.0) -> Tensor:
    """One-hot targets with label smoothing, float32."""
    off = smoothing / n_classes
    on = 1.0 - smoothing + off
    return torch.nn.functional.one_hot(y, n_classes).to(torch.float32) * (on - off) + off
