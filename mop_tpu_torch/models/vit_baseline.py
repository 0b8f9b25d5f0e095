"""Baseline Vision Transformer (A), in PyTorch — the port of
``mop_tpu/models/vit_baseline.py``."""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .components import ViTEncoder
from .layers import Linear, init_params

Tensor = torch.Tensor


class ViT_Baseline(nn.Module):
    """Standard ViT: encoder -> mean-pool -> bias-free linear head.

    Same ctor kwargs and parameter count as the JAX model. Built on ``device``
    (the GPU unless given); ``generator`` seeds the initialisation.
    """

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 mlp_ratio: float = 4.0, n_classes: int = 10, drop_path: float = 0.1,
                 patch: int = 4, img_size: int = 32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % heads != 0:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        device = resolve_device(device)
        self.enc = ViTEncoder(dim=dim, depth=depth, heads=heads, mlp_ratio=mlp_ratio,
                              drop_path=drop_path, patch=patch,
                              num_tokens=(img_size // patch) ** 2)
        self.cls = Linear(dim, n_classes, bias=False)
        if generator is not None:
            init_params(self, generator)
        self.to(device)

    def forward(self, x: Tensor) -> Tensor:
        tok, _ = self.enc(x)
        return self.cls(tok.mean(1))
