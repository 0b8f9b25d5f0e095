"""Layers with the reference framework's defaults, in PyTorch.

The port of ``mop_tpu/models/layers.py``. The JAX package reproduces torch's
default initialisers (kaiming-uniform weights, fan-in uniform biases), so
here the torch layers are used as they are; ``init_params`` redraws a whole
model from an explicit ``torch.Generator`` with those same distributions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

Linear = nn.Linear
Conv = nn.Conv2d


class Conv1d(nn.Conv1d):
    """1D convolution over (B, C, L) with torch's defaults, the JAX ``Conv1d``.

    ``padding`` is an int (both sides) or a ``(left, right)`` pair; an
    uneven pair (the causal left pad) is applied with ``F.pad`` before an
    unpadded convolution, since ``nn.Conv1d`` pads both sides alike. Weight
    and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's kaiming-uniform
    and bias default), which ``init_params`` redraws from a generator.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding=0, bias: bool = True):
        left, right = (padding, padding) if isinstance(padding, int) else padding
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=left if left == right else 0, bias=bias)
        self.pad = None if left == right else (left, right)

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(x if self.pad is None else F.pad(x, self.pad))


class LayerNorm(nn.Module):
    """LayerNorm with torch defaults (eps 1e-5, affine) and fp32 statistics;
    the output takes the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: Tensor) -> Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                         self.eps)
        return y.to(x.dtype)


class RandomDrop(nn.Module):
    """Base of the modules that zero part of their input in training
    (``Dropout``, ``DropPath``): ``where(mask, x / keep, 0)`` with
    ``P(mask) = keep = 1 - p``, as the JAX package's dropout. The mask comes
    from the explicit ``generator`` attribute (set by ``set_generator``),
    never from the global RNG. Identity at rate 0 or in eval mode."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def drop(self, x: Tensor, mask_shape) -> Tensor:
        if self.p == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__}: training draws its mask from an explicit "
                "torch.Generator on the input's device; attach one with "
                "set_generator(model, generator) (the train steps do) or call model.eval()")
        keep = 1.0 - self.p
        mask = torch.rand(mask_shape, device=x.device, generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(RandomDrop):
    """Elementwise dropout (see ``RandomDrop``)."""

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(x, x.shape)


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Attach ``generator`` to every ``RandomDrop`` module of ``model``
    (``Dropout``, ``DropPath``), and return the model."""
    for m in model.modules():
        if isinstance(m, RandomDrop):
            m.generator = generator
    return model


class Embedding(nn.Embedding):
    """Embedding table with normal(0.02) init (the JAX ``Embedding``'s);
    ``attend`` is the tied head, ``x @ table.T``."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__(num_embeddings, features)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)

    def attend(self, x: Tensor) -> Tensor:
        return x @ self.weight.t()


def gelu_tanh(x: Tensor) -> Tensor:
    """GELU with the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_params(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Redraw every parameter of ``model`` with the reference's initialisers.

    Linear and conv weights and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (torch's kaiming_uniform(a=sqrt(5)) and bias default), LayerNorm ones and
    zeros; then every module with an ``init_own(generator)`` method sets the
    parameters it owns (position embeddings, gate presets, gains).
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in model.modules():
            if hasattr(m, "init_own"):
                m.init_own(generator)
    return model
