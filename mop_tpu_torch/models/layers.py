"""Layers with the reference framework's defaults, in PyTorch.

The port of ``mop_tpu/models/layers.py``. The JAX package reproduces torch's
default initialisers (kaiming-uniform weights, fan-in uniform biases), so
here the torch layers are used as they are; ``init_params`` redraws a whole
model from an explicit ``torch.Generator`` with those same distributions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


class Conv2d(nn.Conv2d):
    """2D convolution over (B, C, H, W) with torch's defaults, the JAX ``Conv``.

    ``padding`` takes the JAX layer's forms: an int (every side), an
    ``(h, w)`` pair, ``((top, bottom), (left, right))``, ``"VALID"`` or
    ``"SAME"`` (XLA's: output size ``ceil(in / stride)``, the odd pad on the
    bottom and right). Pads that differ by side are applied with ``F.pad``
    before an unpadded convolution. Weight and bias ~
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), which ``init_params`` redraws.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, groups: int = 1, bias: bool = True):
        even = isinstance(padding, int) or (
            isinstance(padding, (tuple, list)) and all(isinstance(p, int) for p in padding))
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding if even else 0, dilation=dilation, groups=groups,
                         bias=bias)
        if even or isinstance(padding, str):
            if isinstance(padding, str) and padding.upper() not in ("SAME", "VALID"):
                raise ValueError(f"Conv2d: padding {padding!r}")
            self.pads = None if even or padding.upper() == "VALID" else "SAME"
        else:
            (top, bottom), (left, right) = padding
            self.pads = (left, right, top, bottom)

    def _same_pads(self, h: int, w: int):
        pads = []
        for size, k, s, d in zip((w, h), self.kernel_size[::-1], self.stride[::-1],
                                 self.dilation[::-1]):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            pads += [total // 2, total - total // 2]
        return tuple(pads)

    def forward(self, x: Tensor) -> Tensor:
        if self.pads is None:
            return super().forward(x)
        pads = self._same_pads(*x.shape[-2:]) if self.pads == "SAME" else self.pads
        return super().forward(F.pad(x, pads))


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
        # ((dim, index, count), ...): the input is block ``index`` of
        # ``count`` along ``dim`` of the tensor one device would hold (a
        # parallel mode's local rows, heads or tokens), so the mask is drawn
        # for that whole tensor and this block kept (set by the parallel steps).
        self.shards: Tuple[Tuple[int, int, int], ...] = ()

    def drop(self, x: Tensor, mask_shape) -> Tensor:
        if self.p == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__}: training draws its mask from an explicit "
                "torch.Generator on the input's device; attach one with "
                "set_generator(model, generator) (the train steps do) or call model.eval()")
        keep = 1.0 - self.p
        full = list(mask_shape)
        for dim, _, count in self.shards:
            full[dim] *= count
        mask = torch.rand(full, device=x.device, generator=self.generator) < keep
        for dim, index, _ in self.shards:
            mask = mask.narrow(dim, index * mask_shape[dim], mask_shape[dim])
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
