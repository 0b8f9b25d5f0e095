"""ViT single-box localizer and its box metrics, in PyTorch — the port of
``mop_tpu/models/vit_localizer.py``.

Modes: A (plain ViT encoder), B (the MoP token gate after the encoder), E
(pre-LN blocks around ``UnifiedMSA("E")``). Head: mean-pool -> LN -> MLP ->
sigmoid, a box (x0, y0, x1, y1) in [0, 1]. ``bbox_iou`` normalizes the
corners and clamps to [0, 1] before the IoU; ``smooth_l1`` is the training
loss. Module names follow the torch reference, so its state dicts load with
``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .attention_variants import UnifiedMSA
from .components import FuseExcInh, Kernels3, PatchEmbed, ViewsLinear, ViTEncoder
from .layers import LayerNorm, Linear, init_params

Tensor = torch.Tensor


def _tanh_gelu() -> nn.Module:
    return nn.GELU(approximate="tanh")


class ViTLocHead(nn.Module):
    """Mean-pool -> LN -> Linear -> tanh-GELU -> Linear(4, bias) -> sigmoid."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = LayerNorm(dim)
        self.mlp = nn.Sequential(Linear(dim, dim, bias=False), _tanh_gelu(),
                                 Linear(dim, 4, bias=True))

    def forward(self, tok: Tensor) -> Tensor:
        return torch.sigmoid(self.mlp(self.ln(tok.mean(1))))


class _BlockUnified(nn.Module):
    """Pre-LN block around a ``UnifiedMSA`` of mode ``attn_mode``, with a
    bias-free tanh-GELU MLP and no stochastic depth."""

    def __init__(self, dim: int, heads: int, attn_mode: str, attn_kwargs: Optional[Dict],
                 mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.ln1 = LayerNorm(dim)
        self.attn = UnifiedMSA(attn_mode, dim=dim, heads=heads, **(attn_kwargs or {}))
        self.ln2 = LayerNorm(dim)
        self.mlp = nn.Sequential(Linear(dim, hidden, bias=False), _tanh_gelu(),
                                 Linear(hidden, dim, bias=False))

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViTLocalizer(nn.Module):
    """Single-object box regressor on a ViT backbone of mode A, B or E.

    Built on ``device`` (the GPU unless given); ``generator`` seeds the
    initialisation. ``attn_kwargs`` are E's ``UnifiedMSA`` options;
    ``mop_views`` and ``mop_kernels`` size B's gate.
    """

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 mlp_ratio: float = 4.0, drop_path: float = 0.1, patch: int = 16,
                 img_size: int = 224, attn_mode: str = "A",
                 attn_kwargs: Optional[Dict] = None, mop_views: int = 5,
                 mop_kernels: int = 3, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mode = str(attn_mode).upper()
        if mode not in ("A", "B", "E"):
            raise ValueError(f"Unknown attn_mode: {attn_mode}")
        device = resolve_device(device)
        self.mode = mode
        num_tokens = (img_size // patch) ** 2
        if mode in ("A", "B"):
            self.enc = ViTEncoder(dim=dim, depth=depth, heads=heads, mlp_ratio=mlp_ratio,
                                  drop_path=drop_path, patch=patch, num_tokens=num_tokens)
            if mode == "B":
                self.views = ViewsLinear(dim, n_views=mop_views)
                self.kerns = Kernels3(in_ch=mop_views, n_kernels=mop_kernels)
                self.fuse = FuseExcInh(in_ch=mop_views + mop_kernels)
        else:
            self.patch_embed = PatchEmbed(dim=dim, patch=patch)
            self.pos = nn.Parameter(torch.empty(1, num_tokens, dim))
            self.blocks = nn.ModuleList(_BlockUnified(dim, heads, "E", attn_kwargs, mlp_ratio)
                                        for _ in range(depth))
            self.ln_f = LayerNorm(dim)
            self.init_own(None)
        self.head = ViTLocHead(dim)
        if generator is not None:
            init_params(self, generator)
        self.to(device)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        if self.mode == "E":
            with torch.no_grad():
                nn.init.normal_(self.pos, 0.0, 0.02, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        if self.mode == "E":
            tok, _ = self.patch_embed(x)
            tok = tok + self.pos
            for blk in self.blocks:
                tok = blk(tok)
            tok = self.ln_f(tok)
        else:
            tok, grid = self.enc(x)
            if self.mode == "B":
                v = self.views(tok, grid)
                g_pos, g_neg, a_pos, a_neg = self.fuse(torch.cat([v, self.kerns(v)], dim=1))
                gate = 1.0 + a_pos * g_pos - a_neg * g_neg
                b, n, _ = tok.shape
                tok = tok * gate.reshape(b, n, 1)
        return self.head(tok)


def bbox_iou(box1: Tensor, box2: Tensor) -> Tensor:
    """IoU of (..., 4) boxes [x0, y0, x1, y1] in [0, 1], after ordering each
    box's corners and clamping them to [0, 1]; the union is floored at 1e-12."""
    def corners(b):
        lo = torch.minimum(b[..., :2], b[..., 2:]).clamp(0.0, 1.0)
        hi = torch.maximum(b[..., :2], b[..., 2:]).clamp(0.0, 1.0)
        return lo, hi

    lo1, hi1 = corners(box1)
    lo2, hi2 = corners(box2)
    wh = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (hi1 - lo1).clamp(min=0.0).prod(-1)
    area2 = (hi2 - lo2).clamp(min=0.0).prod(-1)
    return inter / (area1 + area2 - inter).clamp(min=1e-12)


def smooth_l1(pred: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """Elementwise SmoothL1 (Huber): ``0.5 d^2 / beta`` below ``beta``, else
    ``d - 0.5 beta``."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
