"""Core MoP components — ViT bricks and the MoP gate bricks, in PyTorch.

The port of ``mop_tpu/models/components.py`` (MoE waits for a later slice).
Module and parameter names follow the torch reference, so reference state
dicts load with ``load_state_dict``. Images are NCHW and stay NCHW: tokens are
the row-major (gh, gw) flatten of the patch grid, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import config as kernel_switches
from ..ops import attention as A
from ..ops import fused as ops_fused
from .layers import Conv, Dropout, LayerNorm, Linear, RandomDrop, gelu_tanh

Tensor = torch.Tensor


class DropPath(RandomDrop):
    """Stochastic depth — drops the whole residual branch per sample.

    The per-sample mask is drawn from the explicit ``generator`` attribute
    (see ``RandomDrop``), as the JAX module draws it from its ``dropout``
    key; it never touches the global RNG."""

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(x, (x.shape[0],) + (1,) * (x.dim() - 1))


class PatchEmbed(nn.Module):
    """Image (B, C, H, W) to patch tokens (B, Gh*Gw, D) via a strided conv.

    Returns (tokens, (Gh, Gw)).
    """

    def __init__(self, in_ch: int = 3, dim: int = 256, patch: int = 4):
        super().__init__()
        self.proj = Conv(in_ch, dim, patch, stride=patch, bias=False)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tuple[int, int]]:
        y = self.proj(x)  # (B, D, Gh, Gw)
        gh, gw = y.shape[-2:]
        return y.flatten(2).transpose(1, 2), (gh, gw)


class MSA(nn.Module):
    """Multi-head self-attention, fused QKV, bias-free; attention runs through
    the flash kernel (K1) where it takes the head width and attention dropout
    is off (rate 0 or eval mode), else the composed scores, softmax,
    attention dropout (drawn from the explicit generator of ``Dropout``) and
    value product of the JAX module's non-fused path."""

    def __init__(self, dim: int, heads: int = 4, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, dim * 3, bias=False)
        self.proj = Linear(dim, dim, bias=False)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: Tensor) -> Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(
            2, 0, 3, 1, 4)
        if (kernel_switches.fused_attention and ops_fused.flash_fits(d // self.heads)
                and (self.attn_drop.p == 0.0 or not self.training)):
            y = ops_fused.flash_attention(q, k, v, causal=False)
        else:
            a = self.attn_drop(torch.softmax(A.scaled_scores(q, k), -1))
            y = a.to(v.dtype) @ v
        return self.proj_drop(self.proj(y.transpose(1, 2).reshape(b, n, d)))


class MLP(nn.Module):
    """Bias-free 2-layer MLP with tanh-GELU."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop: float = 0.0):
        super().__init__()
        hid = int(dim * mlp_ratio)
        self.fc1 = Linear(dim, hid, bias=False)
        self.fc2 = Linear(hid, dim, bias=False)
        self.drop = Dropout(drop)

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(self.fc2(gelu_tanh(self.fc1(x))))


class Block(nn.Module):
    """Pre-LN transformer block with stochastic depth."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = MSA(dim, heads, attn_drop, drop)
        self.dp1 = DropPath(drop_path)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio, drop)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.dp1(self.attn(self.ln1(x)))
        return x + self.dp2(self.mlp(self.ln2(x)))


def drop_path_schedule(drop_path: float, depth: int):
    """Per-block stochastic-depth rates, linear from 0 to ``drop_path``."""
    return [float(v) for v in np.linspace(0.0, drop_path, depth)]


class ViTEncoder(nn.Module):
    """Patchify + learned pos emb + transformer blocks + final LN."""

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 mlp_ratio: float = 4.0, drop: float = 0.0, drop_path: float = 0.1,
                 patch: int = 4, num_tokens: int = 64):
        super().__init__()
        self.patch = PatchEmbed(dim=dim, patch=patch)
        self.pos = nn.Parameter(torch.empty(1, num_tokens, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, drop, 0.0, dp)
            for dp in drop_path_schedule(drop_path, depth))
        self.ln_f = LayerNorm(dim)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            nn.init.normal_(self.pos, 0.0, 0.02, generator=generator)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tuple[int, int]]:
        tok, grid = self.patch(x)
        tok = tok + self.pos
        for blk in self.blocks:
            tok = blk(tok)
        return self.ln_f(tok), grid


class ViewsLinear(nn.Module):
    """Tokens -> V spatial view maps (B, V, Gh, Gw)."""

    def __init__(self, dim: int, n_views: int = 5):
        super().__init__()
        self.n_views = n_views
        self.proj = Linear(dim, n_views, bias=False)

    def forward(self, tok: Tensor, grid: Tuple[int, int]) -> Tensor:
        b = tok.shape[0]
        gh, gw = grid
        return self.proj(tok).transpose(1, 2).reshape(b, self.n_views, gh, gw)


class Kernels3(nn.Module):
    """3x3 conv -> SiLU -> 1x1 conv over (B, C, Gh, Gw) view maps."""

    def __init__(self, in_ch: int, n_kernels: int = 3):
        super().__init__()
        self.k = nn.Sequential(
            Conv(in_ch, 16, 3, padding=1, bias=False),
            nn.SiLU(),
            Conv(16, n_kernels, 1, bias=False),
        )

    def forward(self, maps: Tensor) -> Tensor:
        return self.k(maps)


class FuseExcInh(nn.Module):
    """Excitatory/inhibitory fusion.

    Returns (G_pos, G_neg, a_pos, a_neg): sigmoid'd (B,1,Gh,Gw) maps and
    softplus'd scalar gains (alpha init 0.8).
    """

    def __init__(self, in_ch: int):
        super().__init__()
        hid = max(8, in_ch)
        self.fuse = nn.Sequential(
            Conv(in_ch, hid, 1, bias=False),
            nn.SiLU(),
            Conv(hid, 2, 1, bias=True),
        )
        self.alpha_pos = nn.Parameter(torch.empty(()))
        self.alpha_neg = nn.Parameter(torch.empty(()))
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.alpha_pos.fill_(0.8)
            self.alpha_neg.fill_(0.8)

    def forward(self, x: Tensor):
        g = self.fuse(x)
        return (torch.sigmoid(g[:, :1]), torch.sigmoid(g[:, 1:]),
                F.softplus(self.alpha_pos), F.softplus(self.alpha_neg))
