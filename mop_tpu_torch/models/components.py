"""Core MoP components — ViT bricks and the MoP gate bricks, in PyTorch.

The port of ``mop_tpu/models/components.py``. Module and parameter names
follow the torch reference, so reference state dicts load with
``load_state_dict``; the MoE MLP keeps the JAX module's stacked expert
weights. Images are NCHW and stay NCHW: tokens are
the row-major (gh, gw) flatten of the patch grid, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import config as kernel_switches
from ..ops import attention as A
from ..ops import fused as ops_fused
from ..ops import moe as ops_moe
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
        # The head width comes from qkv's output, so that a tensor-parallel
        # qkv holding ``heads`` of the heads (parallel.tp) reads the same.
        b, n, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        if (kernel_switches.fused_attention and ops_fused.flash_fits(q.shape[-1])
                and (self.attn_drop.p == 0.0 or not self.training)):
            y = ops_fused.flash_attention(q, k, v, causal=False)
        else:
            a = self.attn_drop(torch.softmax(A.scaled_scores(q, k), -1))
            y = a.to(v.dtype) @ v
        return self.proj_drop(self.proj(y.transpose(1, 2).reshape(b, n, -1)))


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


class MoEMLP(nn.Module):
    """Token-level top-1 mixture-of-experts MLP: E bias-free 2-layer
    tanh-GELU MLPs behind a biased gate, the argmax expert per token.

    The experts' weights are stacked as in the JAX module, ``fc1`` (E, D, H)
    and ``fc2`` (E, H, D); ``gate_kernel`` is (E, D), the torch (out, in)
    layout of the JAX (D, E) leaf (``load_jax_params`` and the JAX
    package's ``port_torch_state_dict`` transpose it, as every 2-D kernel),
    and ``gate_bias`` (E,). Each weight ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    with the JAX initialiser's fan-in (an expert's input width times E for
    the stacked weights, D for the gate). ``impl``: "dense" (every expert on
    every token, reference-exact) or "routed" (capacity-bounded dispatch,
    ``capacity_factor`` slots per expert per fair share); see ``ops.moe``.
    """

    def __init__(self, dim: int, mlp_ratio: float = 4.0, num_experts: int = 4,
                 impl: str = "dense", capacity_factor: float = 1.25):
        super().__init__()
        if num_experts < 2:
            raise ValueError("MoE requires at least 2 experts")
        if impl not in ("dense", "routed"):
            raise ValueError(f"unknown MoE impl {impl!r}")
        hidden = int(dim * mlp_ratio)
        self.impl = impl
        self.capacity_factor = capacity_factor
        self.fc1 = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.fc2 = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.gate_kernel = nn.Parameter(torch.empty(num_experts, dim))
        self.gate_bias = nn.Parameter(torch.empty(num_experts))
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        e, d, h = self.fc1.shape
        with torch.no_grad():
            for w, fan_in in ((self.fc1, e * d), (self.fc2, e * h), (self.gate_kernel, d),
                              (self.gate_bias, d)):
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(w, -bound, bound, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        b, n, d = x.shape
        args = (x.reshape(b * n, d), self.gate_kernel.t(), self.gate_bias, self.fc1, self.fc2,
                gelu_tanh)
        if self.impl == "routed":
            y = ops_moe.top1_routed_mlp(*args, capacity_factor=self.capacity_factor)
        else:
            y = ops_moe.dense_top1_mlp(*args)
        return y.reshape(b, n, d)


class Block(nn.Module):
    """Pre-LN transformer block with stochastic depth; its MLP is ``mlp``
    where given, else an ``MLP``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 mlp: Optional[nn.Module] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = MSA(dim, heads, attn_drop, drop)
        self.dp1 = DropPath(drop_path)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio, drop) if mlp is None else mlp
        self.dp2 = DropPath(drop_path)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.dp1(self.attn(self.ln1(x)))
        return x + self.dp2(self.mlp(self.ln2(x)))


class BlockMoE(Block):
    """Pre-LN transformer block whose MLP is a ``MoEMLP``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, num_experts: int = 4,
                 moe_impl: str = "dense"):
        super().__init__(dim, heads, mlp_ratio, drop, attn_drop, drop_path,
                         mlp=MoEMLP(dim, mlp_ratio, num_experts, impl=moe_impl))


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
            self.make_block(dim, heads, mlp_ratio, drop, dp)
            for dp in drop_path_schedule(drop_path, depth))
        self.ln_f = LayerNorm(dim)
        self.init_own(None)

    def make_block(self, dim, heads, mlp_ratio, drop, drop_path) -> nn.Module:
        return Block(dim, heads, mlp_ratio, drop, 0.0, drop_path)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            nn.init.normal_(self.pos, 0.0, 0.02, generator=generator)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tuple[int, int]]:
        tok, grid = self.patch(x)
        tok = tok + self.pos
        for blk in self.blocks:
            tok = blk(tok)
        return self.ln_f(tok), grid


class ViTEncoderMoE(ViTEncoder):
    """ViT encoder whose blocks are ``BlockMoE``: ``num_experts`` experts per
    MLP, by ``moe_impl``."""

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 mlp_ratio: float = 4.0, drop: float = 0.0, drop_path: float = 0.1,
                 patch: int = 4, num_tokens: int = 64, num_experts: int = 4,
                 moe_impl: str = "dense"):
        self.num_experts, self.moe_impl = num_experts, moe_impl
        super().__init__(dim, depth, heads, mlp_ratio, drop, drop_path, patch, num_tokens)

    def make_block(self, dim, heads, mlp_ratio, drop, drop_path) -> nn.Module:
        return BlockMoE(dim, heads, mlp_ratio, drop, 0.0, drop_path,
                        num_experts=self.num_experts, moe_impl=self.moe_impl)


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
