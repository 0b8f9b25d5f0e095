"""Edgewise-gated attention (mode E), in PyTorch.

The port of the E-mode part of ``mop_tpu/models/attention_variants.py``:
the lowrank gate head and ``EdgewiseMSA`` with and without ``share_qkv``,
whose attention runs through the fused K2 kernel on the card. The dense gate
head, its 3x3 mid conv (``use_k3``) and the lens banks are not ported yet and
raise. Parameter names follow the torch reference (``qkv_list.i``,
``edge_head.row_proj`` as a 1x1 Conv1d).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import fused as ops_fused
from .layers import Dropout, Linear

Tensor = torch.Tensor

# Gate channel of each preset: 0=and, 1=or, 2=not, 3=chain.
_PRESET_CHANNEL = {"and": 0, "or": 1, "not": 2, "chain": 3, "nor": 2, "xor": 1}


def _split_heads(x: Tensor, h: int) -> Tensor:
    """(B, N, D) -> (B, H, N, dk)."""
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).transpose(1, 2)


def _merge_heads(y: Tensor) -> Tensor:
    """(B, H, N, dk) -> (B, N, D)."""
    b, h, n, dk = y.shape
    return y.transpose(1, 2).reshape(b, n, h * dk)


def _qkv(x: Tensor, h: int, lin: nn.Module) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused bias-free QKV projection split into (B,H,N,dk) triples."""
    b, n, d = x.shape
    q, k, v = lin(x).reshape(b, n, 3, h, d // h).permute(2, 0, 3, 1, 4)
    return q, k, v


def _preset_block_bias(gate_init: str, gate_rank: int, total: int) -> Tensor:
    """Low-rank bias preset: constant sqrt(2/r) on the preset's rank block."""
    bias = torch.zeros(total)
    c = float(max(0.0, (2.0 / max(1, gate_rank)) ** 0.5))
    if gate_init in _PRESET_CHANNEL:
        i = _PRESET_CHANNEL[gate_init]
        bias[i * gate_rank:(i + 1) * gate_rank] = c
    elif gate_init == "mix5":
        for i in (0, 1, 2):
            bias[i * gate_rank:(i + 1) * gate_rank] = c
    return bias


def _dense_head_bias(gate_init: str) -> Tensor:
    """Dense-head output bias preset: all -5 (gates ~off), preset channel +2."""
    bias = torch.full((4,), -5.0)
    if gate_init in _PRESET_CHANNEL:
        bias[_PRESET_CHANNEL[gate_init]] = 2.0
    return bias


class EdgewiseGateHead(nn.Module):
    """Per-edge gate head, lowrank mode: row/col mean-pooled score features
    -> rank-r factors per gate (channel order and, or, not, chain)."""

    def __init__(self, in_ch: int, hidden: int = 16, use_k3: bool = False,
                 gate_mode: str = "dense", gate_rank: int = 4, gate_init: str = "neutral"):
        super().__init__()
        if gate_mode == "dense" or use_k3:
            raise NotImplementedError(
                "EdgewiseGateHead: the dense gate head (and use_k3) is not ported yet")
        self.gate_rank = gate_rank
        self.gate_init = gate_init
        self.row_proj = nn.Conv1d(in_ch, 4 * gate_rank, 1, bias=True)
        self.col_proj = nn.Conv1d(in_ch, 4 * gate_rank, 1, bias=True)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        r = self.gate_rank
        with torch.no_grad():
            self.row_proj.bias.copy_(_preset_block_bias(self.gate_init, r, 4 * r))
            self.col_proj.bias.copy_(_preset_block_bias(self.gate_init, r, 4 * r))

    def lowrank_params(self):
        """(wrow, brow, wcol, bcol) with kernels as (C, 4r) — the K2 layout."""
        return (self.row_proj.weight[:, :, 0].t(), self.row_proj.bias,
                self.col_proj.weight[:, :, 0].t(), self.col_proj.bias)


class EdgewiseMSA(nn.Module):
    """Mode E: edgewise-gated multi-view attention (lowrank gate head)."""

    def __init__(self, dim: int, heads: int = 4, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, beta_not: float = 0.5, use_k3: bool = False,
                 n_views: int = 2, share_qkv: bool = False, gate_mode: str = "dense",
                 gate_rank: int = 4, gate_init: str = "neutral",
                 use_lens_bank: bool = False, lens_kernel_size: int = 3,
                 lens_dilations: Optional[Tuple[int, ...]] = None,
                 use_lens_bank_qk: bool = False, lens_qk_kernel_size: int = 3,
                 lens_qk_dilations: Optional[Tuple[int, ...]] = None,
                 lens_qk_causal: bool = False):
        super().__init__()
        if use_lens_bank or use_lens_bank_qk:
            raise NotImplementedError("EdgewiseMSA: the lens banks are not ported yet")
        if attn_drop > 0.0:
            raise NotImplementedError("EdgewiseMSA: attention dropout is not ported yet")
        self.heads = heads
        self.beta_not = beta_not
        self.n_views = max(2, int(n_views))
        self.share_qkv = share_qkv
        nv, dk = self.n_views, dim // heads
        if share_qkv:
            self.qkv = Linear(dim, dim * 3, bias=False)
            self.q_scale = nn.Parameter(torch.empty(nv, heads, 1, dk))
            self.k_scale = nn.Parameter(torch.empty(nv, heads, 1, dk))
            self.v_scale = nn.Parameter(torch.empty(nv, heads, 1, dk))
        else:
            self.qkv_list = nn.ModuleList(Linear(dim, dim * 3, bias=False)
                                          for _ in range(nv))
        self.edge_head = EdgewiseGateHead(
            in_ch=2 * nv + 2, hidden=16, use_k3=use_k3, gate_mode=gate_mode,
            gate_rank=gate_rank, gate_init=gate_init)
        self.chain_value_logit = nn.Parameter(torch.empty(()))
        self.proj = Linear(dim, dim, bias=False)
        self.proj_drop = Dropout(proj_drop)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.chain_value_logit.fill_(-2.0)
            if self.share_qkv:
                for p in (self.q_scale, self.k_scale, self.v_scale):
                    p.fill_(1.0)

    def _views(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """Per-view q, k, v as (B, H, V, N, dk) views (no copies of the views)."""
        b, n, d = x.shape
        h, nv = self.heads, self.n_views
        if self.share_qkv:
            qb, kb, vb = _qkv(x, h, self.qkv)  # (B, H, N, dk)

            def per_view(t, s):  # t * s[i] for every view, stacked on axis 2
                return t.unsqueeze(2) * s.transpose(0, 1).unsqueeze(0)

            return (per_view(qb, self.q_scale), per_view(kb, self.k_scale),
                    per_view(vb, self.v_scale))
        # One product against the V stacked weights: every view's projection is
        # the same dot products as its own Linear, read back as strided views.
        w = torch.cat([lin.weight for lin in self.qkv_list], 0)
        y = torch.nn.functional.linear(x, w).reshape(b, n, nv, 3, h, d // h)
        q, k, v = y.permute(3, 0, 4, 2, 1, 5)  # each (B, H, V, N, dk)
        return q, k, v

    def forward(self, x: Tensor) -> Tensor:
        qs, ks, vs = self._views(x)
        wrow, brow, wcol, bcol = self.edge_head.lowrank_params()
        y = ops_fused.fused_edgewise_lowrank_attention(
            qs, ks, vs, wrow, brow, wcol, bcol, beta_not=self.beta_not,
            chain_w=torch.sigmoid(self.chain_value_logit))
        return self.proj_drop(self.proj(_merge_heads(y)))
