"""Edgewise-gated attention (mode E), in PyTorch.

The port of the E-mode part of ``mop_tpu/models/attention_variants.py``: the
lowrank and dense gate heads (the dense one with its optional 3x3 mid conv,
``use_k3``) and ``EdgewiseMSA`` with and without ``share_qkv`` and with the
S-channel and Q/K lens banks. Parameter names follow the torch reference
(``qkv_list.i``, ``edge_head.row_proj`` as a 1x1 Conv1d, ``edge_head.conv1``
/ ``mid3`` / ``conv2`` as Conv2d, ``q_lens.i``, ``lens_bank.i``).

``EdgewiseMSA`` picks its route as the JAX module's ``fused_ok`` does, from
its configuration and its mode alone: the lowrank head runs the fused K2
(K2b backward), the dense head without ``use_k3`` runs the fused K3 (K3b
backward) in eval mode, and every other case (dense in training, ``use_k3``,
any lens bank) the composed path of plain ops, which is what the JAX package
computes for it. Attention dropout is not ported and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as A
from ..ops import fused as ops_fused
from .layers import Dropout, Linear, gelu_tanh

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
    """Per-edge gate head over the stacked score features.

    ``forward`` takes the feature stack as NCHW (B*H, C, N, N) and returns the
    gates (B*H, 4, N, N) in [0, 1], channel order (and, or, not, chain).
    Dense: 1x1 conv C -> hidden, tanh GELU, under ``use_k3`` a second GELU
    and the 3x3 conv ``mid3``, then the 1x1 conv hidden -> 4 and a sigmoid.
    Any other ``gate_mode`` is lowrank: row / column mean-pooled features ->
    rank-r factors per gate.
    """

    def __init__(self, in_ch: int, hidden: int = 16, use_k3: bool = False,
                 gate_mode: str = "dense", gate_rank: int = 4, gate_init: str = "neutral"):
        super().__init__()
        self.dense = gate_mode == "dense"
        self.use_k3 = use_k3 and self.dense
        self.gate_rank = gate_rank
        self.gate_init = gate_init
        if self.dense:
            self.conv1 = nn.Conv2d(in_ch, hidden, 1)
            if self.use_k3:
                self.mid3 = nn.Conv2d(hidden, hidden, 3, padding=1)
            self.conv2 = nn.Conv2d(hidden, 4, 1)
        else:
            self.row_proj = nn.Conv1d(in_ch, 4 * gate_rank, 1, bias=True)
            self.col_proj = nn.Conv1d(in_ch, 4 * gate_rank, 1, bias=True)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        r = self.gate_rank
        with torch.no_grad():
            if self.dense:
                self.conv2.bias.copy_(_dense_head_bias(self.gate_init))
            else:
                self.row_proj.bias.copy_(_preset_block_bias(self.gate_init, r, 4 * r))
                self.col_proj.bias.copy_(_preset_block_bias(self.gate_init, r, 4 * r))

    def lowrank_params(self):
        """(wrow, brow, wcol, bcol) with kernels as (C, 4r) — the K2 layout."""
        return (self.row_proj.weight[:, :, 0].t(), self.row_proj.bias,
                self.col_proj.weight[:, :, 0].t(), self.col_proj.bias)

    def dense_params(self):
        """(w1, b1, w2, b2): the 1x1 convs as (C, hidden) and (hidden, 4)
        matmul kernels with their biases — the K3 layout."""
        return (self.conv1.weight[:, :, 0, 0].t(), self.conv1.bias,
                self.conv2.weight[:, :, 0, 0].t(), self.conv2.bias)

    def forward(self, feat: Tensor) -> Tensor:
        if self.dense:
            x = gelu_tanh(self.conv1(feat))
            if self.use_k3:
                x = self.mid3(gelu_tanh(x))
            return torch.sigmoid(self.conv2(x))
        r = self.gate_rank
        bh, _, n, _ = feat.shape
        a = self.row_proj(feat.mean(3)).reshape(bh, 4, r, n)  # mean over keys j
        b = self.col_proj(feat.mean(2)).reshape(bh, 4, r, n)  # mean over queries i
        return torch.sigmoid(torch.einsum("bcri,bcrj->bcij", a, b))


class EdgewiseMSA(nn.Module):
    """Mode E: edgewise-gated multi-view attention."""

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
        if attn_drop > 0.0:
            raise NotImplementedError("EdgewiseMSA: attention dropout is not ported yet")
        if use_lens_bank_qk and not share_qkv:
            raise ValueError("use_lens_bank_qk=True requires share_qkv=True for now")
        self.heads = heads
        self.beta_not = beta_not
        self.n_views = max(2, int(n_views))
        self.share_qkv = share_qkv
        self.gate_mode = gate_mode
        self.use_k3 = use_k3
        self.use_lens_bank = use_lens_bank
        self.use_lens_bank_qk = use_lens_bank_qk
        self.lens_qk_kernel_size = lens_qk_kernel_size
        self.lens_qk_causal = lens_qk_causal
        self.lens_qk_dilations = tuple(lens_qk_dilations) if lens_qk_dilations else (1, 2)
        lens_dil = tuple(lens_dilations) if lens_dilations else (1, 2)
        nv, dk = self.n_views, dim // heads
        if share_qkv:
            self.qkv = Linear(dim, dim * 3, bias=False)
            self.q_scale = nn.Parameter(torch.empty(nv, heads, 1, dk))
            self.k_scale = nn.Parameter(torch.empty(nv, heads, 1, dk))
            self.v_scale = nn.Parameter(torch.empty(nv, heads, 1, dk))
        else:
            self.qkv_list = nn.ModuleList(Linear(dim, dim * 3, bias=False)
                                          for _ in range(nv))
        # Score maps the head sees: one per view, or one per Q/K lens dilation.
        num_s = len(self.lens_qk_dilations) if use_lens_bank_qk else nv
        if use_lens_bank_qk:
            def lens():
                return nn.ModuleList(
                    nn.Conv1d(dk, dk, lens_qk_kernel_size, dilation=d, groups=dk, bias=False)
                    for d in self.lens_qk_dilations)
            self.q_lens, self.k_lens = lens(), lens()
        if use_lens_bank:
            self.lens_bank = nn.ModuleList(
                nn.Conv2d(num_s, num_s, lens_kernel_size, padding=d, dilation=d, groups=num_s,
                          bias=False)
                for d in lens_dil)
        in_ch = 2 * num_s + 2 + (num_s * len(lens_dil) if use_lens_bank else 0)
        self.edge_head = EdgewiseGateHead(
            in_ch=in_ch, hidden=16, use_k3=use_k3, gate_mode=gate_mode,
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

    def _lens_scores(self, q0: Tensor, k0: Tensor):
        """Score maps of the Q/K lens bank from view 0's q and k (B, H, N, dk).

        As the reference, (B, H, N, dk) is flattened to (B*H, dk, N) by a raw
        reshape, not a transpose, so the depthwise conv runs along an axis that
        interleaves tokens and features; the result is viewed back as
        (B, H, dk, N) and transposed."""
        b, h, n, dk = q0.shape
        ksz = self.lens_qk_kernel_size
        q_scr, k_scr = q0.reshape(b * h, dk, n), k0.reshape(b * h, dk, n)
        s_list = []
        for q_lens, k_lens, dil in zip(self.q_lens, self.k_lens, self.lens_qk_dilations):
            if self.lens_qk_causal:
                pad = ((ksz - 1) * dil, 0)
            else:
                pad = (dil * (ksz - 1) // 2,) * 2
            q_l = q_lens(F.pad(q_scr, pad)).reshape(b, h, dk, n).transpose(-1, -2)
            k_l = k_lens(F.pad(k_scr, pad)).reshape(b, h, dk, n).transpose(-1, -2)
            s_list.append(A.scaled_scores(q_l, k_l))
        return s_list

    def _composed(self, x: Tensor, qs: Tensor, ks: Tensor, vs: Tensor, w: Tensor) -> Tensor:
        """The attention of the JAX module's composed path, (B, H, N, dk): the
        feature stack [S_i, S_i^T, log c_fwd, log c_bwd (, lensed S)] in the
        compute dtype, the gate head, the gated mix, the softmax and the
        chained value transport."""
        b, h, nv, n, dk = qs.shape
        if self.use_lens_bank_qk:
            s_list = self._lens_scores(qs[:, :, 0], ks[:, :, 0])
        else:
            s_list = [A.scaled_scores(qs[:, :, i], ks[:, :, i]) for i in range(nv)]
        a_list = [torch.softmax(s, -1) for s in s_list]
        num_s = len(s_list)
        eps = 1e-6
        s_imgs = [s.reshape(b * h, n, n) for s in s_list]
        cr_img = torch.log(A.chain_product(a_list) + eps).reshape(b * h, n, n)
        cl_img = torch.log(A.chain_product(a_list[::-1]) + eps).reshape(b * h, n, n)
        feat_list = s_imgs + [s.transpose(1, 2) for s in s_imgs] + [cr_img, cl_img]
        if self.use_lens_bank:
            # Depthwise multi-dilation conv over the stacked score maps, in the
            # compute dtype (the conv's input and weights share one dtype).
            s_stack = torch.stack(s_imgs, 1).to(x.dtype)  # (BH, num_s, N, N)
            for lens in self.lens_bank:
                lensed = lens(s_stack)
                feat_list.extend(lensed[:, c] for c in range(num_s))
        gates = self.edge_head(torch.stack(feat_list, 1).to(x.dtype))  # (BH, 4, N, N)
        smix = A.edgewise_logit_mix(s_imgs, gates[:, 0], gates[:, 1], gates[:, 2], gates[:, 3],
                                    cr_img, self.beta_not).reshape(b, h, n, n)
        att = torch.softmax(smix, -1)
        v1 = vs[:, :, 0]
        y = att.to(v1.dtype) @ v1
        # Value transport aligned with the constructed score maps.
        transport = vs[:, :, min(nv - 1, num_s - 1)]
        for i in range(num_s - 1, 0, -1):
            transport = a_list[i].to(transport.dtype) @ transport
        y_chain = a_list[0].to(transport.dtype) @ transport
        return y + w * y_chain

    def forward(self, x: Tensor) -> Tensor:
        qs, ks, vs = self._views(x)
        fused = not self.use_lens_bank and not self.use_lens_bank_qk
        w = torch.sigmoid(self.chain_value_logit)
        if fused and self.gate_mode == "lowrank":
            y = ops_fused.fused_edgewise_lowrank_attention(
                qs, ks, vs, *self.edge_head.lowrank_params(), beta_not=self.beta_not,
                chain_w=w)
        elif fused and self.gate_mode == "dense" and not self.use_k3 and not self.training:
            # Eval only, as in the JAX package, whose train-time choice of the
            # composed path rests on a TPU timing (chip_smoke.py phase 9 times
            # both routes on the GPU).
            y = ops_fused.fused_edgewise_dense_attention(
                qs, ks, vs, *self.edge_head.dense_params(), beta_not=self.beta_not, chain_w=w)
        else:
            y = self._composed(x, qs, ks, vs, w)
        return self.proj_drop(self.proj(_merge_heads(y)))
