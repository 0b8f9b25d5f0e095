"""Attention variants A/B/C/D/E, in PyTorch.

The port of ``mop_tpu/models/attention_variants.py``:

- ``BaselineMSA`` (A/B): the flash-kernel ``MSA``; a mask composes.
- ``CrossViewMixerMSA`` (C): two views bound by a learnable 2x2 mixer, with
  transpose cues and the per-key prior (anchors ``fixed``,
  ``argmax_row_sum``, ``none``); composed, no kernel, as in JAX.
- ``MultiHopMSA`` (D): dual-path logits with the gated multi-hop chain and
  its value transport; its eval forward without a mask is the fused K4, its
  train forward (or a masked one) the composed path, as in JAX.
- ``EdgewiseMSA`` (E): the lowrank and dense gate heads (the dense one with
  its optional 3x3 mid conv, ``use_k3``), with and without ``share_qkv``
  and with the S-channel and Q/K lens banks.
- ``UnifiedMSA``: the A/B/C/D/E switch.

Parameter names follow the torch reference (``qkv_list.i``, ``qkv1``,
``qkv2``, ``mix``, ``chain_value_logit``, ``edge_head.row_proj`` as a 1x1
Conv1d, ``edge_head.conv1`` / ``mid3`` / ``conv2`` as Conv2d, ``q_lens.i``,
``lens_bank.i``).

``EdgewiseMSA`` picks its route from its configuration and its shapes: the
lowrank head runs the fused K2 (K2b backward) and the dense head without
``use_k3`` the fused K3 (K3b backward), in eval and in training, where
``ops.fused`` says their kernels take the shape; every other case
(``use_k3``, any lens bank, N above 64) runs the composed path of plain
ops, which is what the JAX package computes for it. ``MultiHopMSA`` (and
``DualPathMSA``) likewise runs K4 only where ``multihop_fits``. The
kernel switches of ``config.py`` (``fused_attention``,
``fused_edgewise_train``, ``fused_multihop``) send each to its composed path
when off, as the JAX flags do. Training with attention dropout, or an
``attn_mask``, sends ``EdgewiseMSA`` to its composed path too, which masks
every score map and the mixed logits and drops after the final softmax, as
in JAX. Every variant draws its attention dropout from the explicit
generator of ``Dropout``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import config as kernel_switches
from ..ops import attention as A
from ..ops import fused as ops_fused
from .components import MSA
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
        self.attn_drop = Dropout(attn_drop)
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

    def _composed(self, x: Tensor, qs: Tensor, ks: Tensor, vs: Tensor, w: Tensor,
                  attn_mask: Optional[Tensor] = None) -> Tensor:
        """The attention of the JAX module's composed path, (B, H, N, dk): the
        score maps masked by ``attn_mask`` (0 = masked), the feature stack
        [S_i, S_i^T, log c_fwd, log c_bwd (, lensed S)] in the compute dtype,
        the gate head, the gated mix, the masked softmax, attention dropout
        and the chained value transport."""
        b, h, nv, n, dk = qs.shape
        if self.use_lens_bank_qk:
            s_list = self._lens_scores(qs[:, :, 0], ks[:, :, 0])
        else:
            s_list = [A.scaled_scores(qs[:, :, i], ks[:, :, i]) for i in range(nv)]
        s_list = [A.apply_mask(s, attn_mask) for s in s_list]
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
        att = self.attn_drop(A.masked_softmax(smix, attn_mask))
        v1 = vs[:, :, 0]
        y = att.to(v1.dtype) @ v1
        # Value transport aligned with the constructed score maps.
        transport = vs[:, :, min(nv - 1, num_s - 1)]
        for i in range(num_s - 1, 0, -1):
            transport = a_list[i].to(transport.dtype) @ transport
        y_chain = a_list[0].to(transport.dtype) @ transport
        return y + w * y_chain

    def forward(self, x: Tensor, attn_mask: Optional[Tensor] = None) -> Tensor:
        qs, ks, vs = self._views(x)
        _, _, nv, n, dk = qs.shape
        # The kernel switches as the JAX module reads them (``config.py``); the
        # kernels have no mask and no attention-dropout site.
        fused = (kernel_switches.fused_attention and attn_mask is None
                 and not self.use_lens_bank and not self.use_lens_bank_qk
                 and (not self.training or (kernel_switches.fused_edgewise_train
                                            and self.attn_drop.p == 0.0)))
        w = torch.sigmoid(self.chain_value_logit)
        if (fused and self.gate_mode == "lowrank" and ops_fused.edgewise_lowrank_fits(
                qs.dtype, nv, n, dk, self.edge_head.gate_rank)):
            y = ops_fused.fused_edgewise_lowrank_attention(
                qs, ks, vs, *self.edge_head.lowrank_params(), beta_not=self.beta_not,
                chain_w=w)
        elif (fused and self.gate_mode == "dense" and not self.use_k3
              and ops_fused.edgewise_dense_fits(qs.dtype, nv, n, dk)):
            # In training too: on the H100 one layer's bf16 forward and backward
            # runs faster through K3 + K3b than composed (chip_smoke.py phase 9),
            # where the JAX package composes on a TPU timing.
            y = ops_fused.fused_edgewise_dense_attention(
                qs, ks, vs, *self.edge_head.dense_params(), beta_not=self.beta_not, chain_w=w)
        else:
            y = self._composed(x, qs, ks, vs, w, attn_mask)
        return self.proj_drop(self.proj(_merge_heads(y)))


class BaselineMSA(MSA):
    """Mode A/B: standard MSA through the flash kernel (K1); with an
    ``attn_mask`` (0 = masked) the composed masked softmax instead, as the
    JAX ``BaselineMSA``."""

    def forward(self, x: Tensor, attn_mask: Optional[Tensor] = None) -> Tensor:
        if attn_mask is None:
            return super().forward(x)
        q, k, v = _qkv(x, self.heads, self.qkv)
        att = self.attn_drop(A.masked_softmax(A.scaled_scores(q, k), attn_mask))
        y = att.to(v.dtype) @ v
        return self.proj_drop(self.proj(_merge_heads(y)))


class CrossViewMixerMSA(nn.Module):
    """Mode C: cross-view binding with a learnable 2x2 mixer over
    [S1, S1->2; S2->1, S2], transpose cues and an optional per-key prior
    sharpened by the anchor row k* of A2 (``fixed``: ``fixed_k_star``
    clamped to the sequence; ``argmax_row_sum``: the row of largest sum;
    anything else: row 0). Composed: the JAX package has no kernel for it."""

    def __init__(self, dim: int, heads: int = 4, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_transpose_cues: bool = True, t1: float = 0.0,
                 t2: float = 0.0, enable_per_key_prior: bool = False, prior_weight: float = 0.5,
                 anchor_mode: str = "argmax_row_sum", fixed_k_star: int = 0):
        super().__init__()
        self.heads = heads
        self.use_transpose_cues = use_transpose_cues
        self.t1, self.t2 = t1, t2
        self.enable_per_key_prior = enable_per_key_prior
        self.prior_weight = prior_weight
        self.anchor_mode = anchor_mode
        self.fixed_k_star = fixed_k_star
        self.qkv1 = Linear(dim, dim * 3, bias=False)
        self.qkv2 = Linear(dim, dim * 3, bias=False)
        self.mix = nn.Parameter(torch.empty(2, 2))
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim, bias=False)
        self.proj_drop = Dropout(proj_drop)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.mix.copy_(torch.eye(2))

    def _anchor(self, a2: Tensor) -> Tensor:
        """Row k* of A2 per (batch, head), as (B, H, 1, N)."""
        b, h, n, _ = a2.shape
        if self.anchor_mode == "fixed":
            k_star = torch.full((b, h), max(0, min(n - 1, self.fixed_k_star)), device=a2.device)
        elif self.anchor_mode == "argmax_row_sum":
            k_star = a2.sum(-1).argmax(-1)
        else:
            k_star = torch.zeros(b, h, dtype=torch.long, device=a2.device)
        return torch.gather(a2, 2, k_star[:, :, None, None].expand(b, h, 1, n))

    def forward(self, x: Tensor, attn_mask: Optional[Tensor] = None) -> Tensor:
        h = self.heads
        q1, k1, v1 = _qkv(x, h, self.qkv1)
        q2, k2, _ = _qkv(x, h, self.qkv2)
        s1, s2 = A.scaled_scores(q1, k1), A.scaled_scores(q2, k2)
        s12, s21 = A.scaled_scores(q1, k2), A.scaled_scores(q2, k1)
        mix = self.mix
        s = mix[0, 0] * s1 + mix[0, 1] * s12 + mix[1, 0] * s21 + mix[1, 1] * s2
        if self.use_transpose_cues:
            if self.t1 != 0.0:
                s = s + self.t1 * s1.transpose(-2, -1)
            if self.t2 != 0.0:
                s = s + self.t2 * s2.transpose(-2, -1)
        att = A.masked_softmax(s, attn_mask)
        if self.enable_per_key_prior and self.prior_weight > 0.0:
            a1 = A.masked_softmax(s1, attn_mask)
            a2 = A.masked_softmax(s2, attn_mask)
            a_sharp = a1 * self._anchor(a2)  # row k* of A2 broadcast over the queries
            a_sharp = a_sharp / (a_sharp.sum(-1, keepdim=True) + 1e-9)
            att = (1.0 - self.prior_weight) * att + self.prior_weight * a_sharp
        y = self.attn_drop(att).to(v1.dtype) @ v1
        return self.proj_drop(self.proj(_merge_heads(y)))


def _default_gates(gates: Optional[dict]) -> dict:
    return dict(gates) if gates else dict(and_=1.0, or_=0.0, not_=0.0, chain=0.0, base=1.0)


class MultiHopMSA(nn.Module):
    """Mode D: dual-path logits with gated multi-hop composition
    C = A1 A2^(hops-1) and the value transport along the chain,
    ``y = att v1 + sigmoid(chain_value_logit) A1 A2^(hops-1) v2``.

    The eval forward without a mask is the fused K4 with ``base`` forced to
    1 (the JAX module's choice) where K4 takes the shape; training, a mask or
    a shape outside K4's runs the composed path, whose mix
    (``multihop_logit_mix``) has no base term, as in JAX.
    """

    def __init__(self, dim: int, heads: int = 4, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, beta_not: float = 0.5,
                 gates: Optional[dict] = None, hops: int = 3):
        super().__init__()
        if hops < 2:
            raise ValueError(f"MultiHopMSA: hops={hops}, at least 2")
        self.heads = heads
        self.beta_not = beta_not
        self.gates = _default_gates(gates)
        self.hops = hops
        self.qkv1 = Linear(dim, dim * 3, bias=False)
        self.qkv2 = Linear(dim, dim * 3, bias=False)
        self.chain_value_logit = nn.Parameter(torch.empty(()))
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim, bias=False)
        self.proj_drop = Dropout(proj_drop)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.chain_value_logit.fill_(-2.0)

    def forward(self, x: Tensor, attn_mask: Optional[Tensor] = None) -> Tensor:
        h = self.heads
        q1, k1, v1 = _qkv(x, h, self.qkv1)
        q2, k2, v2 = _qkv(x, h, self.qkv2)
        w = torch.sigmoid(self.chain_value_logit)
        n, dk = q1.shape[-2:]
        if (kernel_switches.fused_multihop and attn_mask is None and not self.training
                and ops_fused.multihop_fits(n, dk, self.hops)):
            y = ops_fused.fused_multihop_attention(
                q1, k1, v1, q2, k2, v2, gates=self._kernel_gates(),
                beta_not=self.beta_not, hops=self.hops, chain_w=w)
        else:
            y = self._composed(q1, k1, v1, q2, k2, v2, w, attn_mask)
        return self.proj_drop(self.proj(_merge_heads(y)))

    def _kernel_gates(self) -> dict:
        return {**self.gates, "base": 1.0}

    def _composed(self, q1, k1, v1, q2, k2, v2, w, attn_mask):
        s1 = A.apply_mask(A.scaled_scores(q1, k1), attn_mask)
        s2 = A.apply_mask(A.scaled_scores(q2, k2), attn_mask)
        a1, a2 = torch.softmax(s1, -1), torch.softmax(s2, -1)
        c_fwd = A.chain_product([a1] + [a2] * (self.hops - 1))
        smix = A.multihop_logit_mix(s1, s2, c_fwd, self.gates, self.beta_not)
        att = self.attn_drop(A.masked_softmax(smix, attn_mask))
        transport = v2
        for _ in range(self.hops - 1):
            transport = a2.to(v2.dtype) @ transport
        return att.to(v1.dtype) @ v1 + w * (a1.to(v2.dtype) @ transport)


class UnifiedMSA(nn.Module):
    """The A/B/C/D/E switch: ``impl`` is the mode's module, built from the
    kwargs that mode reads (E's lens-bank kwargs included); every mode takes
    an ``attn_mask`` (0 = masked)."""

    def __init__(self, mode: str, dim: int, heads: int = 4, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, use_transpose_cues: bool = True, t1: float = 0.0,
                 t2: float = 0.0, enable_per_key_prior: bool = False, prior_weight: float = 0.5,
                 anchor_mode: str = "argmax_row_sum", fixed_k_star: int = 0,
                 beta_not: float = 0.5, gates: Optional[dict] = None, hops: int = 3,
                 use_k3: bool = False, n_views: int = 2, share_qkv: bool = False,
                 gate_mode: str = "dense", gate_rank: int = 4, gate_init: str = "neutral",
                 use_lens_bank: bool = False, lens_kernel_size: int = 3,
                 lens_dilations: Optional[Tuple[int, ...]] = None,
                 use_lens_bank_qk: bool = False, lens_qk_kernel_size: int = 3,
                 lens_qk_dilations: Optional[Tuple[int, ...]] = None,
                 lens_qk_causal: bool = False):
        super().__init__()
        mode = str(mode).upper()
        self.mode = mode
        if mode in ("A", "B"):
            self.impl = BaselineMSA(dim, heads, attn_drop, proj_drop)
        elif mode == "C":
            self.impl = CrossViewMixerMSA(
                dim, heads, attn_drop, proj_drop, use_transpose_cues=use_transpose_cues, t1=t1,
                t2=t2, enable_per_key_prior=enable_per_key_prior, prior_weight=prior_weight,
                anchor_mode=anchor_mode, fixed_k_star=fixed_k_star)
        elif mode == "D":
            self.impl = MultiHopMSA(dim, heads, attn_drop, proj_drop, beta_not=beta_not,
                                    gates=gates, hops=hops)
        elif mode == "E":
            self.impl = EdgewiseMSA(
                dim, heads, attn_drop, proj_drop, beta_not=beta_not, use_k3=use_k3,
                n_views=n_views, share_qkv=share_qkv, gate_mode=gate_mode, gate_rank=gate_rank,
                gate_init=gate_init, use_lens_bank=use_lens_bank,
                lens_kernel_size=lens_kernel_size, lens_dilations=lens_dilations,
                use_lens_bank_qk=use_lens_bank_qk, lens_qk_kernel_size=lens_qk_kernel_size,
                lens_qk_dilations=lens_qk_dilations, lens_qk_causal=lens_qk_causal)
        else:
            raise ValueError(f"Unknown attention mode: {mode}")

    def forward(self, x: Tensor, attn_mask: Optional[Tensor] = None) -> Tensor:
        if attn_mask is None:
            return self.impl(x)
        return self.impl(x, attn_mask)
