"""Ring attention: context parallelism over a mesh axis — the port of
``mop_tpu/ops/ring_attention.py``.

Each process holds a (B, H, N / S, dk) block of the sequence's queries,
keys and values. The key / value blocks go round the ring (point to point,
``batch_isend_irecv``) while each process folds the visiting block into a
running flash-style fp32 (output, max, denominator) accumulator: S - 1 hops,
and no process ever holds the whole N x N scores. The causal mask is by
global position; a row that a block masks whole keeps m = -inf and adds
nothing (the guards of the JAX ``_ring_body``).

P2P sends are not differentiable, so the backward is written out
(``_Ring``): it recomputes each block's probabilities from the saved
log-sum-exp and sends the key / value blocks round the ring again, with the
gradients of each block travelling beside it and one more hop taking them
home. The JAX function is plain XLA; this is plain PyTorch — no kernel.

``ring_attention`` takes this process's blocks; ``shard_sequence`` cuts a
whole sequence into them (raising where N does not divide by the ring),
``gather_sequence`` puts the outputs back together.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel import comm

Tensor = torch.Tensor


def _scores(q, k, scale, q_pos, kv_pos, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~(q_pos[:, None] >= kv_pos[None, :]), float("-inf"))
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        s_size, my = comm.group_size(group), comm.group_rank(group)
        b, h, nl, dk = q.shape
        pos = torch.arange(nl, device=q.device)
        q_pos = my * nl + pos
        o = q.new_zeros((b, h, nl, v.shape[-1]), dtype=torch.float32)
        m = q.new_full((b, h, nl), float("-inf"), dtype=torch.float32)
        l = q.new_zeros((b, h, nl), dtype=torch.float32)
        k_cur, v_cur = k, v
        for step in range(s_size):
            # The block visiting at ``step`` started at shard (my - step) mod S.
            kv_pos = ((my - step) % s_size) * nl + pos
            s = _scores(q, k_cur, scale, q_pos, kv_pos, causal)
            new_m = torch.maximum(m, s.amax(-1))
            # exp(-inf - -inf) guards: a fully-masked row keeps m = -inf and
            # its scale factor is 0 there, not NaN.
            both_inf = torch.isneginf(m) & torch.isneginf(new_m)
            alpha = torch.where(both_inf, torch.zeros_like(m), torch.exp(m - new_m))
            p = torch.exp(s - new_m[..., None])
            p = torch.where(torch.isneginf(new_m)[..., None], torch.zeros_like(p), p)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v_cur.dtype).float(), v_cur.float())
            m = new_m
            if step < s_size - 1:
                k_cur, v_cur = comm.ring_shift([k_cur, v_cur], group)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)  # fully-masked rows -> 0
        out = (o / l_safe[..., None]).to(q.dtype)
        # log-sum-exp of each row; +inf where nothing was kept, so the
        # backward's probabilities there are exp(-inf) = 0.
        lse = torch.where(l == 0.0, torch.full_like(l, float("inf")), m + torch.log(l_safe))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        s_size, my = comm.group_size(group), comm.group_rank(group)
        nl = q.shape[2]
        pos = torch.arange(nl, device=q.device)
        q_pos = my * nl + pos
        do = d_out.float()
        delta = (do * out.float()).sum(-1)  # rowsum(dO * O)
        dq = torch.zeros_like(q, dtype=torch.float32)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros_like(k, dtype=torch.float32)
        dv_cur = torch.zeros_like(v, dtype=torch.float32)
        for step in range(s_size):
            kv_pos = ((my - step) % s_size) * nl + pos
            s = _scores(q, k_cur, scale, q_pos, kv_pos, causal)
            p = torch.exp(s - lse[..., None])
            dv_cur = dv_cur + torch.einsum("bhqk,bhqd->bhkd", p, do)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, v_cur.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_cur.float())
            dk_cur = dk_cur + torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
            if step < s_size - 1:
                k_cur, v_cur, dk_cur, dv_cur = comm.ring_shift([k_cur, v_cur, dk_cur, dv_cur],
                                                               group)
        # After S - 1 hops each process holds the gradients of the block that
        # started one place behind it; one more hop takes them home.
        dk_cur, dv_cur = comm.ring_shift([dk_cur, dv_cur], group)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None, None


def ring_attention(q: Tensor, k: Tensor, v: Tensor, mesh, axis: str = "model",
                   causal: bool = False, scale: Optional[float] = None,
                   manual_only: bool = False) -> Tensor:
    """Context-parallel attention over ``mesh``'s ``axis``. q / k / v: this
    process's (B, H, N / S, dk) blocks, block i of the sequence on the
    process with index i on the axis. Returns this process's block of the
    output, in q's dtype.

    ``manual_only`` is JAX's keyword, kept so that its callers run: there it
    makes the ``shard_map`` manual over ``axis`` alone, leaving the other
    mesh axes to GSPMD, which is how the ring composes inside a
    tensor-parallel block. Here it selects nothing: every op of the port is
    manual over its one axis, and the ring only ever talks to ``axis``'s
    group, so the heads a process holds (its share under tensor
    parallelism, over ``model``) and its batch rows (over ``data``) go
    through as they are."""
    del manual_only
    if not (q.shape[2] == k.shape[2] == v.shape[2]):
        raise ValueError(f"ring_attention: blocks of {q.shape[2]}, {k.shape[2]} and "
                         f"{v.shape[2]} tokens; every block has N / S")
    sc = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    return _Ring.apply(q, k, v, mesh.group(axis), causal, sc)


def shard_sequence(x: Tensor, mesh, axis: str = "model") -> Tensor:
    """This process's block of a whole (B, H, N, dk) sequence; N must divide
    by the axis size."""
    s_size, n = mesh.shape[axis], x.shape[2]
    if n % s_size:
        raise ValueError(f"ring_attention: sequence length {n} must divide by the "
                         f"'{axis}' mesh axis size {s_size}")
    nl = n // s_size
    return x[:, :, mesh.axis_index(axis) * nl:(mesh.axis_index(axis) + 1) * nl]


def gather_sequence(x: Tensor, mesh, axis: str = "model") -> Tensor:
    """The whole (B, H, N, dk) sequence from each process's block."""
    return comm.gather_dim(x, 2, mesh.group(axis), grad="slice")
