"""The collectives the parallel modes are made of, over ``torch.distributed``.

Each takes the process group of one mesh axis; a ``None`` group is a world-1
axis with no group, where every one of them is the identity and nothing is
sent. The autograd ones are the Megatron pairs: what one does forward, its
transpose does backward.

- ``copy_to``: identity forward, all-reduce (sum) of the gradient backward:
  the input of a region whose ranks each compute part of the result from
  the same replicated tensor.
- ``reduce_from``: all-reduce (sum) forward, identity backward: the partial
  sums of a row-parallel product.
- ``gather_dim``: all-gather along a dimension forward; backward the
  reduce-scatter of the gradient (``grad="sum"``, the region after it is
  tensor-parallel) or this rank's slice of it (``grad="slice"``, the region
  after it is replicated and every rank holds the same gradient).
- ``reduce_scatter_dim``: reduce-scatter along a dimension forward,
  all-gather backward.
- ``split_dim``: this rank's slice forward, all-gather backward.
- ``all_to_all``: ``all_to_all_single`` over equal chunks of dim 0, forward
  and backward (the inverse of an equal-split exchange is the same exchange).
- ``ring_shift``: send to the next rank of the group and receive from the
  previous one, one ``batch_isend_irecv``.
- ``exchange``: the sends and receives of one pipeline tick with the
  neighbouring ranks, one ``batch_isend_irecv``.

Every call goes through ``torch.distributed``'s functions, so
``utils.collectives.record_collectives`` sees each of them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    """In-place all-reduce of ``t`` over ``group`` (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_flat_(tensors: Sequence[Tensor], group, scale: float = 1.0) -> None:
    """All-reduce (sum) the tensors in place as one flat buffer per dtype, then
    scale them: one collective per dtype instead of one per tensor."""
    if group is None:
        if scale != 1.0:
            for t in tensors:
                t.mul_(scale)
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if scale != 1.0:
            flat.mul_(scale)
        parts = flat.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [p.view_as(t) for p, t in zip(parts, ts)])


def broadcast_(t: Tensor, group=None, src: int = 0) -> Tensor:
    """In place: ``t`` from global rank ``src`` to every rank of ``group``."""
    if dist.is_initialized():
        dist.broadcast(t, src=src, group=group)
    return t


def _gather(x: Tensor, dim: int, group) -> Tensor:
    w = group_size(group)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((w * front.shape[0],) + tuple(front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: Tensor, dim: int, group) -> Tensor:
    w = group_size(group)
    if x.shape[dim] % w:
        raise ValueError(f"reduce-scatter: dim {dim} of {tuple(x.shape)} does not divide by {w}")
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // w,) + tuple(front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _slice(x: Tensor, dim: int, group) -> Tensor:
    w, r = group_size(group), group_rank(group)
    if x.shape[dim] % w:
        raise ValueError(f"split: dim {dim} of {tuple(x.shape)} does not divide by {w}")
    n = x.shape[dim] // w
    return x.narrow(dim, r * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _slice(g, ctx.dim, ctx.group), None, None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def copy_to(x: Tensor, group) -> Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: Tensor, group) -> Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_dim(x: Tensor, dim: int, group, grad: str = "sum") -> Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(f"gather_dim: grad {grad!r}")
    return x if group is None else _GatherDim.apply(x, dim % x.dim(), group, grad)


def reduce_scatter_dim(x: Tensor, dim: int, group) -> Tensor:
    return x if group is None else _ReduceScatterDim.apply(x, dim % x.dim(), group)


def split_dim(x: Tensor, dim: int, group) -> Tensor:
    return x if group is None else _SplitDim.apply(x, dim % x.dim(), group)


def all_to_all(x: Tensor, group) -> Tensor:
    """``all_to_all_single``: chunk i of dim 0 goes to rank i of ``group``, and
    chunk i of the result came from rank i."""
    return x if group is None else _AllToAll.apply(x, group)


def ring_shift(tensors: List[Tensor], group, step: int = 1) -> List[Tensor]:
    """Each tensor sent to the rank ``step`` after this one on ``group``'s ring,
    and the one from the rank ``step`` before it received in its place."""
    w = group_size(group)
    if w == 1:
        return list(tensors)
    r = group_rank(group)
    nxt = dist.get_global_rank(group, (r + step) % w)
    prv = dist.get_global_rank(group, (r - step) % w)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def exchange(group, sends: Sequence, recvs: Sequence) -> List[Tensor]:
    """One ``batch_isend_irecv`` over ``group``: each ``(tensor, rank)`` of
    ``sends`` sent to that group rank, and for each ``(like, rank)`` of
    ``recvs`` a tensor shaped like ``like`` received from it (returned in
    order). Every rank of a pair posts the matching half in the same call,
    so no rank waits on a neighbour's compute."""
    outs = [torch.empty_like(like, memory_format=torch.contiguous_format) for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, r), group)
           for t, r in sends]
    ops += [dist.P2POp(dist.irecv, o, dist.get_global_rank(group, r), group)
            for o, (_, r) in zip(outs, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs
