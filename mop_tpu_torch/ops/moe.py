"""Top-1 mixture-of-experts MLP: the reference-exact dense path and the routed
(capacity-bounded) path, in PyTorch — the port of ``mop_tpu/ops/moe.py``.

The dense path computes every expert for every token and keeps the chosen
one by a one-hot mix. The routed path scatters each token into its expert's
capacity buffer (static shapes), runs the experts as one batched (E, C, D) x
(E, D, H) product and gathers the outputs back: O(E * C * D * H) instead of
O(T * E * D * H), with C ~= T / E * capacity_factor. Tokens beyond their
expert's capacity come back as zeros (the usual MoE overflow); with a
capacity that holds the worst expert load the two paths agree.

Both are plain PyTorch ops: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

Tensor = torch.Tensor


def capacity(tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ``max(1, min(ceil(T / E * cf), T))``."""
    return max(1, min(int(math.ceil(tokens / num_experts * capacity_factor)), tokens))


def top1_dispatch(expert: Tensor, num_experts: int, capacity: int) -> Tuple[Tensor, Tensor]:
    """Dispatch indices for top-1 routing.

    expert: (T,) int, each token's expert. Returns (slot (T,) int64 in
    [0, E * C], where E * C is the overflow row, and keep (T,) bool): a
    token's slot is its expert's row block plus its rank among that
    expert's tokens, in token order. The ranks are a running sum along each
    expert's row of the (E, T) one-hot, whose token axis is the contiguous
    one (a scan along the outer axis of a (T, E) one-hot runs E threads).
    """
    onehot = _one_hot_rows(expert.long(), num_experts).long()  # (E, T)
    pos_tok = ((onehot.cumsum(1) - 1) * onehot).sum(0)  # rank within its expert
    keep = pos_tok < capacity
    slot = expert.long() * capacity + pos_tok.clamp(max=capacity - 1)
    return torch.where(keep, slot, torch.full_like(slot, num_experts * capacity)), keep


def _one_hot_rows(index: Tensor, n: int) -> Tensor:
    """(n, T) bool: row e marks the tokens whose ``index`` is e (no host
    round trip, unlike ``F.one_hot``'s range check)."""
    return index[None, :] == torch.arange(n, device=index.device)[:, None]


class _Top1(torch.autograd.Function):
    """``one_hot(argmax(logits))`` in the logits' dtype, the first index on
    ties, with the zero derivative JAX gives it: the gate's parameters get
    zero grads (and weight decay) rather than none."""

    @staticmethod
    def forward(ctx, logits: Tensor) -> Tensor:
        return _one_hot_rows(logits.argmax(-1), logits.shape[-1]).t().to(logits.dtype)

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        return torch.zeros_like(grad)


def top1_routed_mlp(x: Tensor, gate_w: Tensor, gate_b: Tensor, w1: Tensor, w2: Tensor,
                    act: Callable[[Tensor], Tensor], capacity_factor: float = 1.25) -> Tensor:
    """Token-level top-1 MoE MLP with routed dispatch.

    x: (T, D); gate_w: (D, E); gate_b: (E,); w1: (E, D, H); w2: (E, H, D).
    Each batched product accumulates in fp32 and is rounded once to
    ``x.dtype`` (what ``torch.bmm`` does in bf16, and the JAX op's
    ``preferred_element_type=float32`` followed by its cast): before ``act``
    and after the second product.
    """
    t, d = x.shape
    e = w1.shape[0]
    c = capacity(t, e, capacity_factor)
    gate = _Top1.apply(x @ gate_w + gate_b)  # (T, E)
    slot, keep = top1_dispatch(gate.argmax(-1), e, c)
    # Scatter into (E * C + 1, D): the last row takes every overflow token and
    # is dropped, so those duplicate writes reach neither the experts nor,
    # since its cotangent is zero, the grads of x.
    buf = x.new_zeros(e * c + 1, d).index_put((slot,), x)[: e * c].reshape(e, c, d)
    y = torch.bmm(act(torch.bmm(buf, w1)), w2).reshape(e * c, d)
    # Combine: each token's slot; dropped tokens read the zero row. The chosen
    # expert's one-hot weight (1) carries the gate's zero derivative.
    out = torch.cat([y, y.new_zeros(1, d)])[slot]
    return out * (gate * keep[:, None].to(x.dtype)).sum(-1, keepdim=True)


def dense_top1_mlp(x: Tensor, gate_w: Tensor, gate_b: Tensor, w1: Tensor, w2: Tensor,
                   act: Callable[[Tensor], Tensor]) -> Tensor:
    """Reference-exact path: every expert on every token, mixed by the
    one-hot of the gate's argmax; the einsums run in ``x.dtype``."""
    one_hot = _Top1.apply(x @ gate_w + gate_b)
    h = act(torch.einsum("td,edh->teh", x, w1))
    y = torch.einsum("teh,ehd->ted", h, w2)
    return torch.einsum("ted,te->td", y, one_hot)
