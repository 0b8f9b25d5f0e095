"""Functional attention-score algebra — the mathematical core of MoP, in PyTorch.

The port of ``mop_tpu/ops/attention.py``, function for function:

- masked softmax with -inf re-masking before every softmax
- pairwise / stacked logsumexp (the OR operation in score space)
- chained attention products ``A_1 @ A_2 @ ... @ A_M`` (the CHAIN operation)
- the D-mode (MultiHop) and E-mode (Edgewise) logit mixers

These are the reference semantics the kernels in ``mop_tpu_torch.ops.fused``
reproduce; their plain versions build on them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

Tensor = torch.Tensor

NEG_INF = float("-inf")


def apply_mask(scores: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Set score entries to -inf where ``mask == 0``; ``mask`` broadcasts."""
    if mask is None:
        return scores
    return torch.where(mask == 0, torch.full_like(scores, NEG_INF), scores)


def masked_softmax(scores: Tensor, mask: Optional[Tensor] = None, dim: int = -1) -> Tensor:
    """Softmax with optional -inf masking applied first."""
    return torch.softmax(apply_mask(scores, mask), dim=dim)


def scaled_scores(q: Tensor, k: Tensor) -> Tensor:
    """``S = q @ k^T / sqrt(dk)`` over trailing (..., N, dk) axes, in fp32."""
    dk = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return s * (1.0 / math.sqrt(dk))


def lse_pair(a: Tensor, b: Tensor) -> Tensor:
    """Elementwise log(exp(a)+exp(b)) — score-space OR."""
    return torch.logaddexp(a, b)


def lse_stack(scores: Sequence[Tensor]) -> Tensor:
    """Elementwise logsumexp over a list of score maps."""
    return torch.logsumexp(torch.stack(list(scores), dim=0), dim=0)


def chain_product(attn_list: Sequence[Tensor]) -> Tensor:
    """``A_1 @ A_2 @ ... @ A_M`` — multi-hop transition composition, in fp32."""
    c = attn_list[0]
    for a in attn_list[1:]:
        c = torch.matmul(c.float(), a.float())
    return c


def multihop_logit_mix(
    s1: Tensor,
    s2: Tensor,
    c_fwd: Tensor,
    gates: dict,
    beta_not: float,
    eps: float = 1e-6,
) -> Tensor:
    """D-mode logit algebra.

    ``Smix = S1 + g_and*S2 + g_or*(LSE(S1,S2)-S1) - g_not*beta*S2
             + g_chain*log(C_fwd+eps)``
    """
    smix = s1
    smix = smix + gates.get("and_", 1.0) * s2
    smix = smix + gates.get("or_", 0.0) * (lse_pair(s1, s2) - s1)
    smix = smix - gates.get("not_", 0.0) * (beta_not * s2)
    smix = smix + gates.get("chain", 0.0) * torch.log(c_fwd + eps)
    return smix


def edgewise_logit_mix(
    s_list: Sequence[Tensor],
    g_and: Tensor,
    g_or: Tensor,
    g_not: Tensor,
    g_chain: Tensor,
    log_c_fwd: Tensor,
    beta_not: float,
) -> Tensor:
    """E-mode per-edge gated logit algebra; ``g_*`` are per-edge gates in [0,1]."""
    s1 = s_list[0]
    num_s = len(s_list)
    s_sum = s1
    for s in s_list[1:]:
        s_sum = s_sum + s
    lse_all = lse_stack(list(s_list))
    s_mean_others = (s_sum - s1) / max(1, num_s - 1)
    smix = s1
    smix = smix + g_and * (s_sum - s1)
    smix = smix + g_or * (lse_all - s1)
    smix = smix - g_not * (beta_not * s_mean_others)
    smix = smix + g_chain * log_c_fwd
    return smix


def standardize_scores(scores: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-row standardization with the *unbiased* (N-1) std, eps after the sqrt."""
    mu = scores.mean(-1, keepdim=True)
    n = scores.shape[-1]
    var = (scores - mu).square().sum(-1, keepdim=True) / max(1, n - 1)
    sigma = torch.sqrt(var)
    return (scores - mu) / (sigma + eps)


def standardize_scores_causal(scores: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-row standardization over each row's causal prefix (columns <= row)
    with the unbiased std.

    Row 0's prefix is one element, so its variance is exactly 0 and the sqrt
    has an infinite derivative there: the sqrt takes a clamped argument and
    the output is 0 on such rows (the forward is unchanged, grads stay finite).
    """
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device)
    rows = idx[:, None]
    live = idx[None, :] <= rows
    cnt = (rows + 1).to(torch.float32)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    mu = torch.where(live, scores, zero).sum(-1, keepdim=True) / cnt
    var = (torch.where(live, (scores - mu).square(), zero).sum(-1, keepdim=True)
           / torch.clamp(cnt - 1.0, min=1.0))
    pos = var > 0.0
    sigma = torch.sqrt(torch.where(pos, var, torch.ones_like(var)))
    return torch.where(pos, (scores - mu) / (sigma + eps), zero)


def attend(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Plain scaled-dot-product attention over (..., N, dk); softmax in fp32."""
    s = scaled_scores(q, k)
    a = masked_softmax(s, mask)
    return torch.matmul(a.to(v.dtype).float(), v.float()).to(v.dtype)


def causal_mask(n: int, dtype=torch.bool, device=None) -> Tensor:
    """Lower-triangular (1,1,N,N) causal mask."""
    return torch.ones(n, n, dtype=dtype, device=device).tril()[None, None]
