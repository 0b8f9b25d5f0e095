"""Evaluation metrics of the port: LM perplexity, WER / CER and top-k
accuracy, the counterpart of ``mop_tpu/utils/metrics.py``.

The NLL and top-k run on the model's device; WER and CER are host-side
dynamic programming over already-decoded outputs (``_edit_distance`` is
the JAX package's, copied).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor


# ------------------------------ perplexity ------------------------------

def _token_nll(model: nn.Module, tokens: Tensor) -> Tensor:
    """(B, T-1) next-token NLL of a GPT-family model, teacher-forced:
    positions 0..T-2 predict 1..T-1, in eval mode, fp32 log-softmax."""
    model.eval()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, _ = model(inp)
    logp = torch.log_softmax(logits.float(), -1)
    return -torch.gather(logp, -1, tgt[..., None].long())[..., 0]


def lm_nll(model: nn.Module, tokens: Tensor, mask: Tensor = None) -> Tensor:
    """Mean next-token negative log-likelihood (nats) of (B, T) int tokens.
    ``mask``: optional (B, T) validity mask (1 = real token); a target counts
    only where its position is valid. Differentiable; returns a scalar."""
    nll = _token_nll(model, tokens)
    if mask is None:
        return nll.mean()
    m = mask[:, 1:].to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


@torch.inference_mode()
def lm_perplexity(model: nn.Module, tokens, batch_size: int = 32, mask=None
                  ) -> Tuple[float, float]:
    """Corpus perplexity of (N, T) tokens, in batches of ``batch_size``.

    Returns ``(perplexity, mean_nll_nats)``. A trailing partial batch is
    padded by repetition and masked out of the average (an exact
    token-weighted mean), so every batch has one shape, as in the JAX
    function. The tokens go to the model's device."""
    device = next(model.parameters()).device
    tokens = torch.as_tensor(np.asarray(tokens), device=device).long()
    n = tokens.shape[0]
    if mask is None:
        mask = torch.ones(tokens.shape, device=device)
    mask = torch.as_tensor(np.asarray(mask), device=device, dtype=torch.float32)
    total, count = 0.0, 0.0
    for i in range(0, n, batch_size):
        tok, m = tokens[i:i + batch_size], mask[i:i + batch_size]
        if tok.shape[0] < batch_size:  # pad by repetition, zero the mask
            pad = batch_size - tok.shape[0]
            tok = torch.cat([tok, tok[:1].expand(pad, -1)], 0)
            m = torch.cat([m, m.new_zeros(pad, m.shape[1])], 0)
        mm = m[:, 1:]
        total += float((_token_nll(model, tok) * mm).sum())
        count += float(mm.sum())
    nll = total / max(count, 1.0)
    return math.exp(nll), nll


# ------------------------------ WER / CER ------------------------------

def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (substitution/insertion/deletion, unit costs),
    O(len(ref) * len(hyp)) with a two-row table."""
    nr, nh = len(ref), len(hyp)
    if nr == 0:
        return nh
    prev = np.arange(nh + 1)
    for i in range(1, nr + 1):
        cur = np.empty(nh + 1, np.int64)
        cur[0] = i
        for j in range(1, nh + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return int(prev[nh])


def wer(refs: Union[str, Sequence], hyps: Union[str, Sequence]) -> float:
    """Word error rate. Accepts a single pair or parallel lists; strings
    are split on whitespace, other sequences (e.g. token-id lists) are
    aligned as-is. Corpus WER = total edits / total reference length."""
    if isinstance(refs, str) or (refs and not isinstance(refs[0],
                                                         (list, str, tuple, np.ndarray))):
        refs, hyps = [refs], [hyps]
    edits, length = 0, 0
    for r, h in zip(refs, hyps):
        r = r.split() if isinstance(r, str) else list(r)
        h = h.split() if isinstance(h, str) else list(h)
        edits += _edit_distance(r, h)
        length += len(r)
    if length == 0:
        raise ValueError("wer: empty reference")
    return edits / length


def cer(refs: Union[str, List[str]], hyps: Union[str, List[str]]) -> float:
    """Character error rate over strings (whitespace counts as a char)."""
    if isinstance(refs, str):
        refs, hyps = [refs], [hyps]
    edits = sum(_edit_distance(list(r), list(h)) for r, h in zip(refs, hyps))
    length = sum(len(r) for r in refs)
    if length == 0:
        raise ValueError("cer: empty reference")
    return edits / length


# ------------------------------ top-k accuracy ------------------------------

def topk_accuracy(logits: Tensor, labels: Tensor, k: int = 1) -> Tensor:
    """Fraction of rows whose label is among the k highest logits, ties
    broken toward the lower index (``lax.top_k``'s order: a stable
    descending sort)."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
    hit = (idx == labels[:, None]).any(-1)
    return hit.float().mean()
