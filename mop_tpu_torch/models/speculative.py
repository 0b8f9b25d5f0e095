"""Speculative decoding for the GPT family, in PyTorch: the port of
``mop_tpu/models/speculative.py``.

A small draft model proposes ``gamma`` tokens a round from its own KV
cache; the target verifies them all in one cached chunk forward
(``decode_chunk``) and accepts a prefix plus one correction or bonus token:

- greedy (``temperature == 0`` or no generator): accept while the draft's
  token is the target's argmax. Every emitted token is the target's own
  argmax on the same prefix, so the output is ``generate_cached``'s and the
  draft changes only the speed.
- sampled: accept draft token d with probability ``min(1, p(d) / q(d))``;
  at the first rejection draw from the renormalized residual
  ``max(p - q, 0)``, and when all are accepted draw the bonus token from p:
  the emitted sequence is distributed as sampling the target alone.

The rounds loop on the host; each round's acceptance is read back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .generate import (_categorical, _filter_logits, _gumbel, decode_chunk, decode_params,
                       decode_step, prefill)

Tensor = torch.Tensor

__all__ = ["verify_sampled", "speculative_generate"]


def _verify_given(u: Tensor, gumbel: Tensor, p_all: Tensor, q: Tensor, d: Tensor):
    """``verify_sampled`` given its draws: ``u`` (g,) uniforms and ``gumbel``
    (V,) noise for the correction's categorical."""
    g = d.shape[0]
    idx = torch.arange(g, device=d.device)
    ratio = p_all[idx, d] / q[idx, d].clamp_min(1e-30)
    n_acc = int((u < ratio).to(torch.int32).cumprod(0).sum())
    p_n = p_all[n_acc]
    r = (p_n - (q[n_acc] if n_acc < g else torch.zeros_like(p_n))).clamp_min(0.0)
    rsum = r.sum()
    # p <= q everywhere only where p == q on the support: sample p itself.
    r = torch.where(rsum > 1e-30, r / rsum, p_n)
    return n_acc, _categorical(torch.log(r + 1e-30), gumbel)


def verify_sampled(generator: Optional[torch.Generator], p_all: Tensor, q: Tensor, d: Tensor):
    """Speculative sampling's accept / resample step.

    p_all: (g + 1, V) target probabilities at each draft position and the
    bonus one; q: (g, V) the draft's; d: (g,) draft tokens. Accepts d_i
    while ``u_i < p_i(d_i) / q_i(d_i)``; the correction comes from the
    renormalized ``max(p_n - q_n, 0)`` at the first rejection n (q := 0 at
    the bonus position). Returns (n_acc, correction token). Each emitted
    token's law is p: ``q(t) min(1, p(t)/q(t)) + P(reject) r(t) = p(t)``."""
    u = torch.rand(d.shape[0], generator=generator, device=d.device)
    return _verify_given(u, _gumbel(p_all.shape[-1:], generator, d.device), p_all, q, d)


def speculative_generate(target_model: nn.Module, target_params: Optional[dict],
                         draft_model: nn.Module, draft_params: Optional[dict], prompt: Tensor,
                         max_new_tokens: int, gamma: int = 4,
                         generator: Optional[torch.Generator] = None, temperature: float = 0.0,
                         top_k: Optional[int] = None, return_stats: bool = False,
                         kv_dtype: torch.dtype = torch.float32):
    """Speculative decode of a (1, T0) prompt: (1, T0 + max_new_tokens) ids.

    Greedy when ``temperature == 0`` or no ``generator`` is given (the
    tokens of ``generate_cached`` at the same ``kv_dtype``); otherwise
    speculative sampling at the temperature and ``top_k`` (both models'
    distributions filtered alike). Each round costs ``gamma`` draft steps
    (one more when all are accepted) and one target chunk over
    ``gamma + 1`` positions, and emits 1 to ``gamma + 1`` tokens. The chunk
    may write up to ``gamma`` rows past the final length, rolled back by
    ``len``: ``T0 + max_new_tokens + gamma`` must fit both models' block.
    ``return_stats`` adds ``{"rounds", "drafted", "accepted"}``. GPT-MoP
    models follow ``generate_cached``'s contract (exact with the causal
    gate, frontier-approximate with the centred one)."""
    b, t0 = prompt.shape
    if b != 1:
        raise ValueError(f"speculative_generate requires batch 1, got {b}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    for name, m in (("target", target_model), ("draft", draft_model)):
        if t0 + max_new_tokens + gamma > m.config.block_size:
            raise ValueError(f"T0 + max_new_tokens + gamma = {t0 + max_new_tokens + gamma} "
                             f"exceeds {name} block_size {m.config.block_size}")
    greedy = generator is None or temperature == 0.0
    tparams = decode_params(target_model) if target_params is None else target_params
    dparams = decode_params(draft_model) if draft_params is None else draft_params

    def dist(logits):  # (rows, V) -> the temperature / top-k filtered probabilities
        return torch.softmax(_filter_logits(logits, temperature, top_k, None, None), -1)

    def draw(probs):
        return _categorical(torch.log(probs + 1e-30), _gumbel(probs.shape, generator,
                                                              probs.device))

    prompt = prompt.long()
    logits0, tcache = prefill(target_model, tparams, prompt, kv_dtype=kv_dtype)
    _, dcache = prefill(draft_model, dparams, prompt, kv_dtype=kv_dtype)
    last = logits0.argmax(-1) if greedy else draw(dist(logits0))  # (1,)
    out = [last]
    n_out = 1
    rounds = accepted = 0
    while n_out < max_new_tokens:
        tlen, dlen = tcache["len"], dcache["len"]
        tok, drafts, qrows = last, [], []
        for _ in range(gamma):
            logits, dcache = decode_step(draft_model, dparams, dcache, tok)
            if greedy:
                tok = logits.argmax(-1)
            else:
                qrows.append(dist(logits)[0])
                tok = draw(qrows[-1][None])
            drafts.append(tok)
        d = torch.cat(drafts)  # (gamma,)
        # One target forward verifies every draft position at once.
        logits, tcache = decode_chunk(target_model, tparams, tcache, torch.cat([last, d])[None])
        if greedy:
            tpred = logits[0].argmax(-1)
            n_acc = int((tpred[:gamma] == d).to(torch.int32).cumprod(0).sum())
            corr = tpred[n_acc:n_acc + 1]
        else:
            n_acc, corr = verify_sampled(generator, dist(logits[0]), torch.stack(qrows), d)
            corr = corr.reshape(1)
        if n_acc == gamma:  # the last draft's rows were never written: feed it now
            dcache = decode_step(draft_model, dparams, dcache, drafts[-1])[1]
        out.extend([d[:n_acc], corr])
        n_out += n_acc + 1
        # Roll both caches back to the fed prefix [last, d_0 .. d_{n_acc - 1}].
        tcache = dict(tcache, len=tlen + n_acc + 1)
        dcache = dict(dcache, len=dlen + n_acc + 1)
        last = corr
        rounds += 1
        accepted += n_acc
    toks = torch.cat([prompt, torch.cat(out)[None, :max_new_tokens]], 1)
    if return_stats:
        return toks, {"rounds": rounds, "drafted": rounds * gamma, "accepted": accepted}
    return toks
