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
``cuda_graph=True`` runs each round as one CUDA graph (``_round_graphed``)
and reads back one scalar a round, the tokens emitted so far, for the
loop's exit; JAX's ``lax.while_loop`` reads none, and a loop on the device
would need conditional graph nodes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.cuda_graph import StepGraph, require_graph
from .generate import (_categorical, _filter_logits, _gumbel, decode_chunk, decode_chunk_rows,
                       decode_params, decode_split_of, decode_step, decode_step_rows, prefill)

Tensor = torch.Tensor

__all__ = ["verify_sampled", "speculative_generate"]


def _verify_on_device(u: Tensor, gumbel: Tensor, p_all: Tensor, q: Tensor, d: Tensor):
    """``verify_sampled`` given its draws (``u`` (g,) uniforms and ``gumbel``
    (V,) noise for the correction's categorical), with nothing read on the
    host: (n_acc, a 0-dim tensor; the correction token, a 0-dim tensor)."""
    g = d.shape[0]
    idx = torch.arange(g, device=d.device)
    ratio = p_all[idx, d] / q[idx, d].clamp_min(1e-30)
    n_acc = (u < ratio).to(torch.int32).cumprod(0).sum()
    at = n_acc.reshape(1)
    p_n = p_all.index_select(0, at)[0]
    q_n = torch.cat([q, torch.zeros_like(q[:1])]).index_select(0, at)[0]  # q := 0 at the bonus
    r = (p_n - q_n).clamp_min(0.0)
    rsum = r.sum()
    # p <= q everywhere only where p == q on the support: sample p itself.
    r = torch.where(rsum > 1e-30, r / rsum, p_n)
    return n_acc, _categorical(torch.log(r + 1e-30), gumbel)


def _verify_given(u: Tensor, gumbel: Tensor, p_all: Tensor, q: Tensor, d: Tensor):
    """``_verify_on_device`` with the accepted count read back as an int."""
    n_acc, corr = _verify_on_device(u, gumbel, p_all, q, d)
    return int(n_acc), corr


def _uniform(n: int, generator: Optional[torch.Generator], device) -> Tensor:
    """The verify's (n,) uniforms in [0, 1) from ``generator``."""
    return torch.rand(n, generator=generator, device=device)


def verify_sampled(generator: Optional[torch.Generator], p_all: Tensor, q: Tensor, d: Tensor):
    """Speculative sampling's accept / resample step.

    p_all: (g + 1, V) target probabilities at each draft position and the
    bonus one; q: (g, V) the draft's; d: (g,) draft tokens. Accepts d_i
    while ``u_i < p_i(d_i) / q_i(d_i)``; the correction comes from the
    renormalized ``max(p_n - q_n, 0)`` at the first rejection n (q := 0 at
    the bonus position). Returns (n_acc, correction token). Each emitted
    token's law is p: ``q(t) min(1, p(t)/q(t)) + P(reject) r(t) = p(t)``."""
    u = _uniform(d.shape[0], generator, d.device)
    return _verify_given(u, _gumbel(p_all.shape[-1:], generator, d.device), p_all, q, d)


def speculative_generate(target_model: nn.Module, target_params: Optional[dict],
                         draft_model: nn.Module, draft_params: Optional[dict], prompt: Tensor,
                         max_new_tokens: int, gamma: int = 4,
                         generator: Optional[torch.Generator] = None, temperature: float = 0.0,
                         top_k: Optional[int] = None, return_stats: bool = False,
                         kv_dtype: torch.dtype = torch.float32, cuda_graph: bool = False):
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
    gate, frontier-approximate with the centred one).

    ``cuda_graph=True`` (CUDA models that are not tensor-parallel, else a
    ValueError): the prefills and the first token eager, then each round
    one CUDA graph (``_round_graphed``) with the sampled route's
    ``generator`` registered; the tokens and stats are the eager loop's."""
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
    if cuda_graph:
        for name, m, p in (("target", target_model, tparams), ("draft", draft_model, dparams)):
            require_graph(f"speculative_generate ({name})",
                          p["params"]["wte"]["embedding"].device,
                          tensor_parallel=decode_split_of(m))

    def dist(logits):  # (rows, V) -> the temperature / top-k filtered probabilities
        return torch.softmax(_filter_logits(logits, temperature, top_k, None, None), -1)

    def draw(probs):
        return _categorical(torch.log(probs + 1e-30), _gumbel(probs.shape, generator,
                                                              probs.device))

    prompt = prompt.long()
    logits0, tcache = prefill(target_model, tparams, prompt, kv_dtype=kv_dtype)
    _, dcache = prefill(draft_model, dparams, prompt, kv_dtype=kv_dtype)
    last = logits0.argmax(-1) if greedy else draw(dist(logits0))  # (1,)
    if cuda_graph:
        toks, rounds, accepted = _round_graphed(
            target_model, tparams, tcache, draft_model, dparams, dcache, last, max_new_tokens,
            gamma, None if greedy else generator, dist, draw)
        toks = torch.cat([prompt, toks[None]], 1)
        if return_stats:
            return toks, {"rounds": rounds, "drafted": rounds * gamma, "accepted": accepted}
        return toks
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


def _round_graphed(target_model: nn.Module, tparams: dict, tcache: dict, draft_model: nn.Module,
                   dparams: dict, dcache: dict, last: Tensor, max_new_tokens: int, gamma: int,
                   generator: Optional[torch.Generator], dist, draw):
    """The rounds after the first token, each one CUDA graph over static
    buffers: gamma draft steps, one more that feeds the last draft (every
    round: where a draft is rejected its row lies past the rolled-back
    length and the next round overwrites it before reading it), the target's
    verify chunk, the accepted count and the correction, the emitted tokens
    written into a static buffer at the device offset ``n_out``, and both
    lengths advanced on the device. The host reads ``n_out`` once a round.
    Returns the (max_new_tokens,) tokens, the rounds and the drafts
    accepted."""
    dev = last.device
    g = gamma
    tlen = torch.full((), tcache["len"], dtype=torch.long, device=dev)
    dlen = torch.full((), dcache["len"], dtype=torch.long, device=dev)
    width = max_new_tokens + g + 1
    out = torch.zeros(width, dtype=torch.long, device=dev)
    out[:1] = last
    n_out = torch.ones((), dtype=torch.long, device=dev)
    accepted = torch.zeros((), dtype=torch.long, device=dev)
    last = last.clone()
    cols = torch.arange(width, device=dev)
    steps = torch.arange(g + 1, device=dev)

    def body():
        tok, drafts, qrows = last, [], []
        for j in range(g):
            logits = decode_step_rows(draft_model, dparams, dcache, tok, dlen + j)[0]
            if generator is None:
                tok = logits.argmax(-1)
            else:
                qrows.append(dist(logits)[0])
                tok = draw(qrows[-1][None])
            drafts.append(tok)
        decode_step_rows(draft_model, dparams, dcache, tok, dlen + g)
        d = torch.cat(drafts)  # (gamma,)
        logits = decode_chunk_rows(target_model, tparams, tcache, torch.cat([last, d])[None],
                                   tlen)[0]
        if generator is None:
            tpred = logits[0].argmax(-1)
            n_acc = (tpred[:g] == d).to(torch.int32).cumprod(0).sum()
            corr = tpred.index_select(0, n_acc.reshape(1))
        else:
            u = _uniform(g, generator, dev)
            n_acc, corr = _verify_on_device(u, _gumbel(logits.shape[-1:], generator, dev),
                                            dist(logits[0]), torch.stack(qrows), d)
            corr = corr.reshape(1)
        emitted = torch.where(steps < n_acc, torch.cat([d, d[-1:]]), corr)  # (gamma + 1,)
        at = cols - n_out
        put = (at >= 0) & (at <= n_acc)
        out.copy_(torch.where(put, emitted.index_select(0, at.clamp(0, g)), out))
        n_out.add_(n_acc + 1)
        accepted.add_(n_acc)
        tlen.add_(n_acc + 1)
        dlen.add_(n_acc + 1)
        last.copy_(corr)

    graph = StepGraph(body, dev, (generator,))
    rounds, emitted_so_far = 0, 1
    while emitted_so_far < max_new_tokens:
        graph()
        rounds += 1
        emitted_so_far = int(n_out)
    return out[:max_new_tokens], rounds, int(accepted)
