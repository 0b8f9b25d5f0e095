"""Beam search over the KV cache, in PyTorch: the port of
``mop_tpu/models/beam.py``, for the GPT family and Whisper-MoP.

Beams are batch rows (B * K, beam-major: row b * K + j is beam j of batch
row b); each step is one cached decode step over every beam, a top-K over
the K * V candidates, and a gather of the caches by parent beam. Scores are
cumulative token log-probabilities; a finished beam (it emitted ``eos_id``)
has one candidate, ``eos_id`` at score delta 0, so it competes unchanged
with live expansions. The final ranking divides by
``length ** length_penalty`` (the generated length, EOS included). Equal
scores rank the lower index first, as ``jax.lax.top_k`` does: the top-K is
a stable descending sort.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .generate import (_decoding, decode_params, decode_step, prefill, whisper_decode_prep,
                       whisper_decode_token)

Tensor = torch.Tensor

__all__ = ["generate_beam", "whisper_transcribe_beam"]


def _top_k(x: Tensor, k: int):
    """The k largest values along the last axis and their indices, the lower
    index first among equal values."""
    values, idx = x.sort(dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _beam_select(scores: Tensor, logp: Tensor, alive: Tensor, pad_tok: int):
    """Expand (B, K) beams by their (B, K, V) log-probs and keep the best K;
    a finished beam contributes ``pad_tok`` at delta 0 only. Returns
    (new scores (B, K), parent beam (B, K), new token (B, K))."""
    b, k, v = logp.shape
    fin = torch.full((v,), float("-inf"), device=logp.device)
    fin[pad_tok] = 0.0
    delta = torch.where(alive[:, :, None], logp, fin)
    new_scores, flat = _top_k((scores[:, :, None] + delta).reshape(b, k * v), k)
    return new_scores, flat // v, flat % v


def _repeat_cache(cache: dict, k: int) -> dict:
    """A B-row cache as B * K beam rows (each buffer repeated along its batch
    axis, axis 1)."""
    return {key: v if key == "len" else v.repeat_interleave(k, dim=1)
            for key, v in cache.items()}


def _gather_cache(cache: dict, rows: Tensor) -> dict:
    """The B * K cache rows reordered by the flat parent indices ``rows``."""
    return {key: v if key == "len" else v.index_select(1, rows) for key, v in cache.items()}


def _check_beams(k: int, vocab: int) -> None:
    if k < 1:
        raise ValueError(f"num_beams must be >= 1, got {k}")
    if k > vocab:
        raise ValueError(f"num_beams {k} exceeds vocab_size {vocab}: step 0 has only "
                         f"vocab_size distinct continuations")


def _search(first_logits: Tensor, step, n_tokens: int, k: int, eos_id: Optional[int],
            length_penalty: float):
    """The search both models share: K beams from the first logits (B, V),
    then ``n_tokens - 1`` steps of ``step(tokens (B * K,), i, parent_rows)``
    -> logits (B * K, V) (``parent_rows``: the flat rows the caller gathers
    its caches by before the step, None at the first). Returns the tokens
    (B, K, n_tokens) and final scores (B, K), best first."""
    b = first_logits.shape[0]
    dev = first_logits.device
    pad_tok = 0 if eos_id is None else int(eos_id)
    scores, tok = _top_k(torch.log_softmax(first_logits, -1), k)
    alive = torch.ones(b, k, dtype=torch.bool, device=dev) if eos_id is None else tok != eos_id
    lengths = torch.ones(b, k, dtype=torch.int32, device=dev)
    buf = torch.full((b, k, n_tokens), pad_tok, dtype=torch.long, device=dev)
    buf[:, :, 0] = tok
    batch_off = (torch.arange(b, device=dev) * k)[:, None]
    rows = torch.arange(b, device=dev)[:, None]
    parent_rows = None
    for i in range(1, n_tokens):
        logp = torch.log_softmax(step(tok.reshape(b * k), i, parent_rows), -1).reshape(b, k, -1)
        scores, parent, tok = _beam_select(scores, logp, alive, pad_tok)
        parent_rows = (batch_off + parent).reshape(b * k)
        p_alive = alive[rows, parent]
        lengths = lengths[rows, parent] + p_alive.to(torch.int32)
        buf = buf[rows, parent]
        buf[:, :, i] = torch.where(p_alive, tok, torch.full_like(tok, pad_tok))
        alive = p_alive if eos_id is None else p_alive & (tok != eos_id)
    final = scores / lengths.float().clamp_min(1.0) ** length_penalty
    order = torch.argsort(-final, dim=-1, stable=True)
    return buf[rows, order], final[rows, order]


def generate_beam(model: nn.Module, params: Optional[dict], prompt: Tensor,
                  max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                  eos_id: Optional[int] = None, kv_dtype: torch.dtype = torch.float32,
                  return_all: bool = False):
    """Beam search for a (B, T0) prompt: the best (B, T0 + max_new_tokens)
    sequence, or with ``return_all`` every beam (B, K, T0 + max_new_tokens)
    and its final score (B, K), best first.

    ``num_beams=1`` is greedy ``generate_cached``. Positions after an
    emitted ``eos_id`` hold ``eos_id``. The cache's semantics are
    ``generate_cached``'s; ``params`` and ``kv_dtype`` likewise."""
    cfg = model.config
    b, t0 = prompt.shape
    k = int(num_beams)
    _check_beams(k, model.wte.num_embeddings)
    if t0 + max_new_tokens > cfg.block_size:
        raise ValueError(f"generate_beam: t0 + max_new_tokens = {t0 + max_new_tokens} "
                         f"exceeds block_size {cfg.block_size}")
    params = decode_params(model) if params is None else params
    prompt = prompt.long()
    logits0, cache = prefill(model, params, prompt, kv_dtype=kv_dtype)
    state = {"cache": _repeat_cache(cache, k)}

    def step(tok, i, parent_rows):
        c = state["cache"]
        if parent_rows is not None:
            c = _gather_cache(c, parent_rows)
        logits, state["cache"] = decode_step(model, params, c, tok)
        return logits

    seqs, final = _search(logits0, step, max_new_tokens, k, eos_id, length_penalty)
    seqs = torch.cat([prompt[:, None, :].expand(b, k, t0), seqs], -1)
    return (seqs, final) if return_all else seqs[:, 0]


def whisper_transcribe_beam(model: nn.Module, mel: Tensor, bos_token: int, max_tokens: int,
                            num_beams: int = 4, length_penalty: float = 1.0,
                            eos_id: Optional[int] = None,
                            kv_dtype: torch.dtype = torch.float32, return_all: bool = False):
    """Beam-search transcription of a (B, T, n_mels) mel: the best
    (B, max_tokens) token stream, or with ``return_all`` every beam
    (B, K, max_tokens) and its final score (B, K), best first.

    Exact beam search (Whisper's KV cache is exact): ``num_beams=1`` gives
    greedy ``whisper_transcribe_cached``'s tokens. The encoder runs once
    (``whisper_decode_prep``: K1 in every encoder layer on the card); the
    cross-attention K/V are repeated across a row's beams and never
    gathered, the self-attention caches are gathered by parent beam each
    step. ``kv_dtype``: fp32 or bf16; int8 raises (its rows would need
    per-row scales)."""
    cfg = model.cfg
    b = mel.shape[0]
    k = int(num_beams)
    _check_beams(k, cfg.vocab_size)
    cross_k, cross_v = whisper_decode_prep(model, mel, kv_dtype)
    shape = (cfg.n_layer_dec, b, cfg.n_head, max_tokens + 1, cfg.n_embd // cfg.n_head)
    state = {"ks": torch.zeros(shape, dtype=kv_dtype, device=mel.device)}
    state["vs"] = torch.zeros_like(state["ks"])
    with _decoding(model):
        bos = torch.full((b,), bos_token, dtype=torch.long, device=mel.device)
        logits0 = whisper_decode_token(model, bos, 0, state["ks"], state["vs"],
                                       cross_k, cross_v)[0]
        state = {key: v.repeat_interleave(k, dim=1) for key, v in state.items()}
        cross_k, cross_v = (c.repeat_interleave(k, dim=1) for c in (cross_k, cross_v))

        def step(tok, i, parent_rows):
            if parent_rows is not None:
                for key in state:
                    state[key] = state[key].index_select(1, parent_rows)
            return whisper_decode_token(model, tok, i, state["ks"], state["vs"],
                                        cross_k, cross_v)[0]

        seqs, final = _search(logits0, step, max_tokens, k, eos_id, length_penalty)
    return (seqs, final) if return_all else seqs[:, 0]
