"""Greedy transcription for Whisper-MoP, in PyTorch: the Whisper part of
``mop_tpu/models/generate.py``.

- ``whisper_transcribe``: encode once, then greedy over a fixed decoder
  window of ``max_tokens + 1`` tokens; each step is a full ``decode`` of the
  window, through K1 causal and cross in every decoder layer.
- ``whisper_transcribe_cached``: the same tokens from exact per-layer KV
  caches. The Whisper decoder is a standard pre-LN causal transformer, so
  position i depends only on positions <= i: each step appends one row to
  every self-attention cache, and the cross-attention K/V are computed once
  from the encoder output (``whisper_decode_prep``). The caches are fp32,
  bf16 or int8; int8 rows carry a per-row fp32 scale, self and cross alike.
- ``whisper_transcribe_auto``: the cached route from
  ``config.whisper_cached_min_ctx`` tokens on, the full window below.

The decode runs in eval mode without autograd; the model's mode is restored
afterwards.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

from ..config import config as run_config
from .whisper_mop import WhisperMoP

Tensor = torch.Tensor

__all__ = ["whisper_transcribe", "whisper_decode_prep", "whisper_decode_token",
           "whisper_transcribe_cached", "whisper_transcribe_auto"]


@contextlib.contextmanager
def _decoding(model: WhisperMoP):
    """Eval mode and no autograd for the decode, the model's mode restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def whisper_transcribe(model: WhisperMoP, mel: Tensor, bos_token: int,
                       max_tokens: int) -> Tensor:
    """Greedy transcription: (B, max_tokens) token ids.

    The encoder runs once; each step decodes the whole fixed window (BOS at
    0, the tokens so far after it, zeros beyond) and takes the argmax at the
    step's position."""
    with _decoding(model):
        enc_out = model.encode(mel)[0]
        b = mel.shape[0]
        tokens = torch.zeros(b, max_tokens + 1, dtype=torch.long, device=mel.device)
        tokens[:, 0] = bos_token
        for i in range(max_tokens):
            logits = model.decode(enc_out, tokens)
            tokens[:, i + 1] = logits[:, i].argmax(-1)
    return tokens[:, 1:].clone()


def _q8_rows(rows: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-row int8 quantization: (..., T, dk) fp32 -> (int8 rows,
    (..., T) fp32 scales). All-zero rows get scale 1."""
    s = rows.abs().amax(-1) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.round(rows / s[..., None]).to(torch.int8), s


def _mha(q: Tensor, ks: Tensor, vs: Tensor, n_valid: Optional[int] = None,
         scales: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """q (B, H, 1, dh) against ks/vs (B, H, T, dh), the columns from
    ``n_valid`` on masked. ``scales``: per-row fp32 scales (k_s, v_s) of
    shape (B, H, T) for int8 caches; the K scales multiply the score
    columns after the product, the V scales fold into the attention weights
    before the value product."""
    s = q @ ks.to(q.dtype).transpose(-1, -2) / math.sqrt(q.shape[-1])
    if scales is not None:
        s = s * scales[0][:, :, None, :]
    if n_valid is not None:
        s[..., n_valid:] = float("-inf")
    a = torch.softmax(s, -1)
    if scales is not None:
        a = a * scales[1][:, :, None, :]
    return a @ vs.to(a.dtype)


def _split1(y: Tensor, h: int) -> Tensor:
    """(B, 1, D) -> (B, H, 1, D / H)."""
    b, _, d = y.shape
    return y.reshape(b, 1, h, d // h).transpose(1, 2)


def _merge1(y: Tensor) -> Tensor:
    """(B, H, 1, dh) -> (B, 1, H * dh)."""
    b, h, _, dh = y.shape
    return y.transpose(1, 2).reshape(b, 1, h * dh)


def whisper_decode_prep(model: WhisperMoP, mel: Tensor,
                        kv_dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
    """One encoder pass and every decoder layer's cross-attention K/V:
    ``(cross_k, cross_v)``, each (L, B, H, T_enc, dh) in ``kv_dtype``
    (float32 or bfloat16). Int8 rows need their per-row scales, which
    ``whisper_transcribe_cached`` makes; an int8 ``kv_dtype`` raises here."""
    if kv_dtype == torch.int8:
        raise ValueError("whisper_decode_prep: int8 cross K/V need per-row scales; "
                         "use whisper_transcribe_cached(kv_dtype=torch.int8)")
    h = model.cfg.n_head
    with _decoding(model):
        enc_out = model.encode(mel)[0]
        ks, vs = [], []
        for blk in model.decoder:
            ca = blk.cross_attn
            ks.append(ca.k_proj(enc_out).unflatten(-1, (h, -1)).transpose(1, 2))
            vs.append(ca.v_proj(enc_out).unflatten(-1, (h, -1)).transpose(1, 2))
    return torch.stack(ks).to(kv_dtype), torch.stack(vs).to(kv_dtype)


def whisper_decode_token(model: WhisperMoP, tok: Tensor, pos: int, ks: Tensor, vs: Tensor,
                         cross_k: Tensor, cross_v: Tensor,
                         scales: Optional[Dict[str, Tensor]] = None):
    """One exact cached decoder step for (B,) tokens at position ``pos``:
    writes this token's self-attention K/V rows at ``pos`` of the
    (L, B, H, win, dh) caches ``ks``/``vs`` in place and returns
    ``(logits (B, vocab), ks, vs)``.

    ``scales``: for int8 caches, a dict of per-row fp32 scales, ``k_s`` and
    ``v_s`` (L, B, H, win) for the self-attention rows (this token's rows are
    quantized and their scales written here) and ``cross_k_s``/``cross_v_s``
    (L, B, H, T_enc); the return then gains the dict as a fourth element.
    Call it in eval mode without autograd, as the transcription does."""
    h = model.cfg.n_head
    x = model.wte.weight[tok][:, None, :]
    if model.cfg.use_abs_pos_emb:
        x = x + model.text_pos.weight[pos][None, None, :]
    for li, blk in enumerate(model.decoder):
        sa = blk.self_attn
        hx = blk.ln1(x)
        q = _split1(sa.q_proj(hx), h)
        k_new, v_new = _split1(sa.k_proj(hx), h), _split1(sa.v_proj(hx), h)
        if scales is not None:  # int8: quantize the new rows, each with its scale
            k_new, k_s = _q8_rows(k_new)
            v_new, v_s = _q8_rows(v_new)
            scales["k_s"][li, :, :, pos] = k_s[..., 0]
            scales["v_s"][li, :, :, pos] = v_s[..., 0]
        ks[li, :, :, pos] = k_new[:, :, 0].to(ks.dtype)
        vs[li, :, :, pos] = v_new[:, :, 0].to(vs.dtype)
        self_sc = None if scales is None else (scales["k_s"][li], scales["v_s"][li])
        y = _mha(q, ks[li], vs[li], n_valid=pos + 1, scales=self_sc)
        x = x + sa.o_proj(_merge1(y))
        ca = blk.cross_attn
        qc = _split1(ca.q_proj(blk.ln2(x)), h)
        cross_sc = None if scales is None else (scales["cross_k_s"][li],
                                                scales["cross_v_s"][li])
        x = x + ca.o_proj(_merge1(_mha(qc, cross_k[li], cross_v[li], scales=cross_sc)))
        x = x + blk.mlp(blk.ln3(x))
    logits = model.wte.attend(model.dec_ln_f(x))[:, 0]
    if scales is not None:
        return logits, ks, vs, scales
    return logits, ks, vs


def whisper_transcribe_cached(model: WhisperMoP, mel: Tensor, bos_token: int, max_tokens: int,
                              kv_dtype: torch.dtype = torch.float32) -> Tensor:
    """Greedy transcription with exact per-layer KV caches: (B, max_tokens)
    token ids, the tokens of ``whisper_transcribe``.

    ``kv_dtype=torch.bfloat16`` halves the cache storage and reads (compute
    stays in the model's dtype); ``torch.int8`` quantizes every cached row,
    self and cross, symmetrically with a per-row fp32 scale, applied after
    the products as in ``_mha``."""
    int8 = kv_dtype == torch.int8
    cfg = model.cfg
    b, win = mel.shape[0], max_tokens + 1
    shape = (cfg.n_layer_dec, b, cfg.n_head, win, cfg.n_embd // cfg.n_head)
    cross_k, cross_v = whisper_decode_prep(model, mel, torch.float32 if int8 else kv_dtype)
    ks = torch.zeros(shape, dtype=kv_dtype, device=mel.device)
    vs = torch.zeros(shape, dtype=kv_dtype, device=mel.device)
    scales = None
    if int8:
        cross_k, ck_s = _q8_rows(cross_k)
        cross_v, cv_s = _q8_rows(cross_v)
        ones = torch.ones(shape[:-1], dtype=torch.float32, device=mel.device)
        scales = {"k_s": ones, "v_s": ones.clone(), "cross_k_s": ck_s, "cross_v_s": cv_s}
    tok = torch.full((b,), bos_token, dtype=torch.long, device=mel.device)
    outs = []
    with _decoding(model):
        for i in range(max_tokens):
            logits = whisper_decode_token(model, tok, i, ks, vs, cross_k, cross_v,
                                          scales=scales)[0]
            tok = logits.argmax(-1)
            outs.append(tok)
    return torch.stack(outs, 1)


def whisper_transcribe_auto(model: WhisperMoP, mel: Tensor, bos_token: int, max_tokens: int,
                            kv_dtype: torch.dtype = torch.float32) -> Tensor:
    """Greedy transcription by the measured dispatch: the full window below
    ``config.whisper_cached_min_ctx`` tokens (``MOP_TPU_WHISPER_CACHED_MIN_CTX``),
    the cached route from there on. Both give the same tokens; ``kv_dtype``
    reaches only the cached route."""
    if max_tokens < run_config.whisper_cached_min_ctx:
        return whisper_transcribe(model, mel, bos_token, max_tokens)
    return whisper_transcribe_cached(model, mel, bos_token, max_tokens, kv_dtype=kv_dtype)
