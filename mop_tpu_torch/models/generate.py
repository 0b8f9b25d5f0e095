"""Autoregressive decoding in PyTorch: the port of
``mop_tpu/models/generate.py``, for the GPT family and for Whisper-MoP.

GPT family (``TinyTransformerLM``, ``GPT_MoP`` with either gate):

- ``generate``: the exact full-window sampler. Each token re-runs the
  model's eval forward on a fixed zero-padded ``(B, block)`` window (the
  Quartet attention standardizes every score row over all ``block``
  columns, the pads included, before the causal mask: on the card that is
  K5 in every layer) and takes the logits at the last live position; the
  window rolls once it is full.
- the KV cache: ``init_decode_cache`` (fp32, bf16 or int8 rows with per-row
  fp32 scales; GPT-MoP adds its view history ``mv``), ``prefill`` /
  ``prefill_padded`` (one forward over the prompt, standardizing over its
  columns), ``decode_step`` and ``decode_chunk`` (each new row standardizes
  over its live prefix; the cached rows are frozen: the approximation the
  JAX package measures), and ``generate_cached`` with the grow-window
  decode. They compose plain ops (no kernel) and read a dict of the model's
  tensors in the JAX tree's layout, ``decode_params(model)``, whose linear
  kernels may be ``ops.quant`` int8 / int4 weights.
- the sampler: greedy or temperature / top-k / top-p / min-p, with
  repetition, presence and frequency penalties; a draw is the argmax of
  the filtered logits plus Gumbel noise from an explicit ``torch.Generator``
  (``jax.random.categorical``'s construction).

Whisper-MoP:

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
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as nnF
from torch import nn

from ..config import config as run_config
from ..ops.attention import standardize_scores_causal
from ..ops.quant import Q4Tensor, QTensor, q4matmul, qmatmul
from ..utils.device import resolve_device
from .layers import gelu_tanh
from .whisper_mop import WhisperMoP

Tensor = torch.Tensor

__all__ = ["decode_params", "generate", "init_decode_cache", "model_n_views", "prefill",
           "prefill_padded", "decode_step", "decode_chunk", "generate_cached",
           "whisper_transcribe", "whisper_decode_prep", "whisper_decode_token",
           "whisper_transcribe_cached", "whisper_transcribe_auto"]


@contextlib.contextmanager
def _decoding(model: nn.Module):
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


def _split_heads(y: Tensor, h: int) -> Tensor:
    """(B, T, C) -> (B, H, T, C / H)."""
    b, t, c = y.shape
    return y.reshape(b, t, h, c // h).transpose(1, 2)


def _merge_heads(y: Tensor) -> Tensor:
    """(B, H, T, dk) -> (B, T, H * dk)."""
    b, h, t, dk = y.shape
    return y.transpose(1, 2).reshape(b, t, h * dk)


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
        q = _split_heads(sa.q_proj(hx), h)
        k_new, v_new = _split_heads(sa.k_proj(hx), h), _split_heads(sa.v_proj(hx), h)
        if scales is not None:  # int8: quantize the new rows, each with its scale
            k_new, k_s = _q8_rows(k_new)
            v_new, v_s = _q8_rows(v_new)
            scales["k_s"][li, :, :, pos] = k_s[..., 0]
            scales["v_s"][li, :, :, pos] = v_s[..., 0]
        ks[li, :, :, pos] = k_new[:, :, 0].to(ks.dtype)
        vs[li, :, :, pos] = v_new[:, :, 0].to(vs.dtype)
        self_sc = None if scales is None else (scales["k_s"][li], scales["v_s"][li])
        y = _mha(q, ks[li], vs[li], n_valid=pos + 1, scales=self_sc)
        x = x + sa.o_proj(_merge_heads(y))
        ca = blk.cross_attn
        qc = _split_heads(ca.q_proj(blk.ln2(x)), h)
        cross_sc = None if scales is None else (scales["cross_k_s"][li],
                                                scales["cross_v_s"][li])
        x = x + ca.o_proj(_merge_heads(_mha(qc, cross_k[li], cross_v[li], scales=cross_sc)))
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


# ------------------------------ GPT family ------------------------------


def _lin_params(lin: nn.Linear) -> dict:
    p = {"kernel": lin.weight.detach().t()}
    if lin.bias is not None:
        p["bias"] = lin.bias.detach()
    return p


def _ln_params(ln: nn.Module) -> dict:
    return {"scale": ln.weight.detach(), "bias": ln.bias.detach()}


def decode_params(model: nn.Module) -> dict:
    """The model's tensors as the JAX tree lays them out, ``{"params": {...}}``
    with ``wte``/``wpe`` ``embedding``, ``blocks_i`` (``ln1``, ``attn`` with
    its ``*_proj`` kernels in (in, out) layout, ``mixture`` and
    ``quartet_scale``, ``ln2``, ``mlp``; GPT-MoP's ``views``, ``kernels``
    (ks, V, K) and ``fuse``) and ``ln_f``. The leaves are detached views of
    the parameters, so the dict follows the model as it trains;
    ``ops.quant.quantize_params`` maps over it."""
    cfg = model.config
    p = {"wte": {"embedding": model.wte.weight.detach()}}
    if cfg.use_abs_pos_emb:
        p["wpe"] = {"embedding": model.wpe.weight.detach()}
    names = ("q_proj", "k_proj", "v_proj", "o_proj")
    if cfg.use_quartet:
        names += ("q2_proj", "k2_proj")
    for i, blk in enumerate(model.blocks):
        attn = {n: _lin_params(getattr(blk.attn, n)) for n in names}
        if cfg.use_quartet:
            attn["mixture"] = blk.attn.mixture.detach()
            attn["quartet_scale"] = blk.attn.quartet_scale.detach()
        bp = {"ln1": _ln_params(blk.ln1), "attn": attn, "ln2": _ln_params(blk.ln2),
              "mlp": {"fc": _lin_params(blk.mlp.fc), "proj": _lin_params(blk.mlp.proj)}}
        if hasattr(blk, "views"):  # GPT-MoP: torch's (out, in, k) convs as (k, in, out)
            bp["views"] = {"proj": _lin_params(blk.views.proj)}
            bp["kernels"] = {"conv": {"kernel": blk.kernels.conv.weight.detach().permute(2, 1, 0)}}
            bp["fuse"] = {"conv": {"kernel": blk.fuse.conv.weight.detach().permute(2, 1, 0)},
                          "alpha": blk.fuse.alpha.detach()}
        p[f"blocks_{i}"] = bp
    p["ln_f"] = _ln_params(model.ln_f)
    return {"params": p}


def _top_p_mask(scaled: Tensor, top_p: float) -> Tensor:
    """Nucleus filter on (B, vocab) temperature-scaled logits: keep the
    smallest set of tokens whose probability mass reaches ``top_p`` (the
    top token always), -inf the rest."""
    srt = scaled.sort(-1, descending=True).values
    probs = torch.softmax(srt, -1)
    cum = probs.cumsum(-1)
    keep = (cum - probs) < top_p  # keep while the mass BEFORE this token < p
    inf = torch.tensor(float("inf"), device=scaled.device)
    thr = torch.where(keep, srt, inf).amin(-1, keepdim=True)
    return torch.where(scaled >= thr, scaled, -inf)


def _min_p_mask(scaled: Tensor, min_p: float) -> Tensor:
    """min-p filter: keep tokens of probability at least ``min_p`` times the
    largest, i.e. ``logit >= max_logit + log(min_p)`` (log taken in fp32)."""
    thr = scaled.amax(-1, keepdim=True) + torch.log(torch.tensor(min_p, dtype=torch.float32))
    return torch.where(scaled >= thr, scaled, torch.tensor(float("-inf"), device=scaled.device))


def _apply_penalties(logits: Tensor, out_counts: Tensor, seen: Tensor, repetition_penalty,
                     presence_penalty, frequency_penalty) -> Tensor:
    """Repetition / presence / frequency penalties on raw (B, vocab) logits,
    by vLLM's conventions: the CTRL-style repetition penalty (positive logits
    divided by r, negative multiplied) over tokens ``seen`` in the prompt or
    the output; the additive presence and frequency penalties over the
    output's token counts ``out_counts`` only."""
    if repetition_penalty is not None and repetition_penalty != 1.0:
        r = torch.tensor(repetition_penalty, dtype=torch.float32)
        logits = torch.where(seen, torch.where(logits > 0, logits / r, logits * r), logits)
    if presence_penalty is not None and presence_penalty != 0.0:
        logits = logits - presence_penalty * (out_counts > 0).float()
    if frequency_penalty is not None and frequency_penalty != 0.0:
        logits = logits - frequency_penalty * out_counts.float()
    return logits


def _gumbel(shape, generator: Optional[torch.Generator], device) -> Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with u uniform in
    [tiny, 1), as ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _categorical(logits: Tensor, gumbel: Tensor) -> Tensor:
    """A draw from softmax(logits) along the last axis given its Gumbel
    noise: ``argmax(logits + gumbel)`` (the first index on a tie), as
    ``jax.random.categorical``."""
    return (logits + gumbel).argmax(-1)


def _filter_logits(logits: Tensor, temperature: float, top_k, top_p, min_p) -> Tensor:
    """Temperature, then top-k (the k-th largest value kept with its ties),
    top-p and min-p."""
    scaled = logits / max(temperature, 1e-6)
    if top_k is not None:
        kth = scaled.sort(-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, torch.tensor(float("-inf"), device=scaled.device),
                             scaled)
    if top_p is not None and top_p < 1.0:
        scaled = _top_p_mask(scaled, top_p)
    if min_p is not None and min_p > 0.0:
        scaled = _min_p_mask(scaled, min_p)
    return scaled


def _make_pick(greedy: bool, temperature: float, top_k, top_p, min_p=None,
               repetition_penalty=None, presence_penalty=None, frequency_penalty=None):
    """The token picker every GPT sampler shares: ``pick(logits, generator,
    out_counts, prompt_counts) -> (B,) tokens``. With any penalty set
    (``pick.uses_counts``) it reads the output and prompt token counts;
    penalties apply under greedy too."""
    uses_counts = any(p is not None and p != d for p, d in (
        (repetition_penalty, 1.0), (presence_penalty, 0.0), (frequency_penalty, 0.0)))

    def pick(logits, generator, out_counts=None, prompt_counts=None):
        if uses_counts:
            seen = (out_counts > 0) | (prompt_counts > 0)
            logits = _apply_penalties(logits, out_counts, seen, repetition_penalty,
                                      presence_penalty, frequency_penalty)
        if greedy:
            return logits.argmax(-1)
        scaled = _filter_logits(logits, temperature, top_k, top_p, min_p)
        return _categorical(scaled, _gumbel(scaled.shape, generator, scaled.device))

    pick.uses_counts = uses_counts
    return pick


def _prompt_counts(prompt: Tensor, vocab: int) -> Tensor:
    """(B, T0) tokens -> (B, vocab) int32 occurrence counts."""
    counts = torch.zeros(prompt.shape[0], vocab, dtype=torch.int32, device=prompt.device)
    return counts.scatter_add_(1, prompt.long(), torch.ones_like(prompt, dtype=torch.int32))


def _counts(pick, prompt: Tensor, vocab: int):
    """The prompt's token counts and zero output counts where ``pick`` reads
    them, else (None, None)."""
    if not pick.uses_counts:
        return None, None
    pcounts = _prompt_counts(prompt, vocab)
    return pcounts, torch.zeros_like(pcounts)


def _add_counts(pick, out_counts, tok: Tensor) -> None:
    if pick.uses_counts:
        out_counts[torch.arange(tok.shape[0], device=tok.device), tok] += 1


def generate(model: nn.Module, prompt: Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None, temperature: float = 1.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             min_p: Optional[float] = None, repetition_penalty: Optional[float] = None,
             presence_penalty: Optional[float] = None,
             frequency_penalty: Optional[float] = None) -> Tensor:
    """``max_new_tokens`` continuations of a (B, T0) prompt by the exact
    full-window sampler: (B, T0 + max_new_tokens) token ids.

    Greedy when ``temperature == 0`` or no ``generator`` is given. The
    context is a fixed (B, block_size) window, zero beyond the live length;
    each step runs the model's eval forward on the whole window and picks
    from the logits at the last live position, then writes the token there
    (or, once the window is full, rolls it left by one and writes at the
    end). The model's Quartet attention standardizes each score row over
    all the window's columns before the causal mask, so that the pads are
    part of the semantics (no cache can be exact); on a CUDA model every
    layer of every step runs K5."""
    block = model.config.block_size
    b, t0 = prompt.shape
    if t0 < 1:
        raise ValueError("generate: the prompt needs at least one token")
    greedy = generator is None or temperature == 0.0
    pick = _make_pick(greedy, temperature, top_k, top_p, min_p, repetition_penalty,
                      presence_penalty, frequency_penalty)
    prompt = prompt.long()
    pcounts, ocounts = _counts(pick, prompt, model.wte.num_embeddings)
    length = min(t0, block)
    window = torch.zeros(b, block, dtype=torch.long, device=prompt.device)
    window[:, :length] = prompt[:, -block:]
    toks = []
    with _decoding(model):
        for _ in range(max_new_tokens):
            logits = model(window)[0][:, length - 1]
            nxt = pick(logits, generator, ocounts, pcounts)
            _add_counts(pick, ocounts, nxt)
            if length >= block:
                window = window.roll(-1, 1)
                window[:, -1] = nxt
            else:
                window[:, length] = nxt
                length += 1
            toks.append(nxt)
    return torch.cat([prompt, *(t[:, None] for t in toks)], 1)


def _ln(x: Tensor, p: dict, eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _lin(x: Tensor, p: dict) -> Tensor:
    """``x @ kernel (+ bias)``, the kernel fp32, ``QTensor`` or ``Q4Tensor``."""
    k = p["kernel"]
    if isinstance(k, QTensor):
        y = qmatmul(x, k)
    elif isinstance(k, Q4Tensor):
        y = q4matmul(x, k)
    else:
        y = x @ k
    if "bias" in p:
        y = y + p["bias"]
    return y


def _cols_mask(n_cols: int, n_valid: Union[int, Tensor], device) -> Tensor:
    """(1 | B, 1, 1, n_cols) bool mask of the valid prefix; ``n_valid`` is an
    int (a shared length) or a (B,) tensor (per-row lengths)."""
    cols = torch.arange(n_cols, device=device)
    if isinstance(n_valid, Tensor):
        return (cols[None, :] < n_valid.reshape(-1, 1))[:, None, None, :]
    return (cols < n_valid)[None, None, None, :]


def _standardize_rows(s: Tensor, n_valid: Union[int, Tensor], eps: float) -> Tensor:
    """Unbiased row standardization over the first ``n_valid`` columns: the
    mean over them, the squared deviations summed over them and divided by
    ``max(n - 1, 1)``, eps added after the sqrt. ``n_valid``: an int or a
    (B,) tensor."""
    cols = _cols_mask(s.shape[-1], n_valid, s.device)
    zero = s.new_zeros(())
    if isinstance(n_valid, Tensor):
        n = n_valid.clamp_min(1).reshape(-1, 1, 1, 1).to(s.dtype)
        dof = (n - 1.0).clamp_min(1.0)
    else:
        n = float(max(n_valid, 1))
        dof = max(n - 1.0, 1.0)
    mu = torch.where(cols, s, zero).sum(-1, keepdim=True) / n
    var = torch.where(cols, (s - mu).square(), zero).sum(-1, keepdim=True) / dof
    return (s - mu) / (torch.sqrt(var) + eps)


def init_decode_cache(config, batch: int, dtype: torch.dtype = torch.float32, n_views: int = 0,
                      device=None) -> dict:
    """Per-layer (k, k2, v) caches of shape (L, B, H, block, dk) and the live
    length ``len`` (an int). ``dtype=torch.int8`` stores int8 rows with
    per-row fp32 scales ``k_s``/``k2_s``/``v_s`` (L, B, H, block), applied
    after the products. ``n_views > 0`` (GPT-MoP) adds the view history
    ``mv`` (L, B, block, V) in fp32, the gate conv's taps. On the GPU unless
    ``device`` is given."""
    device = resolve_device(device)
    L, h = config.n_layer, config.n_head
    shape = (L, batch, h, config.block_size, config.n_embd // h)
    cache = {key: torch.zeros(shape, dtype=dtype, device=device) for key in ("k", "k2", "v")}
    cache["len"] = 0
    if dtype == torch.int8:
        for key in ("k_s", "k2_s", "v_s"):
            cache[key] = torch.ones(shape[:4], dtype=torch.float32, device=device)
    if n_views:
        cache["mv"] = torch.zeros(L, batch, config.block_size, n_views, device=device)
    return cache


def model_n_views(model: nn.Module) -> int:
    """The cache layout's view count: GPT-MoP's ``n_views``, else 0."""
    return int(getattr(model, "n_views", 0) or 0)


def _mop_taps(mv: Tensor, pos: Tensor, ks: int, causal: bool) -> Tensor:
    """The gate conv's taps from one layer's view history mv (B, block, V)
    at output positions pos (B,) or (B, G): (B, G, ks, V), tap j of position
    t the view row at ``t - (ks - 1) + j`` (causal) or ``t - ks // 2 + j``
    (centred). Taps outside [0, t] are zero: before 0 the conv's padding,
    after t the frontier approximation of the centred gate (what the full
    forward computes at its last position)."""
    b, block, V = mv.shape
    pos2 = pos.reshape(b, -1)
    start = pos2 - (ks - 1) if causal else pos2 - ks // 2
    pidx = start[..., None] + torch.arange(ks, device=mv.device)  # (B, G, ks)
    ok = (pidx >= 0) & (pidx <= pos2[..., None])
    flat = pidx.reshape(b, -1).clamp(0, block - 1)
    g = mv.gather(1, flat[..., None].expand(-1, -1, V)).reshape(b, pos2.shape[1], ks, V)
    return torch.where(ok[..., None], g, g.new_zeros(()))


def _mop_gates(bp: dict, mv: Tensor, pos: Tensor, causal: bool) -> Tensor:
    """GPT-MoP's gate for decode from the view history (which already holds
    the rows at ``pos``): (B, G) ``1 + a_pos g_pos - a_neg g_neg``."""
    kern = bp["kernels"]["conv"]["kernel"]  # (ks, V, K)
    ks = kern.shape[0]
    taps = _mop_taps(mv, pos, ks, causal)
    kmaps = torch.einsum("bgjv,jvk->bgk", taps, kern)
    here = ks - 1 if causal else ks // 2  # the tap at pos
    gates = torch.cat([taps[:, :, here], kmaps], -1) @ bp["fuse"]["conv"]["kernel"][0]
    alpha = bp["fuse"]["alpha"]
    return 1.0 + alpha[0] * gates[..., 0] - alpha[1] * gates[..., 1]


def _mop_gate_full(bp: dict, x: Tensor, t_live=None, causal: bool = False):
    """The full-window gate for prefill from the post-attention activations
    x (B, T, C): ``(gate (B, T), views (B, T, V))`` as the module computes
    them (views, the k-tap conv left-padded when ``causal``, else centred,
    the 1x1 fuse). ``t_live`` (an int or a (B,) tensor): views at positions
    from it on are zeroed before the conv, so that pads do not reach the
    taps."""
    v = _lin(x, bp["views"]["proj"])
    t = v.shape[1]
    if t_live is not None:
        lv = torch.as_tensor(t_live, device=x.device).reshape(-1, 1)
        v = torch.where((torch.arange(t, device=x.device)[None, :] < lv)[..., None], v,
                        v.new_zeros(()))
    kern = bp["kernels"]["conv"]["kernel"]
    ks = kern.shape[0]
    left = ks - 1 if causal else ks // 2
    vp = nnF.pad(v, (0, 0, left, ks - 1 - left))
    kmaps = sum(vp[:, j:j + t] @ kern[j] for j in range(ks))
    gates = torch.cat([v, kmaps], -1) @ bp["fuse"]["conv"]["kernel"][0]
    alpha = bp["fuse"]["alpha"]
    return 1.0 + alpha[0] * gates[..., 0] - alpha[1] * gates[..., 1], v


def _mlp(x: Tensor, bp: dict) -> Tensor:
    return x + _lin(gelu_tanh(_lin(_ln(x, bp["ln2"]), bp["mlp"]["fc"])), bp["mlp"]["proj"])


def _attn_step(p: dict, cfg, x: Tensor, k_all: Tensor, k2_all: Tensor, v_all: Tensor,
               n_valid: Union[int, Tensor], scales=None) -> Tensor:
    """One token's attention against caches that already hold its rows at
    ``n_valid - 1``: x (B, 1, C) -> (B, 1, C). ``scales``: the int8 caches'
    per-row (k_s, k2_s, v_s), (B, H, T) each: K scales multiply the score
    columns after the product, V scales fold into the attention weights
    before the value product."""
    h = cfg.n_head
    q = _split_heads(_lin(x, p["q_proj"]), h)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def col(s):  # (B, H, T) -> over the query axis
        return s[:, :, None, :]

    qk = q @ k_all.to(q.dtype).transpose(-1, -2) * scale
    if scales is not None:
        qk = qk * col(scales[0])
    if cfg.use_quartet:
        q2 = _split_heads(_lin(x, p["q2_proj"]), h)
        q2k2 = q2 @ k2_all.to(q2.dtype).transpose(-1, -2) * scale
        if scales is not None:
            q2k2 = q2k2 * col(scales[1])
        m = torch.sigmoid(p["mixture"][0])
        s1 = _standardize_rows(qk, n_valid, cfg.score_norm_eps)
        s2 = _standardize_rows(q2k2, n_valid, cfg.score_norm_eps)
        scores = (1.0 - m) * s1 + m * (s1 * s2) * p["quartet_scale"][0]
    else:  # the single path's eps is 1e-5 whatever the config says
        scores = _standardize_rows(qk, n_valid, 1e-5)
    cols = _cols_mask(k_all.shape[2], n_valid, x.device)
    att = torch.softmax(scores.masked_fill(~cols, float("-inf")), -1)
    if scales is not None:
        att = att * col(scales[2])
    return _lin(_merge_heads(att @ v_all.to(att.dtype)), p["o_proj"])


def _kv_rows(p: dict, cfg, x: Tensor):
    """This token's k, k2, v rows (B, H, 1, dk) from the ln1 activations
    (k2 is k without Quartet)."""
    h = cfg.n_head
    k = _split_heads(_lin(x, p["k_proj"]), h)
    v = _split_heads(_lin(x, p["v_proj"]), h)
    k2 = _split_heads(_lin(x, p["k2_proj"]), h) if cfg.use_quartet else k
    return k, k2, v


def _write_rows(cache: dict, i: int, pos: int, rows) -> Optional[tuple]:
    """Write layer i's new (k, k2, v) rows (B, H, G, dk) at positions
    ``pos .. pos + G - 1`` of the cache in place (int8: quantized per row,
    their scales beside); the layer's int8 scales, else None."""
    g = rows[0].shape[2]
    for key, r in zip(("k", "k2", "v"), rows):
        if "k_s" in cache:
            r, s = _q8_rows(r)
            cache[key + "_s"][i, :, :, pos:pos + g] = s
        cache[key][i, :, :, pos:pos + g] = r.to(cache[key].dtype)
    if "k_s" in cache:
        return cache["k_s"][i], cache["k2_s"][i], cache["v_s"][i]
    return None


def _params(model: nn.Module, params: Optional[dict]) -> dict:
    return (decode_params(model) if params is None else params)["params"]


def decode_step(model: nn.Module, params: Optional[dict], cache: dict, token: Tensor):
    """One cached decode step: (B,) tokens -> (logits (B, vocab), cache).

    The token's rows are written at ``cache["len"]`` into the cache's
    buffers in place (the caller keeps the window from filling); the
    returned dict shares them and has ``len`` advanced by one. ``params``:
    ``decode_params(model)`` or its ``ops.quant`` form (None: the model's
    own). GPT-MoP's gate is applied between attention and MLP from the view
    history: exact for the causal gate, frontier-approximate for the
    centred one (``_mop_taps``)."""
    cfg = model.config
    p = _params(model, params)
    pos = cache["len"]
    n_valid = pos + 1
    causal_gate = bool(getattr(model, "causal_gate", False))
    with torch.no_grad():
        x = p["wte"]["embedding"][token][:, None, :]
        if cfg.use_abs_pos_emb:
            x = x + p["wpe"]["embedding"][pos][None, None, :]
        for i in range(cfg.n_layer):
            bp = p[f"blocks_{i}"]
            hx = _ln(x, bp["ln1"])
            scales = _write_rows(cache, i, pos, _kv_rows(bp["attn"], cfg, hx))
            x = x + _attn_step(bp["attn"], cfg, hx, cache["k"][i], cache["k2"][i],
                               cache["v"][i], n_valid, scales=scales)
            if "views" in bp:  # the MoP gate between attention and MLP
                cache["mv"][i, :, pos] = _lin(x, bp["views"]["proj"])[:, 0]
                gate = _mop_gates(bp, cache["mv"][i],
                                  torch.full((x.shape[0],), pos, device=x.device), causal_gate)
                x = x * gate[..., None]
            x = _mlp(x, bp)
        logits = (_ln(x, p["ln_f"]) @ p["wte"]["embedding"].t())[:, 0]
    return logits, dict(cache, len=pos + 1)


def decode_chunk(model: nn.Module, params: Optional[dict], cache: dict, tokens: Tensor):
    """A cached forward over G new tokens at positions ``len .. len + G - 1``:
    (B, G) tokens -> (logits (B, G, vocab), cache with ``len`` advanced by G).

    Equal to G sequential ``decode_step`` calls: row i standardizes and
    attends over its ``len + i + 1`` live columns, and the chunk's own rows
    are written (in place) before the attention, so that the causal mask
    covers the chunk. The verify pass of speculative decoding."""
    cfg = model.config
    p = _params(model, params)
    b, g = tokens.shape
    h = cfg.n_head
    pos0 = cache["len"]
    dev = tokens.device
    positions = pos0 + torch.arange(g, device=dev)
    block = cache["k"].shape[3]
    nv = positions + 1  # row i's live-prefix length
    cols4 = (torch.arange(block, device=dev)[None, :] < nv[:, None])[None, None]
    nvf = nv.float()[None, None, :, None]
    zero = torch.zeros((), device=dev)

    def std(s, eps):  # unbiased, over each row's live prefix
        mu = torch.where(cols4, s, zero).sum(-1, keepdim=True) / nvf
        var = (torch.where(cols4, (s - mu).square(), zero).sum(-1, keepdim=True)
               / (nvf - 1.0).clamp_min(1.0))
        return (s - mu) / (torch.sqrt(var) + eps)

    causal_gate = bool(getattr(model, "causal_gate", False))
    with torch.no_grad():
        x = p["wte"]["embedding"][tokens]
        if cfg.use_abs_pos_emb:
            x = x + p["wpe"]["embedding"][positions][None]
        for i in range(cfg.n_layer):
            bp = p[f"blocks_{i}"]
            ap = bp["attn"]
            hx = _ln(x, bp["ln1"])
            q = _split_heads(_lin(hx, ap["q_proj"]), h)
            scale = 1.0 / math.sqrt(q.shape[-1])
            sc = _write_rows(cache, i, pos0, _kv_rows(ap, cfg, hx))
            qk = q @ cache["k"][i].to(q.dtype).transpose(-1, -2) * scale
            if sc is not None:
                qk = qk * sc[0][:, :, None, :]
            if cfg.use_quartet:
                q2 = _split_heads(_lin(hx, ap["q2_proj"]), h)
                q2k2 = q2 @ cache["k2"][i].to(q2.dtype).transpose(-1, -2) * scale
                if sc is not None:
                    q2k2 = q2k2 * sc[1][:, :, None, :]
                m = torch.sigmoid(ap["mixture"][0])
                s1 = std(qk, cfg.score_norm_eps)
                s2 = std(q2k2, cfg.score_norm_eps)
                scores = (1.0 - m) * s1 + m * (s1 * s2) * ap["quartet_scale"][0]
            else:
                scores = std(qk, 1e-5)
            att = torch.softmax(scores.masked_fill(~cols4, float("-inf")), -1)
            if sc is not None:
                att = att * sc[2][:, :, None, :]
            x = x + _lin(_merge_heads(att @ cache["v"][i].to(att.dtype)), ap["o_proj"])
            if "views" in bp:  # per chunk position, taps <= pos as in decode_step
                cache["mv"][i, :, pos0:pos0 + g] = _lin(x, bp["views"]["proj"])
                gate = _mop_gates(bp, cache["mv"][i], positions[None].expand(b, g),
                                  causal_gate)
                x = x * gate[..., None]
            x = _mlp(x, bp)
        logits = _ln(x, p["ln_f"]) @ p["wte"]["embedding"].t()
    return logits, dict(cache, len=pos0 + g)


def _prefill(model: nn.Module, params: Optional[dict], prompt: Tensor, t0, kv_dtype):
    """The shared body of ``prefill`` and ``prefill_padded``: a forward over
    the (B, T) prompt whose first ``t0`` columns are live (``t0 = T`` in
    ``prefill``), each score row standardized over the live columns (or its
    causal prefix with ``causal_std``), every layer's rows written to a
    fresh cache. Returns the ln_f activations and the cache."""
    cfg = model.config
    p = _params(model, params)
    b, t = prompt.shape
    dev = prompt.device
    h = cfg.n_head
    cache = init_decode_cache(cfg, b, kv_dtype, n_views=model_n_views(model), device=dev)
    causal_gate = bool(getattr(model, "causal_gate", False))
    padded = t0 != t
    live = torch.arange(t, device=dev) < t0
    keep = torch.ones(t, t, dtype=torch.bool, device=dev).tril() & live[None, :]
    zero = torch.zeros((), device=dev)

    def std(s, eps=cfg.score_norm_eps):
        if cfg.causal_std:  # row i's prefix is live for every live row
            return standardize_scores_causal(s, eps)
        if not padded:  # unbiased, over all t columns
            mu = s.mean(-1, keepdim=True)
            var = (s - mu).square().sum(-1, keepdim=True) / max(1, t - 1)
            return (s - mu) / (torch.sqrt(var) + eps)
        nf = float(max(t0, 1))
        m = live[None, None, None, :]
        mu = torch.where(m, s, zero).sum(-1, keepdim=True) / nf
        var = (torch.where(m, (s - mu).square(), zero).sum(-1, keepdim=True)
               / max(nf - 1.0, 1.0))
        return (s - mu) / (torch.sqrt(var) + eps)

    with torch.no_grad():
        x = p["wte"]["embedding"][prompt]
        if cfg.use_abs_pos_emb:
            x = x + p["wpe"]["embedding"][:t][None]
        for i in range(cfg.n_layer):
            bp = p[f"blocks_{i}"]
            ap = bp["attn"]
            hx = _ln(x, bp["ln1"])
            q, k, v = (_split_heads(_lin(hx, ap[n]), h) for n in ("q_proj", "k_proj", "v_proj"))
            scale = 1.0 / math.sqrt(q.shape[-1])
            qk = q @ k.transpose(-1, -2) * scale
            if cfg.use_quartet:
                q2 = _split_heads(_lin(hx, ap["q2_proj"]), h)
                k2 = _split_heads(_lin(hx, ap["k2_proj"]), h)
                m = torch.sigmoid(ap["mixture"][0])
                scores = ((1.0 - m) * std(qk)
                          + m * (std(qk) * std(q2 @ k2.transpose(-1, -2) * scale))
                          * ap["quartet_scale"][0])
            else:
                k2 = k
                scores = std(qk, 1e-5)
            att = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1)
            # a pad row's scores are all masked: its NaN weights become 0
            att = torch.nan_to_num(att, nan=0.0) if padded else att
            x = x + _lin(_merge_heads(att @ v), ap["o_proj"])
            if "views" in bp:  # the MoP gate; pad views zeroed before the conv
                gate, vmaps = _mop_gate_full(bp, x, t_live=t0 if padded else None,
                                             causal=causal_gate)
                cache["mv"][i, :, :t] = vmaps
                x = x * gate[..., None]
            x = _mlp(x, bp)
            _write_rows(cache, i, 0, (k, k2, v))
        x = _ln(x, p["ln_f"])
    cache["len"] = int(t0)
    return x, cache


def prefill(model: nn.Module, params: Optional[dict], prompt: Tensor,
            kv_dtype: torch.dtype = torch.float32):
    """Dense prefill: one forward over the (B, T0) prompt, each score row
    standardized over its T0 columns, every layer's k/k2/v rows captured in
    a fresh cache: (last-position logits (B, vocab), cache). ``kv_dtype``:
    the caches' storage (fp32, bf16, or int8 with per-row scales); compute
    stays fp32."""
    x, cache = _prefill(model, params, prompt, prompt.shape[1], kv_dtype)
    return x[:, -1] @ _params(model, params)["wte"]["embedding"].t(), cache


def prefill_padded(model: nn.Module, params: Optional[dict], prompt_padded: Tensor, t0: int,
                   kv_dtype: torch.dtype = torch.float32):
    """Prefill over a padded (B, T_pad) prompt whose first ``t0`` columns are
    the real one: ``prefill``'s logits and first ``t0`` cache rows (pad
    columns are masked out of every row's statistics), ``len = t0``. Rows
    past ``t0`` are written too and are garbage, masked by ``len`` and
    overwritten by later appends."""
    t0 = int(t0)
    x, cache = _prefill(model, params, prompt_padded, t0, kv_dtype)
    return x[:, t0 - 1] @ _params(model, params)["wte"]["embedding"].t(), cache


def _resize(cache: dict, new_w: int) -> dict:
    """The cache with the position axis of every buffer cut to ``new_w`` or
    zero-padded to it: the K/K2/V rows (axis 3), the int8 scales (axis 3)
    and GPT-MoP's view history (axis 2)."""
    out = dict(cache)
    for key in ("k", "k2", "v", "k_s", "k2_s", "v_s", "mv"):
        if key in cache:
            v = cache[key]
            axis = 2 if key == "mv" else 3
            cur = v.shape[axis]
            if new_w < cur:
                out[key] = v.narrow(axis, 0, new_w)
            elif new_w > cur:
                pad = [0, 0] * (v.ndim - 1 - axis) + [0, new_w - cur]
                out[key] = nnF.pad(v, pad)
    return out


def generate_cached(model: nn.Module, params: Optional[dict], prompt: Tensor,
                    max_new_tokens: int, generator: Optional[torch.Generator] = None,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, kv_dtype: torch.dtype = torch.float32,
                    grow_window: bool = False, min_p: Optional[float] = None,
                    repetition_penalty: Optional[float] = None,
                    presence_penalty: Optional[float] = None,
                    frequency_penalty: Optional[float] = None) -> Tensor:
    """KV-cached greedy or sampled decode: (B, T0 + max_new_tokens) token ids
    (the cache's approximation: rows standardize over the live prefix and
    cached keys are frozen).

    ``params``: ``decode_params(model)``, or int8 / int4 weights from
    ``ops.quant.quantize_params`` (None: the model's own). ``kv_dtype``:
    fp32, bf16 (half the cache and its reads) or int8 (per-row scales).
    ``grow_window``: the cache's position axis starts at the smallest power
    of two (at least 64) above the prompt and doubles as the sequence fills
    it, so early steps read and standardize over fewer columns; the masked
    columns are inert, so the tokens are those of the full window. The
    sampler's options are ``generate``'s. Requires
    ``T0 + max_new_tokens <= block_size``."""
    cfg = model.config
    b, t0 = prompt.shape
    if t0 + max_new_tokens > cfg.block_size:
        raise ValueError(f"generate_cached: t0 + max_new_tokens = {t0 + max_new_tokens} "
                         f"exceeds block_size {cfg.block_size}")
    greedy = generator is None or temperature == 0.0
    params = decode_params(model) if params is None else params
    prompt = prompt.long()
    logits, cache = prefill(model, params, prompt, kv_dtype=kv_dtype)
    pick = _make_pick(greedy, temperature, top_k, top_p, min_p, repetition_penalty,
                      presence_penalty, frequency_penalty)
    pcounts, ocounts = _counts(pick, prompt, model.wte.num_embeddings)
    tok = pick(logits, generator, ocounts, pcounts)
    _add_counts(pick, ocounts, tok)
    block = cfg.block_size
    w = min(1 << max(6, t0.bit_length()), block) if grow_window else block
    cache = _resize(cache, w)
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        if cache["len"] == w:  # the window is full: double it
            w = min(2 * w, block)
            cache = _resize(cache, w)
        logits, cache = decode_step(model, params, cache, tok)
        tok = pick(logits, generator, ocounts, pcounts)
        _add_counts(pick, ocounts, tok)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, 1)], 1)
