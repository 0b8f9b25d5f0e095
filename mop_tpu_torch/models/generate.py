"""Autoregressive decoding in PyTorch: the port of
``mop_tpu/models/generate.py``, for the GPT family and for Whisper-MoP.

GPT family (``TinyTransformerLM``, ``GPT_MoP`` with either gate):

- ``generate``: the exact full-window sampler. Each token re-runs the
  model's eval forward on a fixed zero-padded ``(B, block)`` window (the
  Quartet attention standardizes every score row over all ``block``
  columns, the pads included, before the causal mask: on the card that is
  K5 in every layer) and takes the logits at the last live position; the
  window rolls once it is full. ``cuda_graph=True`` runs each step as one
  CUDA graph over a static window, the live length a 0-dim device tensor:
  the counterpart of JAX's one ``lax.scan``.
- the KV cache: ``init_decode_cache`` (fp32, bf16 or int8 rows with per-row
  fp32 scales; GPT-MoP adds its view history ``mv``), ``prefill`` /
  ``prefill_padded`` (one forward over the prompt, standardizing over its
  columns), ``decode_step`` and ``decode_chunk`` (each new row standardizes
  over its live prefix; the cached rows are frozen: the approximation the
  JAX package measures), and ``generate_cached`` with the grow-window
  decode. They compose plain ops (no kernel) and read a dict of the model's
  tensors in the JAX tree's layout, ``decode_params(model)``, whose linear
  kernels may be ``ops.quant`` int8 / int4 weights. ``generate_cached(...,
  cuda_graph=True)`` runs each decode step (the cached step, the pick and
  the counts) as a CUDA graph, one per window width, the shared length a
  0-dim device tensor: the counterpart of JAX's ``lax.scan`` per segment.
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
- both routes take ``cuda_graph=True``: the encoder (or the prep) eager,
  then one decoder step as a CUDA graph replayed per token, its position a
  device tensor, as JAX's ``lax.scan``.
- ``whisper_transcribe_auto``: with fp32 KV the cached route from
  ``config.whisper_cached_min_ctx`` tokens on and the full window below;
  with bf16 or int8 KV always the cached route.
- ``whisper_decode_params``: the model's tree in the JAX layout; the cached
  route reads it through ``_lin``, so its kernels may be int8 / int4.

The decode runs in eval mode without autograd; the model's mode is restored
afterwards.
"""

from __future__ import annotations

import contextlib
import functools
import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as nnF
from torch import nn

from ..config import config as run_config
from ..ops.attention import standardize_scores_causal
from ..ops.quant import Q4Tensor, QTensor, _leaves, dequantize_params, q4matmul, qmatmul
from ..utils.cuda_graph import StepGraph, require_graph
from ..utils.device import resolve_device
from ..utils.jax_weights import torch_name
from .layers import gelu_tanh
from .whisper_mop import WhisperMoP

Tensor = torch.Tensor

__all__ = ["decode_params", "generate", "init_decode_cache", "model_n_views", "prefill",
           "prefill_padded", "decode_step", "decode_chunk", "generate_cached",
           "whisper_transcribe", "whisper_decode_params", "whisper_encode",
           "whisper_decode_prep", "whisper_decode_token", "whisper_decode_step_rows",
           "decode_step_rows", "decode_chunk_rows",
           "whisper_transcribe_cached", "whisper_transcribe_auto"]


@contextlib.contextmanager
def _decoding(model: nn.Module, grad: bool = False):
    """Eval mode, and no autograd unless ``grad``, the model's mode restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.set_grad_enabled(grad):
            yield
    finally:
        model.train(was_training)


def _transcribe_step(model: WhisperMoP, enc_out: Tensor, tokens: Tensor, i: Tensor) -> Tensor:
    """One full-window step in place, as a CUDA graph of it replays (JAX's
    scan body): ``decode`` of the (B, max_tokens + 1) ``tokens``, the argmax
    at step ``i`` (a 0-dim device tensor), written at ``i + 1`` by a one-hot
    select; ``i`` advances by one. Returns the (B,) token."""
    logits = model.decode(enc_out, tokens).index_select(1, i.reshape(1))[:, 0]
    nxt = logits.argmax(-1)
    at = torch.arange(tokens.shape[1], device=tokens.device) == i + 1
    tokens.copy_(torch.where(at, nxt[:, None], tokens))
    i.add_(1)
    return nxt


def whisper_transcribe(model: WhisperMoP, mel: Tensor, bos_token: int,
                       max_tokens: int, cuda_graph: bool = False) -> Tensor:
    """Greedy transcription: (B, max_tokens) token ids.

    The encoder runs once; each step decodes the whole fixed window (BOS at
    0, the tokens so far after it, zeros beyond) and takes the argmax at the
    step's position. ``cuda_graph=True`` (a CUDA model only, else a
    ValueError): the encoder eager, then one step (``_transcribe_step``, its
    position a device tensor) as a CUDA graph replayed ``max_tokens`` times,
    as JAX's one ``lax.scan``; the tokens are the eager loop's."""
    if cuda_graph:
        require_graph("whisper_transcribe", model.wte.weight.device)
    with _decoding(model):
        enc_out = model.encode(mel)[0]
        b = mel.shape[0]
        tokens = torch.zeros(b, max_tokens + 1, dtype=torch.long, device=mel.device)
        tokens[:, 0] = bos_token
        if cuda_graph:
            step = StepGraph(functools.partial(_transcribe_step, model, enc_out, tokens,
                                               torch.zeros((), dtype=torch.long,
                                                           device=mel.device)), mel.device)
            return torch.stack([step() for _ in range(max_tokens)], 1)
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


def _mha(q: Tensor, ks: Tensor, vs: Tensor, n_valid: Union[None, int, Tensor] = None,
         scales: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """q (B, H, 1, dh) against ks/vs (B, H, T, dh), the columns from
    ``n_valid`` on masked (an int, or a (B,) tensor of per-row lengths;
    None: every column). ``scales``: per-row fp32 scales (k_s, v_s) of
    shape (B, H, T) for int8 caches; the K scales multiply the score
    columns after the product, the V scales fold into the attention weights
    before the value product."""
    s = q @ ks.to(q.dtype).transpose(-1, -2) / math.sqrt(q.shape[-1])
    if scales is not None:
        s = s * scales[0][:, :, None, :]
    if n_valid is not None:
        s = s.masked_fill(~_cols_mask(s.shape[-1], n_valid, s.device), float("-inf"))
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


def _jax_key_of(model: nn.Module, name: str) -> Tuple[str, object]:
    """One parameter's JAX tree path (dotted) and its layout map, from its
    port name: ``encoder.0`` -> ``encoder_0``, a linear weight (out, in) ->
    ``kernel`` (in, out), a conv weight (O, I, kh, kw) -> ``kernel`` (kh, kw,
    I, O), an embedding's -> ``embedding``, a LayerNorm's -> ``scale``."""
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name)
    path = re.sub(r"\b(encoder|decoder)\.(\d+)\b", r"\1_\2", mod_name)
    path = re.sub(r"^audio_proj$", "audio_proj_lin", path)
    if leaf != "weight":
        return f"{path}.{leaf}", None
    if isinstance(mod, nn.Embedding):
        return f"{path}.embedding", None
    if isinstance(mod, nn.Linear):
        return f"{path}.kernel", lambda w: w.t()
    if isinstance(mod, nn.Conv2d):
        return f"{path}.kernel", lambda w: w.permute(2, 3, 1, 0)
    return f"{path}.scale", None


def whisper_decode_params(model: WhisperMoP) -> dict:
    """The Whisper model's tensors as the JAX tree lays them out,
    ``{"params": {...}}``: ``wte``/``text_pos``/``audio_pos`` ``embedding``,
    ``audio_proj_lin``, ``encoder_i`` and ``decoder_i`` (``ln1``,
    ``self_attn`` with its ``*_proj`` kernels in (in, out) layout, ``ln2``,
    ``cross_attn``, ``ln3``, ``mlp``), ``enc_ln_f`` and ``dec_ln_f``. The
    leaves are detached views of the parameters (``decode_params``'
    counterpart); ``ops.quant.quantize_params`` maps over it, and the cached
    decode reads it through ``_lin``, so int8 / int4 kernels work there."""
    tree: dict = {}
    for name, w in model.named_parameters():
        key, layout = _jax_key_of(model, name)
        if torch_name(key) != name:  # the inverse of utils.jax_weights' renames
            raise ValueError(f"whisper_decode_params: {name} maps to {key}, "
                             f"which loads back as {torch_name(key)}")
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        w = w.detach()
        node[leaf] = layout(w) if layout is not None else w
    return {"params": tree}


def _module_state(params: dict) -> Dict[str, Tensor]:
    """A JAX-layout tree as the module's state dict (the inverse of
    ``whisper_decode_params`` and of ``decode_params``)."""
    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v

    out = {}
    for key, w in walk(params["params"], ""):
        if key.endswith("kernel") and w.ndim == 2:
            w = w.t()
        elif key.endswith("kernel") and w.ndim == 3:  # GPT-MoP's (k, in, out) convs
            w = w.permute(2, 1, 0)
        elif key.endswith("kernel") and w.ndim == 4:
            w = w.permute(3, 2, 0, 1)
        out[torch_name(key)] = w
    return out


class _Encoder(nn.Module):
    def __init__(self, model: WhisperMoP):
        super().__init__()
        self.m = model

    def forward(self, mel: Tensor) -> Tensor:
        return self.m.encode(mel)[0]


def whisper_encode(model: WhisperMoP, mel: Tensor, params: Optional[dict] = None) -> Tensor:
    """The encoder output (B, T_enc, D) for ``mel``: the module's own weights
    when ``params`` is None, else those of the JAX-layout tree ``params``,
    whose int8 / int4 kernels are dequantized for this pass (the module's
    layers take no quantized weights; the decode reads them as they are).
    On the card every encoder layer runs K1."""
    with _decoding(model):
        if params is None:
            return model.encode(mel)[0]
        if any(isinstance(w, (QTensor, Q4Tensor)) for w in _leaves(params)):
            params = dequantize_params(params)
        state = {"m." + k: v for k, v in _module_state(params).items()}
        return torch.func.functional_call(_Encoder(model), state, (mel,))


def _whisper_tree(model: WhisperMoP, params: Optional[dict]) -> dict:
    return (whisper_decode_params(model) if params is None else params)["params"]


def whisper_decode_prep(model: WhisperMoP, mel: Tensor,
                        kv_dtype: torch.dtype = torch.float32,
                        params: Optional[dict] = None) -> Tuple[Tensor, Tensor]:
    """One encoder pass and every decoder layer's cross-attention K/V:
    ``(cross_k, cross_v)``, each (L, B, H, T_enc, dh) in ``kv_dtype``
    (float32 or bfloat16). ``params``: ``whisper_decode_params(model)`` or
    its ``ops.quant`` form (None: the model's own). Int8 rows need their
    per-row scales, which ``whisper_transcribe_cached`` makes; an int8
    ``kv_dtype`` raises here."""
    if kv_dtype == torch.int8:
        raise ValueError("whisper_decode_prep: int8 cross K/V need per-row scales; "
                         "use whisper_transcribe_cached(kv_dtype=torch.int8)")
    h = model.cfg.n_head
    enc_out = whisper_encode(model, mel, params)
    p = _whisper_tree(model, params)
    ks, vs = [], []
    with torch.no_grad():
        for li in range(model.cfg.n_layer_dec):
            cp = p[f"decoder_{li}"]["cross_attn"]
            ks.append(_split_heads(_lin(enc_out, cp["k_proj"]), h))
            vs.append(_split_heads(_lin(enc_out, cp["v_proj"]), h))
    return torch.stack(ks).to(kv_dtype), torch.stack(vs).to(kv_dtype)


@torch.no_grad()
def whisper_decode_step_rows(model: WhisperMoP, params: Optional[dict], cross_k: Tensor,
                             cross_v: Tensor, ks: Tensor, vs: Tensor, tokens: Tensor,
                             lens: Union[int, Tensor],
                             scales: Optional[Dict[str, Tensor]] = None):
    """Advance every row one exact cached decoder token, each at its own
    position.

    ``cross_k`` / ``cross_v`` (L, B, H, T_enc, dh): each row's
    cross-attention memory; ``ks`` / ``vs`` (L, B, H, win, dh): the
    self-attention caches, row b's new K/V written in place at ``lens[b]``;
    ``tokens`` (B,), ``lens`` (B,) or an int shared by every row. Returns ``(logits (B, vocab), ks, vs)``.
    ``scales``: for int8 caches, a dict of per-row fp32 scales, ``k_s`` and
    ``v_s`` (L, B, H, win) for the self-attention rows (this token's rows
    are quantized and their scales written here) and ``cross_k_s`` /
    ``cross_v_s`` (L, B, H, T_enc). ``params``: the JAX-layout tree (None:
    ``whisper_decode_params(model)``, rebuilt on every call), read through
    ``_lin``, so its kernels may be int8 / int4. Call it in eval mode
    without autograd, as the transcription does."""
    cfg = model.cfg
    p = _whisper_tree(model, params)
    h = cfg.n_head
    if isinstance(lens, Tensor):  # each row's new rows at its own length
        at = (torch.arange(tokens.shape[0], device=tokens.device), slice(None),
              lens.clamp_max(ks.shape[3] - 1))
        text_pos = lens.clamp_max(cfg.n_text_ctx - 1)[:, None]
    else:
        at, text_pos = (slice(None), slice(None), lens), lens
    x = p["wte"]["embedding"][tokens][:, None, :]
    if cfg.use_abs_pos_emb:
        x = x + p["text_pos"]["embedding"][text_pos]
    for li in range(cfg.n_layer_dec):
        bp = p[f"decoder_{li}"]
        sp = bp["self_attn"]
        hx = _ln(x, bp["ln1"])
        q = _split_heads(_lin(hx, sp["q_proj"]), h)
        k_new = _split_heads(_lin(hx, sp["k_proj"]), h)
        v_new = _split_heads(_lin(hx, sp["v_proj"]), h)
        if scales is not None:  # int8: quantize the new rows, each with its scale
            k_new, k_s = _q8_rows(k_new)
            v_new, v_s = _q8_rows(v_new)
            scales["k_s"][(li, *at)] = k_s[..., 0]
            scales["v_s"][(li, *at)] = v_s[..., 0]
        ks[(li, *at)] = k_new[:, :, 0].to(ks.dtype)
        vs[(li, *at)] = v_new[:, :, 0].to(vs.dtype)
        self_sc = None if scales is None else (scales["k_s"][li], scales["v_s"][li])
        y = _mha(q, ks[li], vs[li], n_valid=lens + 1, scales=self_sc)
        x = x + _lin(_merge_heads(y), sp["o_proj"])
        cp = bp["cross_attn"]
        qc = _split_heads(_lin(_ln(x, bp["ln2"]), cp["q_proj"]), h)
        cross_sc = None if scales is None else (scales["cross_k_s"][li],
                                                scales["cross_v_s"][li])
        x = x + _lin(_merge_heads(_mha(qc, cross_k[li], cross_v[li], scales=cross_sc)),
                     cp["o_proj"])
        mp = bp["mlp"]
        x = x + _lin(gelu_tanh(_lin(_ln(x, bp["ln3"]), mp["fc"])), mp["proj"])
    logits = (_ln(x, p["dec_ln_f"]) @ p["wte"]["embedding"].t())[:, 0]
    return logits, ks, vs


def whisper_decode_token(model: WhisperMoP, tok: Tensor, pos: int, ks: Tensor, vs: Tensor,
                         cross_k: Tensor, cross_v: Tensor,
                         scales: Optional[Dict[str, Tensor]] = None,
                         params: Optional[dict] = None):
    """One exact cached decoder step for (B,) tokens at position ``pos``
    (``whisper_decode_step_rows`` with every row there): writes this
    token's self-attention K/V rows at ``pos`` of the (L, B, H, win, dh)
    caches ``ks``/``vs`` in place and returns ``(logits (B, vocab), ks,
    vs)``, and with int8 ``scales`` the dict as a fourth element."""
    out = whisper_decode_step_rows(model, params, cross_k, cross_v, ks, vs, tok, pos,
                                   scales=scales)
    return out if scales is None else (*out, scales)


def _cached_step(model: WhisperMoP, tree: dict, cross_k: Tensor, cross_v: Tensor, ks: Tensor,
                 vs: Tensor, scales: Optional[Dict[str, Tensor]], tok: Tensor,
                 pos: Tensor) -> Tensor:
    """One cached step in place, as a CUDA graph of it replays (JAX's scan
    body): ``whisper_decode_step_rows`` of ``tok`` at ``pos`` (a (B,) device
    tensor), the caches (and int8 scales) written in place; ``tok`` becomes
    the argmax and ``pos`` advances by one. Returns ``tok``."""
    logits = whisper_decode_step_rows(model, tree, cross_k, cross_v, ks, vs, tok, pos,
                                      scales=scales)[0]
    tok.copy_(logits.argmax(-1))
    pos.add_(1)
    return tok


def whisper_transcribe_cached(model: WhisperMoP, mel: Tensor, bos_token: int, max_tokens: int,
                              kv_dtype: torch.dtype = torch.float32,
                              params: Optional[dict] = None, cuda_graph: bool = False) -> Tensor:
    """Greedy transcription with exact per-layer KV caches: (B, max_tokens)
    token ids, the tokens of ``whisper_transcribe``.

    ``kv_dtype=torch.bfloat16`` halves the cache storage and reads (compute
    stays in the model's dtype); ``torch.int8`` quantizes every cached row,
    self and cross, symmetrically with a per-row fp32 scale, applied after
    the products as in ``_mha``. ``params``: ``whisper_decode_params(model)``
    or its int8 / int4 form from ``ops.quant.quantize_params`` (None: the
    model's own); the encoder runs on its dequantized copy.

    ``cuda_graph=True`` (a CUDA model only, else a ValueError): the prep and
    the cross caches' quantization eager, then one cached step
    (``_cached_step``, its position a (B,) device tensor) as a CUDA graph
    replayed ``max_tokens`` times, as JAX's one ``lax.scan``; the tokens are
    the eager loop's."""
    if cuda_graph:
        require_graph("whisper_transcribe_cached", model.wte.weight.device)
    int8 = kv_dtype == torch.int8
    cfg = model.cfg
    b, win = mel.shape[0], max_tokens + 1
    shape = (cfg.n_layer_dec, b, cfg.n_head, win, cfg.n_embd // cfg.n_head)
    cross_k, cross_v = whisper_decode_prep(model, mel, torch.float32 if int8 else kv_dtype,
                                           params=params)
    tree = whisper_decode_params(model) if params is None else params
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
        if cuda_graph:
            step = StepGraph(functools.partial(
                _cached_step, model, tree, cross_k, cross_v, ks, vs, scales, tok,
                torch.zeros(b, dtype=torch.long, device=mel.device)), mel.device)
            return torch.stack([step() for _ in range(max_tokens)], 1)
        for i in range(max_tokens):
            logits = whisper_decode_token(model, tok, i, ks, vs, cross_k, cross_v,
                                          scales=scales, params=tree)[0]
            tok = logits.argmax(-1)
            outs.append(tok)
    return torch.stack(outs, 1)


def whisper_transcribe_auto(model: WhisperMoP, mel: Tensor, bos_token: int, max_tokens: int,
                            kv_dtype: torch.dtype = torch.float32,
                            params: Optional[dict] = None, cuda_graph: bool = False) -> Tensor:
    """Greedy transcription by the measured dispatch: with fp32 KV, the full
    window below ``config.whisper_cached_min_ctx`` tokens
    (``MOP_TPU_WHISPER_CACHED_MIN_CTX``) and the cached route from there on,
    the two giving the same tokens. Any other ``kv_dtype`` (bf16, int8)
    always takes the cached route, so that its rounding does not switch on
    and off with the requested length; so does a ``params`` tree (int8 /
    int4 weights), which only the cached route reads. ``cuda_graph`` is
    passed to the route taken."""
    if (kv_dtype == torch.float32 and params is None
            and max_tokens < run_config.whisper_cached_min_ctx):
        return whisper_transcribe(model, mel, bos_token, max_tokens, cuda_graph=cuda_graph)
    return whisper_transcribe_cached(model, mel, bos_token, max_tokens, kv_dtype=kv_dtype,
                                     params=params, cuda_graph=cuda_graph)


# ------------------------------ GPT family ------------------------------


@dataclass(frozen=True, eq=False)
class DecodeSplit:
    """How a tensor-parallel model splits the decode, made and kept at
    ``model.decode_split`` by ``parallel.tp.tp_shard_params``: this
    process's ``index`` of ``size`` on the model axis, its share of the
    heads ``n_head``, and each split linear's mode by its name in a block
    (``"attn.q_proj"``, ``"mlp.proj"``, ``"views.proj"``): ``"column"``
    (the output features split; the decode tree's bias is this process's
    slice), ``"row"`` (the input features split: the partial products
    summed by ``all_reduce``, the bias added once) or ``"row_alone"`` (a
    row linear whose input is whole, sliced first). ``all_reduce`` sums a
    tensor over the model axis in place, ``broadcast`` sends one in place
    from the axis' first process."""

    index: int
    size: int
    n_head: int
    modes: Dict[str, str]
    all_reduce: Callable[[Tensor], Tensor]
    broadcast: Callable[[Tensor], Tensor]


def decode_split_of(model: nn.Module) -> Optional[DecodeSplit]:
    """The model's ``DecodeSplit``: None unless it is tensor-parallel."""
    return getattr(model, "decode_split", None)


def local_heads(model: nn.Module) -> int:
    """The heads this process's decode computes and caches."""
    sp = decode_split_of(model)
    return model.config.n_head if sp is None else sp.n_head


def _lin_params(lin: nn.Linear, sp: Optional[DecodeSplit] = None, name: str = "") -> dict:
    p = {"kernel": lin.weight.detach().t()}
    if lin.bias is not None:
        p["bias"] = lin.bias.detach()
        if sp is not None and sp.modes.get(name) == "column":  # this process's rows
            n = p["kernel"].shape[1]
            p["bias"] = p["bias"].narrow(0, sp.index * n, n)
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
    ``ops.quant.quantize_params`` maps over it. A tensor-parallel model's
    tree (``parallel.tp.tp_shard_params``) holds this process's slices, the
    column biases sliced as the weights; ``decode_rows`` reads the model's
    ``DecodeSplit`` beside it: each process computes its heads and the row
    products' partial sums, summed over the model axis, so that the logits
    come out whole on every process."""
    cfg = model.config
    sp = decode_split_of(model)
    p = {"wte": {"embedding": model.wte.weight.detach()}}
    if cfg.use_abs_pos_emb:
        p["wpe"] = {"embedding": model.wpe.weight.detach()}
    names = ("q_proj", "k_proj", "v_proj", "o_proj")
    if cfg.use_quartet:
        names += ("q2_proj", "k2_proj")
    for i, blk in enumerate(model.blocks):
        attn = {n: _lin_params(getattr(blk.attn, n), sp, f"attn.{n}") for n in names}
        if cfg.use_quartet:
            attn["mixture"] = blk.attn.mixture.detach()
            attn["quartet_scale"] = blk.attn.quartet_scale.detach()
        bp = {"ln1": _ln_params(blk.ln1), "attn": attn, "ln2": _ln_params(blk.ln2),
              "mlp": {"fc": _lin_params(blk.mlp.fc, sp, "mlp.fc"),
                      "proj": _lin_params(blk.mlp.proj, sp, "mlp.proj")}}
        if hasattr(blk, "views"):  # GPT-MoP: torch's (out, in, k) convs as (k, in, out)
            bp["views"] = {"proj": _lin_params(blk.views.proj, sp, "views.proj")}
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
    thr = torch.where(keep, srt, srt.new_full((), float("inf"))).amin(-1, keepdim=True)
    return torch.where(scaled >= thr, scaled, scaled.new_full((), float("-inf")))


def _min_p_mask(scaled: Tensor, min_p: float) -> Tensor:
    """min-p filter: keep tokens of probability at least ``min_p`` times the
    largest, i.e. ``logit >= max_logit + log(min_p)`` (log taken in fp32)."""
    thr = scaled.amax(-1, keepdim=True) + torch.log(torch.tensor(min_p, dtype=torch.float32))
    return torch.where(scaled >= thr, scaled, scaled.new_full((), float("-inf")))


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
        scaled = torch.where(scaled < kth, scaled.new_full((), float("-inf")), scaled)
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


def _window_step(model: nn.Module, window: Tensor, length: Tensor, pick,
                 generator: Optional[torch.Generator], ocounts, pcounts) -> Tensor:
    """One step of the exact sampler in place, as a CUDA graph of it replays
    (JAX's scan body): the eval forward on the (B, block) ``window``, the
    logits at ``length - 1`` (a 0-dim device tensor), the pick and the
    counts; then the window rolls left where it is full and the token is
    written at ``min(length, block - 1)`` (a one-hot select), and ``length``
    becomes ``min(length + 1, block)``. Returns the (B,) token."""
    block = window.shape[1]
    logits = model(window)[0].index_select(1, (length - 1).reshape(1))[:, 0]
    nxt = pick(logits, generator, ocounts, pcounts)
    _add_counts(pick, ocounts, nxt)
    full = length >= block
    shifted = torch.where(full, window.roll(-1, 1), window)
    at = torch.arange(block, device=window.device) == torch.where(full, block - 1, length)
    window.copy_(torch.where(at, nxt[:, None], shifted))
    length.copy_((length + 1).clamp_max(block))
    return nxt


def generate(model: nn.Module, prompt: Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None, temperature: float = 1.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             min_p: Optional[float] = None, repetition_penalty: Optional[float] = None,
             presence_penalty: Optional[float] = None,
             frequency_penalty: Optional[float] = None, cuda_graph: bool = False) -> Tensor:
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
    layer of every step runs K5.

    ``cuda_graph=True`` (a CUDA model only, else a ValueError): one step
    (``_window_step``: the forward, the pick, the counts and the fill or
    roll, the live length a 0-dim device tensor) is one CUDA graph over a
    static window, replayed ``max_new_tokens`` times, as JAX's one
    ``lax.scan``; a sampled draw comes from the registered ``generator``.
    The tokens are the eager loop's."""
    block = model.config.block_size
    b, t0 = prompt.shape
    if t0 < 1:
        raise ValueError("generate: the prompt needs at least one token")
    if cuda_graph:
        require_graph("generate", model.wte.weight.device)
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
        if cuda_graph:
            draws = generator if not greedy else None
            step = StepGraph(functools.partial(
                _window_step, model, window, torch.full((), length, device=prompt.device),
                pick, draws, ocounts, pcounts), prompt.device, (draws,))
            toks = [step() for _ in range(max_new_tokens)]
        else:
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
    """The fp32 LayerNorm of ``layers.LayerNorm`` over a tree node."""
    return nnF.layer_norm(x.float(), x.shape[-1:], p["scale"], p["bias"], eps)


def _lin(x: Tensor, p: dict, sp: Optional[DecodeSplit] = None, name: str = "") -> Tensor:
    """``x @ kernel (+ bias)``, the kernel fp32, ``QTensor`` or ``Q4Tensor``,
    plus the per-row LoRA delta where the node carries ``lora_a``/``lora_b``
    (the serving engine's adapter bank, ``serving.engine.lora_params_view``).
    Under a ``DecodeSplit`` the linear ``name`` of a block computes this
    process's share and a row one sums it with ``sp.all_reduce``."""
    mode = None if sp is None else sp.modes.get(name)
    if mode is None or mode == "column":
        return _lin_local(x, p, p.get("bias"))
    if mode == "row_alone":  # this process's features of a whole input
        n = x.shape[-1] // sp.size
        x = x.narrow(-1, sp.index * n, n)
    y = sp.all_reduce(_lin_local(x, p, None))
    return y + p["bias"] if "bias" in p else y


def _lin_local(x: Tensor, p: dict, bias: Optional[Tensor]) -> Tensor:
    k = p["kernel"]
    if "lora_a" not in p and not isinstance(k, (QTensor, Q4Tensor)):
        return nnF.linear(x, k.t(), bias)  # one fused product and bias
    if isinstance(k, QTensor):
        y = qmatmul(x, k)
    elif isinstance(k, Q4Tensor):
        y = q4matmul(x, k)
    else:
        y = x @ k
    if "lora_a" in p:
        # per-row LoRA factors, lora_a (B, din, r) and lora_b (B, r, dout):
        # row b holds its request's adapter (zeros: none), y_b += x_b A_b B_b
        t = torch.einsum("b...d,bdr->b...r", x, p["lora_a"])
        y = y + torch.einsum("b...r,bro->b...o", t, p["lora_b"]).to(y.dtype)
    if bias is not None:
        y = y + bias
    return y


def _per_row(n_valid: Union[int, Tensor]) -> bool:
    """Whether a length is per row (a (B,) or (B | 1, G) tensor), not shared
    by every row (an int, or a 0-dim tensor on the device)."""
    return isinstance(n_valid, Tensor) and n_valid.dim() > 0


def _cols_mask(n_cols: int, n_valid: Union[int, Tensor], device) -> Tensor:
    """(1 | B, 1, 1 | G, n_cols) bool mask of the valid prefix; ``n_valid``
    is a shared length (an int or a 0-dim tensor), a (B,) tensor (per-row
    lengths) or a (B | 1, G) tensor (per row and query position)."""
    cols = torch.arange(n_cols, device=device)
    if _per_row(n_valid):
        return cols < n_valid.reshape(n_valid.shape[0], 1, -1, 1)
    return (cols < n_valid)[None, None, None, :]


def _standardize_rows(s: Tensor, n_valid: Union[int, Tensor], eps: float) -> Tensor:
    """Unbiased row standardization over the first ``n_valid`` columns: the
    mean over them, the squared deviations summed over them and divided by
    ``max(n - 1, 1)``, eps added after the sqrt. ``n_valid``: as
    ``_cols_mask`` takes it. A shared length on the device (a 0-dim tensor,
    as a CUDA graph reads it) multiplies by the reciprocals, which is what
    CUDA's division by a host number computes: on the card its results are
    those of the same int length."""
    cols = _cols_mask(s.shape[-1], n_valid, s.device)
    zero = s.new_zeros(())
    if _per_row(n_valid):
        n = n_valid.clamp_min(1).reshape(n_valid.shape[0], 1, -1, 1).to(s.dtype)
        dof = (n - 1.0).clamp_min(1.0)
    elif isinstance(n_valid, Tensor):
        n = n_valid.clamp_min(1).to(s.dtype)
        inv_dof = (n - 1.0).clamp_min(1.0).reciprocal()
        mu = torch.where(cols, s, zero).sum(-1, keepdim=True) * n.reciprocal()
        var = torch.where(cols, (s - mu).square(), zero).sum(-1, keepdim=True) * inv_dof
        return (s - mu) / (torch.sqrt(var) + eps)
    else:
        n = float(max(n_valid, 1))
        dof = max(n - 1.0, 1.0)
    mu = torch.where(cols, s, zero).sum(-1, keepdim=True) / n
    var = torch.where(cols, (s - mu).square(), zero).sum(-1, keepdim=True) / dof
    return (s - mu) / (torch.sqrt(var) + eps)


def init_decode_cache(config, batch: int, dtype: torch.dtype = torch.float32, n_views: int = 0,
                      device=None, n_head: Optional[int] = None) -> dict:
    """Per-layer (k, k2, v) caches of shape (L, B, H, block, dk) and the live
    length ``len`` (an int). ``dtype=torch.int8`` stores int8 rows with
    per-row fp32 scales ``k_s``/``k2_s``/``v_s`` (L, B, H, block), applied
    after the products. ``n_views > 0`` (GPT-MoP) adds the view history
    ``mv`` (L, B, block, V) in fp32, the gate conv's taps. ``n_head``: the
    heads this process holds (a tensor-parallel model's share; default all).
    On the GPU unless ``device`` is given."""
    device = resolve_device(device)
    L, h = config.n_layer, n_head or config.n_head
    shape = (L, batch, h, config.block_size, config.n_embd // config.n_head)
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


def _mop_gate_full(bp: dict, x: Tensor, t_live=None, causal: bool = False,
                   sp: Optional[DecodeSplit] = None):
    """The full-window gate for prefill from the post-attention activations
    x (B, T, C): ``(gate (B, T), views (B, T, V))`` as the module computes
    them (views, the k-tap conv left-padded when ``causal``, else centred,
    the 1x1 fuse). ``t_live`` (an int or a (B,) tensor): views at positions
    from it on are zeroed before the conv, so that pads do not reach the
    taps. ``sp``: the model's ``DecodeSplit``, if any."""
    v = _lin(x, bp["views"]["proj"], sp, "views.proj")
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


def _mlp(x: Tensor, bp: dict, sp: Optional[DecodeSplit] = None) -> Tensor:
    h = gelu_tanh(_lin(_ln(x, bp["ln2"]), bp["mlp"]["fc"], sp, "mlp.fc"))
    return x + _lin(h, bp["mlp"]["proj"], sp, "mlp.proj")


def _kv_rows(p: dict, cfg, x: Tensor, h: int, sp: Optional[DecodeSplit] = None):
    """This token's k, k2, v rows (B, H, 1, dk) from the ln1 activations
    (k2 is k without Quartet), over ``h`` heads."""
    k = _split_heads(_lin(x, p["k_proj"], sp, "attn.k_proj"), h)
    v = _split_heads(_lin(x, p["v_proj"], sp, "attn.v_proj"), h)
    k2 = _split_heads(_lin(x, p["k2_proj"], sp, "attn.k2_proj"), h) if cfg.use_quartet else k
    return k, k2, v


def _shared_at(pos: Tensor, g: int) -> Tensor:
    """Positions ``pos .. pos + g - 1`` of a shared length on the device."""
    return pos + torch.arange(g, device=pos.device)


def _write_rows(cache: dict, i: int, pos: Union[int, Tensor], new,
                rows: Optional[Tensor] = None) -> Optional[tuple]:
    """Write layer i's new (k, k2, v) rows (B, H, G, dk) in place: at
    positions ``pos .. pos + G - 1`` of every batch row (``pos`` an int or a
    0-dim tensor), or row b's at ``pos[b]`` (a (B, G) tensor; positions
    past the window are clamped to its last column, which no live row
    reads) of the cache's batch row ``rows[b]`` ((B, 1), default b). Int8
    caches get the rows quantized per row, their scales beside. Returns the
    layer's int8 scales, else None."""
    shared = not _per_row(pos)
    if not shared:
        pos = pos.clamp_max(cache["k"].shape[3] - 1)
        if rows is None:
            rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    for key, r in zip(("k", "k2", "v"), new):
        if "k_s" in cache:
            r, s = _q8_rows(r)
            if not shared:
                cache[key + "_s"][i, rows, :, pos] = s.transpose(1, 2)
            elif isinstance(pos, Tensor):
                cache[key + "_s"][i].index_copy_(2, _shared_at(pos, s.shape[-1]), s)
            else:
                cache[key + "_s"][i, :, :, pos:pos + s.shape[-1]] = s
        if not shared:
            cache[key][i, rows, :, pos] = r.transpose(1, 2).to(cache[key].dtype)
        elif isinstance(pos, Tensor):
            cache[key][i].index_copy_(2, _shared_at(pos, r.shape[2]), r.to(cache[key].dtype))
        else:
            cache[key][i, :, :, pos:pos + r.shape[2]] = r.to(cache[key].dtype)
    if "k_s" in cache:
        return cache["k_s"][i], cache["k2_s"][i], cache["v_s"][i]
    return None


def _params(model: nn.Module, params: Optional[dict]) -> dict:
    return (decode_params(model) if params is None else params)["params"]


def decode_step_rows(model: nn.Module, params: Optional[dict], cache: dict, tokens: Tensor,
                     lens: Union[int, Tensor]):
    """Advance every row one token, each at its own position.

    ``tokens`` (B,): each row's current token, appended this step; ``lens``:
    each row's live length before the append, a (B,) tensor, or an int
    shared by every row. Returns ``(logits (B, vocab), cache)``: the new
    K/K2/V rows are written in place at each row's length, and the returned
    dict (sharing the buffers) has ``len = lens + 1``. Row b's output
    depends on row b's tokens only. GPT-MoP's gate is applied between
    attention and MLP from the view history: exact for the causal gate,
    frontier-approximate for the centred one (``_mop_taps``)."""
    logits, cache = decode_chunk_rows(model, params, cache, tokens[:, None], lens)
    return logits[:, 0], cache


class SlotRows:
    """The dense cache's access for ``decode_rows``: row b's window is slot b
    of every (L, B, H, W, dk) pool (GPT-MoP's view history (L, B, W, V)),
    written in place at each row's positions (``_write_rows``)."""

    def __init__(self, cache: dict):
        self.cache = cache
        self.width = cache["k"].shape[3]

    def write(self, i: int, pos: Union[int, Tensor], new) -> Optional[tuple]:
        return _write_rows(self.cache, i, pos, new)

    def window(self, key: str, i: int) -> Tensor:
        return self.cache[key][i]

    def write_views(self, i: int, pos: Union[int, Tensor], views: Tensor) -> None:
        mv = self.cache["mv"]
        if _per_row(pos):
            rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
            mv[i, rows, pos.clamp_max(mv.shape[2] - 1)] = views
        elif isinstance(pos, Tensor):
            mv[i].index_copy_(1, _shared_at(pos, views.shape[1]), views)
        else:
            mv[i, :, pos:pos + views.shape[1]] = views

    def views(self, i: int) -> Tensor:
        return self.cache["mv"][i]


class OneSlotRows:
    """The dense cache's access for a one-row ``decode_rows`` into one slot:
    row 0's window is the slot that ``slot`` (a (1,) device index) names,
    its new rows written in place at ``[i, slot, :, pos]`` (``pos`` (1, G);
    positions past the window clamped to its last column, which no live row
    reads), its windows read by ``index_select``: the serving engines'
    prefix tail and prefill chunk, one body for every slot."""

    def __init__(self, cache: dict, slot: Tensor):
        self.cache, self.slot = cache, slot
        self.width = cache["k"].shape[3]

    def write(self, i: int, pos: Tensor, new) -> Optional[tuple]:
        scales = _write_rows(self.cache, i, pos, new, rows=self.slot[:, None])
        return None if scales is None else tuple(s.index_select(0, self.slot) for s in scales)

    def window(self, key: str, i: int) -> Tensor:
        return self.cache[key][i].index_select(0, self.slot)

    def write_views(self, i: int, pos: Tensor, views: Tensor) -> None:
        mv = self.cache["mv"]
        mv[i, self.slot[:, None], pos.clamp_max(mv.shape[2] - 1)] = views

    def views(self, i: int) -> Tensor:
        return self.window("mv", i)


def decode_rows(model: nn.Module, params: Optional[dict], rows, tokens: Tensor,
                lens: Union[int, Tensor]) -> Tensor:
    """The per-layer body of every cached step: (B, G) tokens appended at
    ``lens[b] .. lens[b] + G - 1`` (``lens`` a (B,) tensor, or an int shared
    by every row) -> logits (B, G, vocab). ``rows`` is the cache's access
    (``SlotRows``, ``OneSlotRows``, or the paged engine's page tables):
    ``write`` puts layer
    i's new K/K2/V rows at the positions (returning int8 scales or None),
    ``window`` gives layer i's (B, H, W, dk) window of a buffer in position
    order, ``write_views`` / ``views`` the same for GPT-MoP's view history.
    Chunk position g of row b standardizes and attends over its
    ``lens[b] + g + 1`` live columns, masked with ``where`` / -inf, so that
    nothing in a column past them reaches a result. A shared length may be a
    0-dim tensor on the device: the form a CUDA graph of the step replays."""
    cfg = model.config
    p = _params(model, params)
    b, g = tokens.shape
    sp = decode_split_of(model)
    h = local_heads(model)
    dev = tokens.device
    shared = not _per_row(lens)  # one length for every row
    steps = torch.arange(g, device=dev)
    pos = (lens + steps)[None] if shared else lens[:, None] + steps[None, :]  # (1 | B, G)
    wpos = lens if shared else pos  # where the new rows go
    # each position's live-prefix length; an int for one shared position
    nv = lens + 1 if shared and g == 1 else pos + 1
    cols = _cols_mask(rows.width, nv, dev)
    causal_gate = bool(getattr(model, "causal_gate", False))
    with torch.no_grad():
        x = p["wte"]["embedding"][tokens]
        if cfg.use_abs_pos_emb:  # a held row may sit at the window's end
            x = x + p["wpe"]["embedding"][pos.clamp_max(cfg.block_size - 1)]
        for i in range(cfg.n_layer):
            bp = p[f"blocks_{i}"]
            ap = bp["attn"]
            hx = _ln(x, bp["ln1"])
            q = _split_heads(_lin(hx, ap["q_proj"], sp, "attn.q_proj"), h)
            scale = 1.0 / math.sqrt(q.shape[-1])
            sc = rows.write(i, wpos, _kv_rows(ap, cfg, hx, h, sp))
            qk = q @ rows.window("k", i).to(q.dtype).transpose(-1, -2) * scale
            if sc is not None:
                qk = qk * sc[0][:, :, None, :]
            if cfg.use_quartet:
                q2 = _split_heads(_lin(hx, ap["q2_proj"], sp, "attn.q2_proj"), h)
                q2k2 = q2 @ rows.window("k2", i).to(q2.dtype).transpose(-1, -2) * scale
                if sc is not None:
                    q2k2 = q2k2 * sc[1][:, :, None, :]
                m = torch.sigmoid(ap["mixture"][0])
                s1 = _standardize_rows(qk, nv, cfg.score_norm_eps)
                s2 = _standardize_rows(q2k2, nv, cfg.score_norm_eps)
                scores = (1.0 - m) * s1 + m * (s1 * s2) * ap["quartet_scale"][0]
            else:  # the single path's eps is 1e-5 whatever the config says
                scores = _standardize_rows(qk, nv, 1e-5)
            att = torch.softmax(scores.masked_fill(~cols, float("-inf")), -1)
            if sc is not None:
                att = att * sc[2][:, :, None, :]
            y = _merge_heads(att @ rows.window("v", i).to(att.dtype))
            x = x + _lin(y, ap["o_proj"], sp, "attn.o_proj")
            if "views" in bp:  # per row and chunk position, taps <= pos
                rows.write_views(i, wpos, _lin(x, bp["views"]["proj"], sp, "views.proj"))
                x = x * _mop_gates(bp, rows.views(i), pos.expand(b, g), causal_gate)[..., None]
            x = _mlp(x, bp, sp)
        return _ln(x, p["ln_f"]) @ p["wte"]["embedding"].t()


def decode_chunk_rows(model: nn.Module, params: Optional[dict], cache: dict, tokens: Tensor,
                      lens: Union[int, Tensor]):
    """Advance every row G tokens, each from its own position: (B, G) tokens
    appended at ``lens[b] .. lens[b] + G - 1`` (``lens`` a (B,) tensor, or
    an int shared by every row) -> ``(logits (B, G, vocab), cache)`` with
    ``len = lens + G``. Chunk position g of row b standardizes and attends
    over its ``lens[b] + g + 1`` live columns: the composition of G
    ``decode_step_rows`` calls. The chunk's rows are written (in place)
    before the attention, so that the causal mask covers the chunk."""
    logits = decode_rows(model, params, SlotRows(cache), tokens, lens)
    return logits, dict(cache, len=lens + tokens.shape[1])


def decode_step(model: nn.Module, params: Optional[dict], cache: dict, token: Tensor):
    """One cached decode step: (B,) tokens -> (logits (B, vocab), cache).

    ``decode_step_rows`` at the shared length ``cache["len"]`` (an int):
    the token's rows are written there into the cache's buffers in place
    (the caller keeps the window from filling); the returned dict shares
    them and has ``len`` advanced by one. ``params``: ``decode_params(model)``
    or its ``ops.quant`` form (None: the model's own)."""
    return decode_step_rows(model, params, cache, token, cache["len"])


def decode_chunk(model: nn.Module, params: Optional[dict], cache: dict, tokens: Tensor):
    """A cached forward over G new tokens at positions ``len .. len + G - 1``:
    (B, G) tokens -> (logits (B, G, vocab), cache with ``len`` advanced by G).
    ``decode_chunk_rows`` at the shared length ``cache["len"]``: equal to G
    sequential ``decode_step`` calls. The verify pass of speculative
    decoding."""
    return decode_chunk_rows(model, params, cache, tokens, cache["len"])


def _prefill(model: nn.Module, params: Optional[dict], prompt: Tensor, t0, kv_dtype):
    """The shared body of ``prefill`` and ``prefill_padded``: a forward over
    the (B, T) prompt whose first ``t0`` columns are live (``t0 = T`` in
    ``prefill``), each score row standardized over the live columns (or its
    causal prefix with ``causal_std``), every layer's rows written to a
    fresh cache. Returns the ln_f activations and the cache. ``t0`` is the
    int ``T`` (``prefill``: every column live, the unmasked form) or a 0-dim
    tensor on the prompt's device (``prefill_padded``: the masked form
    whatever its value, ``t0 = T`` included, the form a CUDA graph of one
    bucket replays). The masked statistics multiply by the live count's
    reciprocals, as ``_standardize_rows``' do."""
    cfg = model.config
    p = _params(model, params)
    b, t = prompt.shape
    dev = prompt.device
    sp = decode_split_of(model)
    h = local_heads(model)
    cache = init_decode_cache(cfg, b, kv_dtype, n_views=model_n_views(model), device=dev,
                              n_head=h)
    causal_gate = bool(getattr(model, "causal_gate", False))
    padded = isinstance(t0, Tensor)
    live = torch.arange(t, device=dev) < t0
    keep = torch.ones(t, t, dtype=torch.bool, device=dev).tril() & live[None, :]
    zero = torch.zeros((), device=dev)
    if padded:  # the live count, 1 at least, and the unbiased divisor's reciprocals
        n_live = t0.clamp_min(1).float()
        inv_n, inv_dof = n_live.reciprocal(), (n_live - 1.0).clamp_min(1.0).reciprocal()

    def std(s, eps=cfg.score_norm_eps):
        if cfg.causal_std:  # row i's prefix is live for every live row
            return standardize_scores_causal(s, eps)
        if not padded:  # unbiased, over all t columns
            mu = s.mean(-1, keepdim=True)
            var = (s - mu).square().sum(-1, keepdim=True) / max(1, t - 1)
            return (s - mu) / (torch.sqrt(var) + eps)
        m = live[None, None, None, :]
        mu = torch.where(m, s, zero).sum(-1, keepdim=True) * inv_n
        var = torch.where(m, (s - mu).square(), zero).sum(-1, keepdim=True) * inv_dof
        return (s - mu) / (torch.sqrt(var) + eps)

    with torch.no_grad():
        x = p["wte"]["embedding"][prompt]
        if cfg.use_abs_pos_emb:
            x = x + p["wpe"]["embedding"][:t][None]
        for i in range(cfg.n_layer):
            bp = p[f"blocks_{i}"]
            ap = bp["attn"]
            hx = _ln(x, bp["ln1"])
            q, k, v = (_split_heads(_lin(hx, ap[n], sp, f"attn.{n}"), h)
                       for n in ("q_proj", "k_proj", "v_proj"))
            scale = 1.0 / math.sqrt(q.shape[-1])
            qk = q @ k.transpose(-1, -2) * scale
            if cfg.use_quartet:
                q2 = _split_heads(_lin(hx, ap["q2_proj"], sp, "attn.q2_proj"), h)
                k2 = _split_heads(_lin(hx, ap["k2_proj"], sp, "attn.k2_proj"), h)
                m = torch.sigmoid(ap["mixture"][0])
                s1 = std(qk)
                scores = ((1.0 - m) * s1
                          + m * (s1 * std(q2 @ k2.transpose(-1, -2) * scale))
                          * ap["quartet_scale"][0])
            else:
                k2 = k
                scores = std(qk, 1e-5)
            att = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1)
            # a pad row's scores are all masked: its NaN weights become 0
            att = torch.nan_to_num(att, nan=0.0) if padded else att
            x = x + _lin(_merge_heads(att @ v), ap["o_proj"], sp, "attn.o_proj")
            if "views" in bp:  # the MoP gate; pad views zeroed before the conv
                gate, vmaps = _mop_gate_full(bp, x, t_live=t0 if padded else None,
                                             causal=causal_gate, sp=sp)
                cache["mv"][i, :, :t] = vmaps
                x = x * gate[..., None]
            x = _mlp(x, bp, sp)
            _write_rows(cache, i, 0, (k, k2, v))
        x = _ln(x, p["ln_f"])
    cache["len"] = t0
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


def prefill_padded(model: nn.Module, params: Optional[dict], prompt_padded: Tensor,
                   t0: Union[int, Tensor], kv_dtype: torch.dtype = torch.float32):
    """Prefill over a padded (B, T_pad) prompt whose first ``t0`` columns are
    the real one: ``prefill``'s logits and first ``t0`` cache rows (pad
    columns are masked out of every row's statistics), ``len = t0``. Rows
    past ``t0`` are written too and are garbage, masked by ``len`` and
    overwritten by later appends. ``t0`` an int or a 0-dim tensor, taken to
    the prompt's device: one body for every ``t0`` of the bucket, the form
    the serving engines' admission graph replays, read at ``t0 - 1`` on the
    device."""
    t0 = torch.as_tensor(t0, device=prompt_padded.device)
    x, cache = _prefill(model, params, prompt_padded, t0, kv_dtype)
    last = x.index_select(1, (t0 - 1).reshape(1))[:, 0]
    return last @ _params(model, params)["wte"]["embedding"].t(), cache


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


def _advance(model: nn.Module, params: dict, cache: dict, tok: Tensor, lens: Tensor, pick,
             generator: Optional[torch.Generator], ocounts, pcounts) -> Tensor:
    """One decode step in place, as a CUDA graph of it replays: ``tok`` (B,)
    becomes the token picked after it, the shared length ``lens`` (a 0-dim
    device tensor) advances by one, the counts take the token. Returns
    ``tok``."""
    logits, _ = decode_step_rows(model, params, cache, tok, lens)
    nxt = pick(logits, generator, ocounts, pcounts)
    _add_counts(pick, ocounts, nxt)
    tok.copy_(nxt)
    lens.add_(1)
    return tok


def _decode_graphed(model: nn.Module, params: dict, cache: dict, tok: Tensor, n: int, w: int,
                    pick, generator, ocounts, pcounts) -> List[Tensor]:
    """``n`` tokens after ``tok`` by ``_advance`` captured once per window
    width (a ``StepGraph`` each, the length in a device buffer), the cache
    resized between widths outside the graphs, as JAX runs one jitted
    segment per width."""
    t, block = cache["len"], model.config.block_size
    tok = tok.clone()
    lens = torch.full((), t, dtype=torch.long, device=tok.device)
    toks, graph = [], None
    for _ in range(n):
        if t == w:  # the window is full: double it
            w = min(2 * w, block)
            cache, graph = _resize(cache, w), None
        if graph is None:
            graph = StepGraph(functools.partial(_advance, model, params, cache, tok, lens, pick,
                                                generator, ocounts, pcounts),
                              tok.device, (generator,))
        toks.append(graph())
        t += 1
    return toks


def generate_cached(model: nn.Module, params: Optional[dict], prompt: Tensor,
                    max_new_tokens: int, generator: Optional[torch.Generator] = None,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, kv_dtype: torch.dtype = torch.float32,
                    grow_window: bool = False, min_p: Optional[float] = None,
                    repetition_penalty: Optional[float] = None,
                    presence_penalty: Optional[float] = None,
                    frequency_penalty: Optional[float] = None,
                    cuda_graph: bool = False) -> Tensor:
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
    ``T0 + max_new_tokens <= block_size``.

    ``cuda_graph=True`` (a CUDA device only, else a ValueError): each decode
    step (the cached step, the pick and the counts) is one CUDA graph per
    window width, its length a device tensor; a sampled draw comes from the
    registered ``generator``. The tokens are the eager loop's.
    """
    cfg = model.config
    b, t0 = prompt.shape
    if t0 + max_new_tokens > cfg.block_size:
        raise ValueError(f"generate_cached: t0 + max_new_tokens = {t0 + max_new_tokens} "
                         f"exceeds block_size {cfg.block_size}")
    greedy = generator is None or temperature == 0.0
    params = decode_params(model) if params is None else params
    if cuda_graph:
        require_graph("generate_cached", params["params"]["wte"]["embedding"].device)
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
    if cuda_graph:
        toks = [tok] + _decode_graphed(model, params, cache, tok, max_new_tokens - 1, w, pick,
                                       generator if not greedy else None, ocounts, pcounts)
        return torch.cat([prompt, torch.stack(toks, 1)], 1)
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
