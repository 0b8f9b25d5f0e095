"""Text embeddings from the causal-LM families (OpenAI ``/v1/embeddings``),
the port of ``mop_tpu/serving/embeddings.py``.

One padded forward over the GPT family (baseline, Quartet, GPT-MoP), the
final LayerNorm output masked-mean-pooled over the real positions (or the
last real one) and L2-normalized (the OpenAI convention: unit-norm vectors,
cosine == dot).

Right-padding must be exact, and causality alone does not make it so: the
Quartet and baseline attention standardize each score row over all key
columns before the mask, so a pad column would leak into every real row's
mean and deviation. The forward therefore recomputes the stack with per-row
length masks, row statistics and softmax over each sequence's first ``len``
columns only (``prefill_padded``'s treatment with a per-row length), and
GPT-MoP's gate zeroes the pads' views before its conv (``_mop_gate_full``).
Batches are padded to powers of two in batch and length, as in JAX (there
they bound the compiles), so that a request's vector does not depend on
what it is batched with beyond rounding. Plain torch ops, no kernel.
"""

from __future__ import annotations

import base64
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.generate import _lin, _ln, _mlp, _mop_gate_full, _split_heads, _merge_heads, decode_params
from ..ops.attention import standardize_scores_causal


def _pow2_at_least(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


class EmbeddingModel:
    """Pooled-hidden-state embedder over a GPT-family model.

    >>> emb = EmbeddingModel(model, params)
    >>> vecs = emb.embed([[5, 17, 3], [9, 8, 7, 6]])   # (2, n_embd)

    ``params``: ``decode_params(model)`` (or its bare ``["params"]`` tree, or
    None: the model's own); the forward runs on their device. ``pool``:
    ``"mean"`` (masked mean over positions, the default) or ``"last"`` (the
    final real token's hidden state). ``normalize``: L2-normalize (default).
    ``max_chunk``: the most rows of one forward."""

    def __init__(self, model, params: Optional[dict] = None, pool: str = "mean",
                 normalize: bool = True, max_chunk: int = 32):
        if pool not in ("mean", "last"):
            raise ValueError(f"pool must be 'mean' or 'last', got {pool!r}")
        self.model = model
        params = decode_params(model) if params is None else params
        self.params = params["params"] if "params" in params else params
        self.device = self.params["wte"]["embedding"].device
        self.pool = pool
        self.normalize = normalize
        self.block_size = model.config.block_size
        self.n_embd = model.config.n_embd
        self.vocab_size = model.wte.num_embeddings
        self.max_chunk = max(1, int(max_chunk))

    def _forward(self, idx: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """The length-masked forward of (B, T) ids with per-row live lengths
        ``lens``: the pooled (and normalized) (B, n_embd) fp32 vectors."""
        cfg, p = self.model.config, self.params
        bb, tt = idx.shape
        dev = idx.device
        x = p["wte"]["embedding"][idx]
        if cfg.use_abs_pos_emb:
            x = x + p["wpe"]["embedding"][:tt][None]
        h_ = cfg.n_head
        scale = 1.0 / math.sqrt(cfg.n_embd // h_)
        live = torch.arange(tt, device=dev)[None, :] < lens[:, None]  # (B, T)
        causal = torch.ones(tt, tt, dtype=torch.bool, device=dev).tril()[None] & live[:, None, :]
        nf = lens.clamp_min(1).float()[:, None, None, None]
        zero = torch.zeros((), device=dev)
        m = live[:, None, None, :]

        def std(s, e):
            if cfg.causal_std:  # row i's prefix is live for every live row
                return standardize_scores_causal(s, e)
            mu = torch.where(m, s, zero).sum(-1, keepdim=True) / nf
            var = torch.where(m, (s - mu).square(), zero).sum(-1, keepdim=True) \
                / (nf - 1.0).clamp_min(1.0)
            return (s - mu) / (torch.sqrt(var) + e)

        mop_causal = bool(getattr(self.model, "causal_gate", False))
        for i in range(cfg.n_layer):
            bp = p[f"blocks_{i}"]
            ap = bp["attn"]
            hx = _ln(x, bp["ln1"])
            q, k, v = (_split_heads(_lin(hx, ap[n]), h_) for n in ("q_proj", "k_proj", "v_proj"))
            qk = q @ k.transpose(-1, -2) * scale
            if cfg.use_quartet:
                q2 = _split_heads(_lin(hx, ap["q2_proj"]), h_)
                k2 = _split_heads(_lin(hx, ap["k2_proj"]), h_)
                q2k2 = q2 @ k2.transpose(-1, -2) * scale
                mix = torch.sigmoid(ap["mixture"][0])
                eps = cfg.score_norm_eps
                scores = ((1.0 - mix) * std(qk, eps)
                          + mix * (std(qk, eps) * std(q2k2, eps)) * ap["quartet_scale"][0])
            else:  # the single path's eps is 1e-5 whatever the config says
                scores = std(qk, 1e-5)
            att = torch.softmax(scores.masked_fill(~causal[:, None], float("-inf")), -1)
            att = torch.nan_to_num(att, nan=0.0)  # a pad row's scores are all masked
            x = x + _lin(_merge_heads(att @ v), ap["o_proj"])
            if "views" in bp:  # GPT-MoP: the pads' views zeroed before the conv
                gate, _ = _mop_gate_full(bp, x, t_live=lens, causal=mop_causal)
                x = x * gate[..., None]
            x = _mlp(x, bp)
        h = _ln(x, p["ln_f"])
        mask = live.to(h.dtype)
        if self.pool == "mean":
            emb = (h * mask[..., None]).sum(1) / mask.sum(1).clamp_min(1.0)[:, None]
        else:
            emb = h[torch.arange(bb, device=dev), (lens - 1).clamp_min(0)]
        if self.normalize:
            emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return emb.float()

    def embed(self, token_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Embed a batch of token-id sequences: (N, n_embd) float32. Each
        sequence has 1 <= len <= block_size and ids in [0, vocab_size);
        batches above ``max_chunk`` rows run as several bounded forwards."""
        if not token_lists:
            return np.zeros((0, self.n_embd), np.float32)
        lens = [len(s) for s in token_lists]
        if min(lens) < 1:
            raise ValueError("empty input sequence")
        if max(lens) > self.block_size:
            raise ValueError(f"input length {max(lens)} exceeds the model context "
                             f"window ({self.block_size})")
        for seq in token_lists:
            for t in seq:
                # bool is an int subclass, and an id out of range would index garbage
                if isinstance(t, bool) or not 0 <= int(t) < self.vocab_size:
                    raise ValueError(f"token id {t!r} outside [0, {self.vocab_size})")
        parts = []
        for lo in range(0, len(token_lists), self.max_chunk):
            chunk = token_lists[lo:lo + self.max_chunk]
            clens = lens[lo:lo + self.max_chunk]
            bt = _pow2_at_least(len(chunk), 1)
            tt = min(_pow2_at_least(max(clens), 8), self.block_size)
            idx = np.zeros((bt, tt), np.int64)
            for i, seq in enumerate(chunk):
                idx[i, :len(seq)] = np.asarray(seq, np.int64)
            ln = np.zeros((bt,), np.int64)
            ln[:len(clens)] = clens
            with torch.no_grad():
                out = self._forward(torch.from_numpy(idx).to(self.device),
                                    torch.from_numpy(ln).to(self.device))
            parts.append(out.cpu().numpy()[:len(chunk)])
        return np.concatenate(parts, axis=0)


def parse_embedding_input(req: dict, tokenizer) -> List[List[int]]:
    """OpenAI ``input`` shapes: a string, a list of strings, a token-id
    list, or a list of token-id lists. Returns a list of id sequences."""
    inp = req.get("input")
    if inp is None:
        raise ValueError("'input' is required")
    is_id = lambda x: isinstance(x, int) and not isinstance(x, bool)
    if isinstance(inp, str):
        items = [inp]
    elif isinstance(inp, list) and inp and all(is_id(x) for x in inp):
        return [[int(t) for t in inp]]
    elif isinstance(inp, list):
        items = inp
    else:
        raise ValueError("input must be a string or a list")
    if not items:
        raise ValueError("input must be non-empty")
    out = []
    for it in items:
        if isinstance(it, str):
            if tokenizer is None:
                raise ValueError(
                    "string input needs a server with tokenizer=")
            ids = tokenizer.encode(it)
            if not ids:
                raise ValueError("an input encoded to zero tokens")
            out.append([int(t) for t in ids])
        elif isinstance(it, list) and it and all(is_id(x) for x in it):
            out.append([int(t) for t in it])
        else:
            raise ValueError(
                "input list items must be strings or token-id lists")
    return out


def embeddings_body(vecs: np.ndarray, model_name: str, n_tokens: int,
                    encoding_format: str = "float",
                    dimensions: Optional[int] = None) -> dict:
    """The OpenAI embeddings response. ``dimensions`` truncates then
    re-normalizes (the matryoshka convention); ``base64`` packs each
    vector's float32 little-endian bytes."""
    if encoding_format not in ("float", "base64"):
        raise ValueError(
            f"encoding_format must be 'float' or 'base64', got "
            f"{encoding_format!r}")
    if dimensions is not None:
        if not 1 <= dimensions <= vecs.shape[-1]:
            raise ValueError(
                f"dimensions must be in [1, {vecs.shape[-1]}], got "
                f"{dimensions}")
        vecs = vecs[:, :dimensions]
        nrm = np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True),
                         1e-12)
        vecs = vecs / nrm
    data = []
    for i, v in enumerate(np.asarray(vecs, np.float32)):
        if encoding_format == "base64":
            e = base64.b64encode(v.astype("<f4").tobytes()).decode()
        else:
            e = [float(x) for x in v]
        data.append({"object": "embedding", "index": i, "embedding": e})
    return {"object": "list", "data": data, "model": model_name,
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens}}
