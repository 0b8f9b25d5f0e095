"""Quartet attention and the causal LM around it, in PyTorch — the port of
``mop_tpu/models/quartet_attn_patch.py`` and of the two GPT factories of
``mop_tpu/models/gpt_mop.py`` that need no MoP gate.

Quartet attention is dual-path causal attention: a second QK path, both
score maps standardized per row (unbiased std, eps after the sqrt), and the
learned mix ``(1 - m) qk_norm + m (qk_norm * q2k2_norm) scale`` with
``m = sigmoid(mixture)`` (gate init -5). Without a mask, weights to return
or ``causal_std``, outside dropout-on training and where K5 takes the head
width (``ops.fused.quartet_fits``), it runs the fused K5
(``ops.fused.fused_quartet_attention``); otherwise the composed path, as the
JAX module chooses. Parameter names follow the torch reference (``wte``,
``wpe``, ``blocks.i.attn.q_proj``, ``mixture``, ...); the tied head has no
parameter of its own (``wte.attend``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..ops import attention as A
from ..ops import fused as ops_fused
from ..utils.device import resolve_device
from .layers import Dropout, Embedding, LayerNorm, gelu_tanh, init_params

Tensor = torch.Tensor


@dataclass
class TransformerConfig:
    """The JAX ``TransformerConfig``: its fields and defaults."""

    n_layer: int = 6
    n_head: int = 8
    n_embd: int = 512
    dropout: float = 0.1
    block_size: int = 512
    bias: bool = False
    # Quartet extras
    use_quartet: bool = True
    quartet_scale: float = 1.0
    quartet_gate_init: float = -5.0  # sigmoid(-5) ~ 0.0067
    score_norm_eps: float = 1e-5
    use_abs_pos_emb: bool = True
    # Standardize each score row over its causal prefix (columns <= row)
    # instead of every column, so that position i depends only on tokens
    # <= i (ops.attention.standardize_scores_causal). The kernel is off then.
    causal_std: bool = False


class GPTLinear(nn.Linear):
    """GPT-family linear: weight ~ normal(0.02); a bias, where configured,
    keeps the fan-in uniform init."""

    def __init__(self, in_features: int, out_features: int, bias: bool):
        super().__init__(in_features, out_features, bias=bias)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, 0.02, generator=generator)


class CausalSelfAttention(nn.Module):
    """Dual-path ('Quartet') causal self-attention, or with ``use_quartet``
    off the standardized single-path attention."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        cfg = self.config = config
        c = cfg.n_embd
        self.q_proj = GPTLinear(c, c, cfg.bias)
        self.k_proj = GPTLinear(c, c, cfg.bias)
        self.v_proj = GPTLinear(c, c, cfg.bias)
        if cfg.use_quartet:
            self.q2_proj = GPTLinear(c, c, cfg.bias)
            self.k2_proj = GPTLinear(c, c, cfg.bias)
            self.mixture = nn.Parameter(torch.empty(1))
            self.quartet_scale = nn.Parameter(torch.empty(1))
        self.o_proj = GPTLinear(c, c, cfg.bias)
        self.attn_drop = Dropout(cfg.dropout)
        self.resid_drop = Dropout(cfg.dropout)
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        if self.config.use_quartet:
            with torch.no_grad():
                self.mixture.fill_(self.config.quartet_gate_init)
                self.quartet_scale.fill_(self.config.quartet_scale)

    def forward(self, x: Tensor, attention_mask: Optional[Tensor] = None,
                need_weights: bool = False):
        """``attention_mask`` is additive, added to the causally masked
        scores. Returns y, or (y, att) with ``need_weights``."""
        cfg = self.config
        b, t, c = x.shape
        h = cfg.n_head

        def split(y):
            return y.reshape(b, t, h, c // h).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        std = A.standardize_scores_causal if cfg.causal_std else A.standardize_scores
        if cfg.use_quartet:
            q2, k2 = split(self.q2_proj(x)), split(self.k2_proj(x))
            m = torch.sigmoid(self.mixture)
            if (attention_mask is None and (not self.training or cfg.dropout == 0.0)
                    and not need_weights and not cfg.causal_std
                    and ops_fused.quartet_fits(c // h)):
                y = ops_fused.fused_quartet_attention(q, k, v, q2, k2, m[0], self.quartet_scale[0],
                                                      eps=cfg.score_norm_eps)
                return self.resid_drop(self.o_proj(y.transpose(1, 2).reshape(b, t, c)))
            qk_norm = std(A.scaled_scores(q, k), cfg.score_norm_eps)
            q2k2_norm = std(A.scaled_scores(q2, k2), cfg.score_norm_eps)
            scores = (1.0 - m) * qk_norm + m * (qk_norm * q2k2_norm) * self.quartet_scale
        else:
            scores = std(A.scaled_scores(q, k), 1e-5)
        scores = A.apply_mask(scores, A.causal_mask(t, device=x.device))
        if attention_mask is not None:
            scores = scores + attention_mask
        att = self.attn_drop(torch.softmax(scores, -1))
        y = (att.to(v.dtype) @ v).transpose(1, 2).reshape(b, t, c)
        y = self.resid_drop(self.o_proj(y))
        return (y, att) if need_weights else y


class MLP(nn.Module):
    """GPT MLP: fc -> tanh-GELU -> proj -> dropout."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        c = config.n_embd
        self.fc = GPTLinear(c, 4 * c, config.bias)
        self.proj = GPTLinear(4 * c, c, config.bias)
        self.drop = Dropout(config.dropout)

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(self.proj(gelu_tanh(self.fc(x))))


class Block(nn.Module):
    """Pre-LN causal block."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.ln1 = LayerNorm(config.n_embd)
        self.attn = CausalSelfAttention(config)
        self.ln2 = LayerNorm(config.n_embd)
        self.mlp = MLP(config)

    def forward(self, x: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        x = x + self.attn(self.ln1(x), attention_mask=attention_mask)
        return x + self.mlp(self.ln2(x))


class TinyTransformerLM(nn.Module):
    """Causal LM with absolute position embeddings and the head tied to
    ``wte``. ``forward(idx, attention_mask=None, targets=None)`` returns
    ``(logits, loss)``: the loss (None without targets) is the mean token
    cross-entropy of an fp32 log-softmax. Dropout draws from the explicit
    generator of ``set_generator`` in training.

    Built on ``device`` (the GPU unless given); ``generator`` seeds the
    initialisation.
    """

    def __init__(self, vocab_size: int, config: TransformerConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.wte = Embedding(vocab_size, config.n_embd)
        if config.use_abs_pos_emb:
            self.wpe = Embedding(config.block_size, config.n_embd)
        self.drop = Dropout(config.dropout)
        self.blocks = nn.ModuleList(self._block(config) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd)
        if generator is not None:
            init_params(self, generator)
        self.to(device)

    def _block(self, config: TransformerConfig) -> nn.Module:
        return Block(config)

    def _embed(self, idx: Tensor) -> Tensor:
        t = idx.shape[1]
        if t > self.config.block_size:
            raise ValueError(f"sequence length {t} > block size {self.config.block_size}")
        x = self.wte(idx)
        if self.config.use_abs_pos_emb:
            x = x + self.wpe(torch.arange(t, device=idx.device))[None]
        return self.drop(x)

    def forward(self, idx: Tensor, attention_mask: Optional[Tensor] = None,
                targets: Optional[Tensor] = None):
        x = self._embed(idx)
        for blk in self.blocks:
            x = blk(x, attention_mask=attention_mask)
        logits = self.wte.attend(self.ln_f(x))
        loss = None
        if targets is not None:
            logp = torch.log_softmax(logits.float(), -1)
            loss = -logp.gather(-1, targets[..., None].long()).mean()
        return logits, loss


def _factory_config(config: TransformerConfig, use_quartet: bool) -> TransformerConfig:
    """The factories' config: the size fields of ``config``, every Quartet
    extra at its default."""
    return TransformerConfig(n_layer=config.n_layer, n_head=config.n_head,
                             n_embd=config.n_embd, dropout=config.dropout,
                             block_size=config.block_size, bias=config.bias,
                             use_quartet=use_quartet)


def create_gpt_baseline(vocab_size: int, config: TransformerConfig, **kw) -> TinyTransformerLM:
    """Plain GPT: no Quartet, no MoP. ``kw``: ``device``, ``generator``."""
    return TinyTransformerLM(vocab_size, _factory_config(config, False), **kw)


def create_gpt_quartet(vocab_size: int, config: TransformerConfig, **kw) -> TinyTransformerLM:
    """Quartet attention, no MoP. ``kw``: ``device``, ``generator``."""
    return TinyTransformerLM(vocab_size, _factory_config(config, True), **kw)
