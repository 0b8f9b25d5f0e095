"""Whisper-MoP, the audio encoder-decoder with a MoP gate in its encoder, in
PyTorch: the port of ``mop_tpu/models/whisper_mop.py``.

Each encoder block scales its tokens by a per-timestep scalar gate computed
from the raw mel spectrogram (recomputed in every layer with that layer's
parameters): V views of the mel by a 1x1 conv, K pattern maps by a kxk conv
over (T, F), and a 1x1 conv to an excitatory and an inhibitory map, averaged
over the mel bins and mixed as ``gate = 1 + a_pos g_pos - a_neg g_neg``,
with no sigmoid and the raw pair ``alpha`` (init ones; zeros for the
baseline, whose gate is then 1). The decoder is causal self-attention,
cross-attention to the encoder output and a tanh-GELU MLP, with the head
tied to ``wte``.

Attention runs through the flash kernel K1 (``ops.fused.flash_attention``)
in all three sites, the encoder's self-attention, the decoder's causal one
and the rectangular cross-attention, where the JAX modules take their
kernel: ``config.fused_attention`` on, no mask or bias, heads K1 takes
(``flash_fits``), and dropout 0 or eval mode. Otherwise the module composes
scores, mask, softmax, dropout (from the explicit generator of
``set_generator``) and the value product.

Parameter names are the torch reference's (``audio_proj``,
``encoder.i.mop.fuse.alpha``, ``decoder.i.cross_attn.q_proj``, ...), so a
reference state dict loads with ``load_state_dict`` once its tied
``lm_head.weight`` is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..config import config as kernel_switches
from ..ops import attention as A
from ..ops import fused as ops_fused
from ..utils.device import resolve_device
from .layers import Conv2d, Dropout, Embedding, LayerNorm, gelu_tanh, init_params
from .quartet_attn_patch import GPTLinear

Tensor = torch.Tensor

__all__ = ["WhisperConfig", "ViewsConv2D", "Kernels2D", "FuseExcInh2D", "MoP2D",
           "MultiheadSelfAttention", "MultiheadCrossAttention", "WhisperMLP", "EncoderBlock",
           "DecoderBlock", "WhisperMoP", "create_whisper_mop", "create_whisper_baseline",
           "zero_mop_alphas"]


@dataclass
class WhisperConfig:
    """The JAX ``WhisperConfig``: its fields and defaults (the reference
    width: 1024 wide, 16 heads, 12 + 12 layers, 1500 audio frames)."""

    # Audio
    n_mels: int = 80
    n_audio_ctx: int = 1500
    # Text
    vocab_size: int = 51865
    n_text_ctx: int = 448
    # Transformer dims
    n_embd: int = 1024
    n_head: int = 16
    n_layer_enc: int = 12
    n_layer_dec: int = 12
    dropout: float = 0.0
    bias: bool = False
    use_abs_pos_emb: bool = True
    # MoP (encoder only)
    n_views: int = 5
    n_kernels: int = 3
    kernel_size: int = 5


class ViewsConv2D(nn.Module):
    """1x1 conv of the one-channel mel map to V views: (B, 1, T, F) -> (B, V, T, F)."""

    def __init__(self, n_views: int):
        super().__init__()
        self.conv = Conv2d(1, n_views, 1, bias=False)

    def forward(self, mel2d: Tensor) -> Tensor:
        return self.conv(mel2d)


class Kernels2D(nn.Module):
    """kxk conv over (T, F), padded to keep the size: V views -> K pattern maps."""

    def __init__(self, in_ch: int, n_kernels: int, kernel_size: int):
        super().__init__()
        self.conv = Conv2d(in_ch, n_kernels, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class FuseExcInh2D(nn.Module):
    """Excitatory / inhibitory maps of [views | kernels]: a bias-free 1x1
    conv to two channels, no sigmoid, and the raw pair ``alpha`` (init ones,
    zeros with ``zero_alpha``, the baseline). Returns
    ``(g_pos, g_neg, a_pos, a_neg)``, the maps (B, 1, T, F)."""

    def __init__(self, in_ch: int, zero_alpha: bool = False):
        super().__init__()
        self.zero_alpha = zero_alpha
        self.conv = Conv2d(in_ch, 2, 1, bias=False)
        self.alpha = nn.Parameter(torch.empty(2))
        self.init_own(None)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            self.alpha.fill_(0.0 if self.zero_alpha else 1.0)

    def forward(self, x: Tensor):
        gates = self.conv(x)
        return gates[:, :1], gates[:, 1:], self.alpha[0], self.alpha[1]


class MoP2D(nn.Module):
    """MoP over the mel spectrogram -> a per-timestep scalar gate.

    Returns ``(gate (B, T, 1), views (B, V, T, F), kernels (B, K, T, F))``."""

    def __init__(self, n_views: int, n_kernels: int, kernel_size: int,
                 zero_alpha: bool = False):
        super().__init__()
        self.views = ViewsConv2D(n_views)
        self.kernels = Kernels2D(n_views, n_kernels, kernel_size)
        self.fuse = FuseExcInh2D(n_views + n_kernels, zero_alpha=zero_alpha)

    def forward(self, mel2d: Tensor):
        v = self.views(mel2d)
        k = self.kernels(v)
        g_pos, g_neg, a_pos, a_neg = self.fuse(torch.cat([v, k], dim=1))
        gate_t = 1.0 + a_pos * g_pos.mean(3) - a_neg * g_neg.mean(3)  # (B, 1, T)
        return gate_t.transpose(1, 2), v, k


def _split(y: Tensor, h: int) -> Tensor:
    """(B, T, D) -> (B, H, T, D / H)."""
    b, t, d = y.shape
    return y.reshape(b, t, h, d // h).transpose(1, 2)


def _attend(q: Tensor, k: Tensor, v: Tensor, causal: bool, bias: Optional[Tensor],
            drop: Dropout) -> Tensor:
    """Attention over (B, H, N, dh) heads, merged back to (B, N, H * dh):
    K1 where the JAX module takes its kernel, else scores, causal mask,
    additive bias, softmax, dropout and the value product."""
    if (kernel_switches.fused_attention and bias is None
            and ops_fused.flash_fits(q.shape[-1]) and (drop.p == 0.0 or not drop.training)):
        y = ops_fused.flash_attention(q, k, v, causal=causal)
    else:
        att = A.scaled_scores(q, k)
        if causal:
            att = A.apply_mask(att, A.causal_mask(q.shape[2], device=q.device))
        if bias is not None:
            att = att + bias
        att = drop(torch.softmax(att, -1))
        y = att.to(v.dtype) @ v
    b, h, n, dh = y.shape
    return y.transpose(1, 2).reshape(b, n, h * dh)


class MultiheadSelfAttention(nn.Module):
    """Optionally causal self-attention with separate q/k/v/o projections;
    ``attn_bias`` is added to the scores (and sends the module to its
    composed path)."""

    def __init__(self, dim: int, n_head: int, dropout: float, bias: bool, causal: bool):
        super().__init__()
        self.n_head, self.causal = n_head, causal
        self.q_proj = GPTLinear(dim, dim, bias)
        self.k_proj = GPTLinear(dim, dim, bias)
        self.v_proj = GPTLinear(dim, dim, bias)
        self.o_proj = GPTLinear(dim, dim, bias)
        self.attn_drop = Dropout(dropout)
        self.resid_drop = Dropout(dropout)

    def forward(self, x: Tensor, attn_bias: Optional[Tensor] = None) -> Tensor:
        h = self.n_head
        q, k, v = (_split(p(x), h) for p in (self.q_proj, self.k_proj, self.v_proj))
        y = _attend(q, k, v, self.causal, attn_bias, self.attn_drop)
        return self.resid_drop(self.o_proj(y))


class MultiheadCrossAttention(nn.Module):
    """Decoder cross-attention to the encoder output: queries (B, Tq, Dq)
    against keys and values (B, Tk, Dkv), Tk free; ``attn_mask`` is added to
    the scores (and sends the module to its composed path)."""

    def __init__(self, dim_q: int, dim_kv: int, n_head: int, dropout: float, bias: bool):
        super().__init__()
        self.n_head = n_head
        self.q_proj = GPTLinear(dim_q, dim_q, bias)
        self.k_proj = GPTLinear(dim_kv, dim_q, bias)
        self.v_proj = GPTLinear(dim_kv, dim_q, bias)
        self.o_proj = GPTLinear(dim_q, dim_q, bias)
        self.attn_drop = Dropout(dropout)
        self.resid_drop = Dropout(dropout)

    def forward(self, x_q: Tensor, x_kv: Tensor, attn_mask: Optional[Tensor] = None) -> Tensor:
        h = self.n_head
        q = _split(self.q_proj(x_q), h)
        k, v = _split(self.k_proj(x_kv), h), _split(self.v_proj(x_kv), h)
        y = _attend(q, k, v, False, attn_mask, self.attn_drop)
        return self.resid_drop(self.o_proj(y))


class WhisperMLP(nn.Module):
    """4x MLP with tanh-GELU."""

    def __init__(self, dim: int, dropout: float, bias: bool):
        super().__init__()
        self.fc = GPTLinear(dim, 4 * dim, bias)
        self.proj = GPTLinear(4 * dim, dim, bias)
        self.drop = Dropout(dropout)

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(self.proj(gelu_tanh(self.fc(x))))


class EncoderBlock(nn.Module):
    """Non-causal self-attention, the MoP gate from the mel, MLP. Returns
    ``(x, gate (B, T))``."""

    def __init__(self, cfg: WhisperConfig, zero_alpha: bool = False):
        super().__init__()
        c = cfg
        self.ln1 = LayerNorm(c.n_embd)
        self.attn = MultiheadSelfAttention(c.n_embd, c.n_head, c.dropout, c.bias, causal=False)
        self.ln2 = LayerNorm(c.n_embd)
        self.mlp = WhisperMLP(c.n_embd, c.dropout, c.bias)
        self.mop = MoP2D(c.n_views, c.n_kernels, c.kernel_size, zero_alpha=zero_alpha)

    def forward(self, x: Tensor, mel2d: Tensor):
        x = x + self.attn(self.ln1(x))
        gate_t = self.mop(mel2d)[0]  # (B, T, 1)
        x = x * gate_t
        x = x + self.mlp(self.ln2(x))
        return x, gate_t.squeeze(-1)


class DecoderBlock(nn.Module):
    """Causal self-attention, cross-attention to the encoder output, MLP."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.ln1 = LayerNorm(c.n_embd)
        self.self_attn = MultiheadSelfAttention(c.n_embd, c.n_head, c.dropout, c.bias,
                                                causal=True)
        self.ln2 = LayerNorm(c.n_embd)
        self.cross_attn = MultiheadCrossAttention(c.n_embd, c.n_embd, c.n_head, c.dropout,
                                                  c.bias)
        self.ln3 = LayerNorm(c.n_embd)
        self.mlp = WhisperMLP(c.n_embd, c.dropout, c.bias)

    def forward(self, x: Tensor, enc: Tensor) -> Tensor:
        x = x + self.self_attn(self.ln1(x))
        x = x + self.cross_attn(self.ln2(x), enc)
        return x + self.mlp(self.ln3(x))


class WhisperMoP(nn.Module):
    """Encoder-decoder with the MoP gate in the encoder.

    ``forward(mel (B, T_audio, n_mels), dec_input_ids (B, T_text),
    targets=None)`` returns ``(logits, loss, gates)``: the loss (None without
    targets) is the mean token cross-entropy of an fp32 log-softmax, the
    gates (B, L_enc, T_audio). ``baseline_mode`` zeroes the fuse alphas, so
    every gate is 1. Dropout draws from the explicit generator of
    ``set_generator`` in training.

    Built on ``device`` (the GPU unless given); ``generator`` seeds the
    initialisation.
    """

    def __init__(self, cfg: WhisperConfig, baseline_mode: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = c = cfg
        self.audio_proj = GPTLinear(c.n_mels, c.n_embd, c.bias)
        if c.use_abs_pos_emb:
            self.audio_pos = Embedding(c.n_audio_ctx, c.n_embd)
            self.text_pos = Embedding(c.n_text_ctx, c.n_embd)
        self.wte = Embedding(c.vocab_size, c.n_embd)
        self.drop = Dropout(c.dropout)
        self.encoder = nn.ModuleList(EncoderBlock(c, zero_alpha=baseline_mode)
                                     for _ in range(c.n_layer_enc))
        self.decoder = nn.ModuleList(DecoderBlock(c) for _ in range(c.n_layer_dec))
        self.enc_ln_f = LayerNorm(c.n_embd)
        self.dec_ln_f = LayerNorm(c.n_embd)
        if generator is not None:
            init_params(self, generator)
        self.to(device)

    @staticmethod
    def _positions(table: Embedding, t: int, device) -> Tensor:
        if t > table.num_embeddings:
            raise ValueError(f"sequence length {t} > context {table.num_embeddings}")
        return table(torch.arange(t, device=device))[None]

    def encode(self, mel: Tensor):
        """mel (B, T_audio, n_mels) -> (encoder output (B, T, D), gates (B, L_enc, T))."""
        c = self.cfg
        if mel.shape[-1] != c.n_mels:
            raise ValueError(f"mel has {mel.shape[-1]} bins, the model {c.n_mels}")
        x = self.audio_proj(mel)
        if c.use_abs_pos_emb:
            x = x + self._positions(self.audio_pos, mel.shape[1], mel.device)
        x = self.drop(x)
        mel2d = mel[:, None]  # (B, 1, T, F)
        gates = []
        for blk in self.encoder:
            x, gate_t = blk(x, mel2d)
            gates.append(gate_t)
        return self.enc_ln_f(x), torch.stack(gates, 1)

    def decode(self, enc_out: Tensor, dec_input_ids: Tensor) -> Tensor:
        """(B, T_text) ids against the encoder output -> logits (B, T_text, vocab)."""
        x = self.wte(dec_input_ids)
        if self.cfg.use_abs_pos_emb:
            x = x + self._positions(self.text_pos, dec_input_ids.shape[1], x.device)
        x = self.drop(x)
        for blk in self.decoder:
            x = blk(x, enc_out)
        return self.wte.attend(self.dec_ln_f(x))  # tied head

    def forward(self, mel: Tensor, dec_input_ids: Tensor, targets: Optional[Tensor] = None):
        enc_out, gates = self.encode(mel)
        logits = self.decode(enc_out, dec_input_ids)
        loss = None
        if targets is not None:
            logp = torch.log_softmax(logits.float(), -1)
            loss = -logp.gather(-1, targets[..., None].long()).mean()
        return logits, loss, gates

    def get_gate_maps(self, mel: Tensor) -> Tensor:
        """Each encoder layer's time gate of an eval-mode pass, (B, L_enc, T)."""
        was_training = self.training
        self.eval()
        try:
            return self.encode(mel)[1]
        finally:
            self.train(was_training)


def create_whisper_mop(cfg: WhisperConfig, **kw) -> WhisperMoP:
    """Whisper-MoP. ``kw``: ``device``, ``generator``."""
    return WhisperMoP(cfg, **kw)


def create_whisper_baseline(cfg: WhisperConfig, **kw) -> WhisperMoP:
    """The same architecture with the MoP alphas zeroed, so every gate is 1.
    ``kw``: ``device``, ``generator``."""
    return WhisperMoP(cfg, baseline_mode=True, **kw)


def zero_mop_alphas(model: WhisperMoP) -> WhisperMoP:
    """Zero every encoder ``mop.fuse.alpha`` in place (gate -> identity) and
    return the model."""
    with torch.no_grad():
        for blk in model.encoder:
            blk.mop.fuse.alpha.zero_()
    return model
