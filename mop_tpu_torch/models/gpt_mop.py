"""GPT-MoP, the causal LM with a 1D MoP gate between attention and MLP, in
PyTorch: the port of ``mop_tpu/models/gpt_mop.py``.

Each block gates the attention residual before the MLP: V views of the
tokens (a bias-free projection), K 1D conv kernels over the views, and a
1x1 conv to an excitatory and an inhibitory map, mixed as
``gate = 1 + a_pos g_pos - a_neg g_neg`` (B, 1, T) and applied over the
width. Unlike the ViT fuse there is no sigmoid, and ``alpha`` is a raw
learnable pair initialised to ones. The attention is the LM's
``CausalSelfAttention`` for the given config (Quartet with ``use_quartet``,
running K5 where the JAX module runs its kernel). Parameter names follow the
torch reference (``blocks.i.views.proj``, ``blocks.i.kernels.conv``,
``blocks.i.fuse.conv``, ``blocks.i.fuse.alpha``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .layers import Conv1d
from .quartet_attn_patch import (Block, GPTLinear, TinyTransformerLM, TransformerConfig,
                                 create_gpt_baseline, create_gpt_quartet)

Tensor = torch.Tensor

__all__ = ["ViewsLinear1D", "Kernels1D", "FuseExcInh1D", "MoPBlock", "GPT_MoP",
           "create_gpt_mop", "create_gpt_mop_causal", "create_gpt_baseline",
           "create_gpt_quartet"]


class ViewsLinear1D(nn.Module):
    """Multi-view projection of the tokens: (B, T, D) -> (B, V, T)."""

    def __init__(self, dim: int, n_views: int = 5):
        super().__init__()
        self.proj = GPTLinear(dim, n_views, bias=False)

    def forward(self, tok: Tensor) -> Tensor:
        return self.proj(tok).transpose(1, 2)


class Kernels1D(nn.Module):
    """Bias-free 1D conv kernels over the views: (B, V, T) -> (B, K, T).

    Centred padding (``ks // 2`` on both sides), or with ``causal`` the
    left pad ``ks - 1``, so that the gate at position t sees only tokens
    up to t.
    """

    def __init__(self, in_ch: int, n_kernels: int = 3, kernel_size: int = 3,
                 causal: bool = False):
        super().__init__()
        pad = (kernel_size - 1, 0) if causal else kernel_size // 2
        self.conv = Conv1d(in_ch, n_kernels, kernel_size, padding=pad, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(x)


class FuseExcInh1D(nn.Module):
    """Excitatory / inhibitory maps of the sequence: a bias-free 1x1 conv to
    two channels, no sigmoid, and the raw pair ``alpha`` (init ones).
    Returns ``(g_pos, g_neg, a_pos, a_neg)``, the maps (B, 1, T)."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.conv = Conv1d(in_ch, 2, 1, bias=False)
        self.alpha = nn.Parameter(torch.ones(2))

    def forward(self, x: Tensor):
        gates = self.conv(x)
        return gates[:, :1], gates[:, 1:], self.alpha[0], self.alpha[1]


class MoPBlock(Block):
    """Pre-LN causal block with the MoP gate applied to the attention
    residual, before the MLP."""

    def __init__(self, config: TransformerConfig, n_views: int = 5, n_kernels: int = 3,
                 causal_gate: bool = False):
        super().__init__(config)
        self.views = ViewsLinear1D(config.n_embd, n_views)
        self.kernels = Kernels1D(n_views, n_kernels, causal=causal_gate)
        self.fuse = FuseExcInh1D(n_views + n_kernels)

    def get_gate_maps(self, x: Tensor):
        """``(gate (B, 1, T), views (B, V, T), kernels (B, K, T))`` of ``x``."""
        v = self.views(x)
        k = self.kernels(v)
        g_pos, g_neg, a_pos, a_neg = self.fuse(torch.cat([v, k], dim=1))
        return 1.0 + a_pos * g_pos - a_neg * g_neg, v, k

    def apply_mop(self, x: Tensor) -> Tensor:
        return x * self.get_gate_maps(x)[0].transpose(1, 2)

    def forward(self, x: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        x = self.apply_mop(x + self.attn(self.ln1(x), attention_mask=attention_mask))
        return x + self.mlp(self.ln2(x))


class GPT_MoP(TinyTransformerLM):
    """The LM of ``TinyTransformerLM`` (embeddings, dropout from the explicit
    generator, the block-size check, ``ln_f``, the head tied to ``wte``, the
    fp32 log-softmax loss) over ``MoPBlock``s.

    ``causal_gate`` left-pads the gate convs; with ``config.causal_std`` the
    output at position t then depends only on tokens up to t. Built on
    ``device`` (the GPU unless given); ``generator`` seeds the
    initialisation.
    """

    def __init__(self, vocab_size: int, config: TransformerConfig, n_views: int = 5,
                 n_kernels: int = 3, causal_gate: bool = False,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        # Read by _block while the base class builds the blocks.
        self.n_views, self.n_kernels, self.causal_gate = n_views, n_kernels, causal_gate
        super().__init__(vocab_size, config, device=device, generator=generator)

    def _block(self, config: TransformerConfig) -> nn.Module:
        return MoPBlock(config, self.n_views, self.n_kernels, self.causal_gate)

    def get_gate_maps(self, idx: Tensor):
        """Each layer's gate, views and kernel maps of an eval-mode forward:
        (B, L, 1, T), (B, L, V, T) and (B, L, K, T)."""
        was_training = self.training
        self.eval()
        try:
            x = self._embed(idx)
            maps = []
            for blk in self.blocks:
                x = x + blk.attn(blk.ln1(x))
                gate, v, k = blk.get_gate_maps(x)
                maps.append((gate, v, k))
                x = x * gate.transpose(1, 2)
                x = x + blk.mlp(blk.ln2(x))
        finally:
            self.train(was_training)
        return tuple(torch.stack(m, dim=1) for m in zip(*maps))


def create_gpt_mop(vocab_size: int, config: TransformerConfig, n_views: int = 5,
                   n_kernels: int = 3, **kw) -> GPT_MoP:
    """GPT-MoP with the reference's centred gate convs. ``kw``: ``device``,
    ``generator``."""
    return GPT_MoP(vocab_size, config, n_views=n_views, n_kernels=n_kernels, **kw)


def create_gpt_mop_causal(vocab_size: int, config: TransformerConfig, n_views: int = 5,
                          n_kernels: int = 3, **kw) -> GPT_MoP:
    """The serving-exact GPT-MoP: causal gate convs and causal-prefix score
    standardization (``causal_std``), so position t depends only on tokens up
    to t. The same parameters as ``create_gpt_mop``. ``kw``: ``device``,
    ``generator``."""
    return GPT_MoP(vocab_size, dataclasses.replace(config, causal_std=True), n_views=n_views,
                   n_kernels=n_kernels, causal_gate=True, **kw)
