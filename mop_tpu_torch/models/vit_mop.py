"""ViT-MoP (B): a Vision Transformer with Mixture-of-Products gating, in
PyTorch — the port of ``mop_tpu/models/vit_mop.py``.

Encoder -> multi-view projection -> learnable kernels -> excitatory/inhibitory
fusion -> spatial gate ``1 + a_pos*G_pos - a_neg*G_neg`` applied to the tokens
-> pool -> head, plus the ``get_gate_maps`` introspection API and the
optional MoE encoder.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .components import FuseExcInh, Kernels3, ViewsLinear, ViTEncoder, ViTEncoderMoE
from .layers import Linear, init_params

Tensor = torch.Tensor


class ViT_MoP(nn.Module):
    """ViT with spatial boolean logic via excitatory/inhibitory gating.

    Built on ``device`` (the GPU unless given); ``generator`` seeds the
    initialisation. ``use_moe`` swaps every block's MLP for a top-1 MoE MLP
    of ``moe_experts`` experts, computed by ``moe_impl``: "dense"
    (reference-exact) or "routed" (capacity-bounded dispatch).
    """

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 mlp_ratio: float = 4.0, n_classes: int = 10, n_views: int = 5,
                 n_kernels: int = 3, drop_path: float = 0.1, patch: int = 4,
                 img_size: int = 32, use_moe: bool = False, moe_experts: int = 4,
                 moe_impl: str = "dense",
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % heads != 0:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        device = resolve_device(device)
        enc = dict(dim=dim, depth=depth, heads=heads, mlp_ratio=mlp_ratio, drop_path=drop_path,
                   patch=patch, num_tokens=(img_size // patch) ** 2)
        if use_moe:
            self.enc = ViTEncoderMoE(**enc, num_experts=int(moe_experts), moe_impl=moe_impl)
        else:
            self.enc = ViTEncoder(**enc)
        self.views = ViewsLinear(dim, n_views=n_views)
        self.kerns = Kernels3(in_ch=n_views, n_kernels=n_kernels)
        self.fuse = FuseExcInh(in_ch=n_views + n_kernels)
        self.cls = Linear(dim, n_classes, bias=False)
        if generator is not None:
            init_params(self, generator)
        self.to(device)

    def _gate(self, tok: Tensor, grid: Tuple[int, int]):
        v = self.views(tok, grid)  # (B,V,Gh,Gw)
        k = self.kerns(v)  # (B,K,Gh,Gw)
        g_pos, g_neg, a_pos, a_neg = self.fuse(torch.cat([v, k], dim=1))
        gate = 1.0 + a_pos * g_pos - a_neg * g_neg  # (B,1,Gh,Gw)
        return gate, v, k

    def forward(self, x: Tensor) -> Tensor:
        tok, grid = self.enc(x)
        b, n, _ = tok.shape
        gate, _, _ = self._gate(tok, grid)
        return self.cls((tok * gate.reshape(b, n, 1)).mean(1))

    def get_gate_maps(self, x: Tensor):
        """(gate (B,1,Gh,Gw), views (B,V,Gh,Gw), kernels (B,K,Gh,Gw))."""
        tok, grid = self.enc(x)
        return self._gate(tok, grid)
