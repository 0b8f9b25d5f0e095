"""ViT model wrappers around the attention variants, in PyTorch — the port of
``mop_tpu/models/vit_variants.py``: ``DualPathMSA`` and the C, D, E and
two-hop gated ViTs.

Patchify + learned pos + pre-LN blocks with the given MSA + final LN +
mean-pool + bias-free head. The JAX package names block i's MSA
``<Class>_<i>`` at the top of its tree; here it is ``blocks.<i>.attn``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from ..ops import attention as A
from ..utils.device import resolve_device
from .attention_variants import CrossViewMixerMSA, EdgewiseMSA, MultiHopMSA
from .components import MLP, DropPath, PatchEmbed, drop_path_schedule
from .layers import LayerNorm, Linear, init_params

Tensor = torch.Tensor
Device = Optional[Union[str, torch.device]]


class DualPathMSA(MultiHopMSA):
    """Two-hop dual-path MSA with fixed scalar logic gates: ``MultiHopMSA``
    at hops 2, except that the base path is scaled by ``gates["base"]`` and
    the composed path reads every gate by key.

    The eval forward without a mask is K4 with hops 2 and the gates as
    given where K4 takes the shape; training, a mask or a larger N runs the
    composed path, as in JAX.
    """

    def __init__(self, dim: int, heads: int = 4, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, beta_not: float = 0.5, gates: Optional[dict] = None):
        super().__init__(dim, heads, attn_drop, proj_drop, beta_not=beta_not, gates=gates,
                         hops=2)

    def _kernel_gates(self) -> dict:
        return self.gates

    def _composed(self, q1, k1, v1, q2, k2, v2, w, attn_mask):
        g = self.gates
        s1, s2 = A.scaled_scores(q1, k1), A.scaled_scores(q2, k2)
        a1, a2 = A.masked_softmax(s1, attn_mask), A.masked_softmax(s2, attn_mask)
        c_right = A.chain_product([a1, a2])
        smix = g["base"] * s1
        smix = smix + g["and_"] * s2
        smix = smix + g["or_"] * (A.lse_pair(s1, s2) - s1)
        smix = smix - g["not_"] * (self.beta_not * s2)
        smix = smix + g["chain"] * torch.log(c_right + 1e-6)
        att = self.attn_drop(A.masked_softmax(smix, attn_mask))
        y_chain = a1.to(v2.dtype) @ (a2.to(v2.dtype) @ v2)
        return att.to(v1.dtype) @ v1 + w * y_chain


class _VariantBlock(nn.Module):
    """Pre-LN block hosting an arbitrary MSA module instance."""

    def __init__(self, dim: int, mlp_ratio: float, drop: float, drop_path: float,
                 msa: nn.Module):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = msa
        self.dp1 = DropPath(drop_path)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio, drop)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.dp1(self.attn(self.ln1(x)))
        return x + self.dp2(self.mlp(self.ln2(x)))


class _VariantViT(nn.Module):
    """Shared ViT backbone; ``make_msa`` builds each block's MSA."""

    def __init__(self, make_msa: Callable[[], nn.Module], dim: int = 256, depth: int = 6,
                 heads: int = 4, n_classes: int = 100, mlp_ratio: float = 4.0,
                 drop: float = 0.0, drop_path: float = 0.1, patch: int = 4,
                 num_tokens: int = 64, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.patch = PatchEmbed(dim=dim, patch=patch)
        self.pos = nn.Parameter(torch.empty(1, num_tokens, dim))
        self.blocks = nn.ModuleList(
            _VariantBlock(dim, mlp_ratio, drop, dp, make_msa())
            for dp in drop_path_schedule(drop_path, depth))
        self.ln_f = LayerNorm(dim)
        self.head = Linear(dim, n_classes, bias=False)
        self.init_own(None)
        if generator is not None:
            init_params(self, generator)
        self.to(device)

    def init_own(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            nn.init.normal_(self.pos, 0.0, 0.02, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        tok, _ = self.patch(x)
        tok = tok + self.pos
        for blk in self.blocks:
            tok = blk(tok)
        return self.head(self.ln_f(tok).mean(1))


class ViTEdgewise(_VariantViT):
    """Mode-E ViT: every block attends through ``EdgewiseMSA``.

    Built on ``device`` (the GPU unless given); ``generator`` seeds the
    initialisation. Every gate head and lens bank of ``EdgewiseMSA`` is
    ported; attention dropout is not, and no ViT uses it.
    """

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 n_classes: int = 100, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.1, patch: int = 4, num_tokens: int = 64,
                 beta_not: float = 0.5, use_k3: bool = False, n_views: int = 2,
                 share_qkv: bool = False, gate_mode: str = "dense", gate_rank: int = 4,
                 gate_init: str = "neutral", use_lens_bank: bool = False,
                 lens_kernel_size: int = 3, lens_dilations: Optional[Tuple[int, ...]] = None,
                 use_lens_bank_qk: bool = False, lens_qk_kernel_size: int = 3,
                 lens_qk_dilations: Optional[Tuple[int, ...]] = None,
                 lens_qk_causal: bool = False, device: Device = None,
                 generator: Optional[torch.Generator] = None):
        def make_msa():
            return EdgewiseMSA(
                dim, heads, 0.0, drop, beta_not=beta_not, use_k3=use_k3,
                n_views=n_views, share_qkv=share_qkv, gate_mode=gate_mode,
                gate_rank=gate_rank, gate_init=gate_init, use_lens_bank=use_lens_bank,
                lens_kernel_size=lens_kernel_size, lens_dilations=lens_dilations,
                use_lens_bank_qk=use_lens_bank_qk, lens_qk_kernel_size=lens_qk_kernel_size,
                lens_qk_dilations=lens_qk_dilations, lens_qk_causal=lens_qk_causal)

        super().__init__(make_msa, dim=dim, depth=depth, heads=heads, n_classes=n_classes,
                         mlp_ratio=mlp_ratio, drop=drop, drop_path=drop_path, patch=patch,
                         num_tokens=num_tokens, device=device, generator=generator)


class ViTCrossView(_VariantViT):
    """Mode-C ViT: every block attends through ``CrossViewMixerMSA``
    (composed; no kernel). Built on ``device`` (the GPU unless given);
    ``generator`` seeds the initialisation."""

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 n_classes: int = 100, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.1, patch: int = 4, num_tokens: int = 64,
                 use_transpose_cues: bool = True, t1: float = 0.0, t2: float = 0.0,
                 enable_per_key_prior: bool = False, prior_weight: float = 0.5,
                 anchor_mode: str = "argmax_row_sum", fixed_k_star: int = 0,
                 device: Device = None, generator: Optional[torch.Generator] = None):
        def make_msa():
            return CrossViewMixerMSA(
                dim, heads, 0.0, drop, use_transpose_cues=use_transpose_cues, t1=t1, t2=t2,
                enable_per_key_prior=enable_per_key_prior, prior_weight=prior_weight,
                anchor_mode=anchor_mode, fixed_k_star=fixed_k_star)

        super().__init__(make_msa, dim=dim, depth=depth, heads=heads, n_classes=n_classes,
                         mlp_ratio=mlp_ratio, drop=drop, drop_path=drop_path, patch=patch,
                         num_tokens=num_tokens, device=device, generator=generator)


class ViTMultiHop(_VariantViT):
    """Mode-D ViT: every block attends through ``MultiHopMSA`` (K4 in eval
    mode). Built on ``device`` (the GPU unless given); ``generator`` seeds
    the initialisation."""

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 n_classes: int = 100, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.1, patch: int = 4, num_tokens: int = 64,
                 beta_not: float = 0.5, gates: Optional[dict] = None, hops: int = 3,
                 device: Device = None, generator: Optional[torch.Generator] = None):
        def make_msa():
            return MultiHopMSA(dim, heads, 0.0, drop, beta_not=beta_not, gates=gates, hops=hops)

        super().__init__(make_msa, dim=dim, depth=depth, heads=heads, n_classes=n_classes,
                         mlp_ratio=mlp_ratio, drop=drop, drop_path=drop_path, patch=patch,
                         num_tokens=num_tokens, device=device, generator=generator)


class ViTGated(_VariantViT):
    """Two-hop dual-path gated ViT: every block attends through
    ``DualPathMSA`` (K4 at hops 2 in eval mode). Built on ``device`` (the GPU
    unless given); ``generator`` seeds the initialisation."""

    def __init__(self, dim: int = 256, depth: int = 6, heads: int = 4,
                 n_classes: int = 100, mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.1, patch: int = 4, num_tokens: int = 64,
                 beta_not: float = 0.5, gates: Optional[dict] = None,
                 device: Device = None, generator: Optional[torch.Generator] = None):
        def make_msa():
            return DualPathMSA(dim, heads, 0.0, drop, beta_not=beta_not, gates=gates)

        super().__init__(make_msa, dim=dim, depth=depth, heads=heads, n_classes=n_classes,
                         mlp_ratio=mlp_ratio, drop=drop, drop_path=drop_path, patch=patch,
                         num_tokens=num_tokens, device=device, generator=generator)
