"""Models of the PyTorch port: the CIFAR ViTs A (baseline), B (MoP) and E
(edgewise-gated attention) with their components."""

from .attention_variants import EdgewiseGateHead, EdgewiseMSA
from .components import (
    MLP,
    MSA,
    Block,
    DropPath,
    FuseExcInh,
    Kernels3,
    PatchEmbed,
    ViewsLinear,
    ViTEncoder,
)
from .layers import Dropout, set_generator
from .vit_baseline import ViT_Baseline
from .vit_mop import ViT_MoP
from .vit_variants import ViTEdgewise

__all__ = [
    "ViT_MoP",
    "ViT_Baseline",
    "ViTEdgewise",
    "ViewsLinear",
    "Kernels3",
    "FuseExcInh",
    "ViTEncoder",
    "PatchEmbed",
    "MSA",
    "MLP",
    "Block",
    "DropPath",
    "Dropout",
    "set_generator",
    "EdgewiseMSA",
    "EdgewiseGateHead",
]
