"""Models of the PyTorch port: the CIFAR ViTs A (baseline), B (MoP), C
(cross-view), D (multi-hop), the two-hop gated ViT and E (edgewise-gated
attention), the attention-variant zoo, and the Quartet / baseline causal LM."""

from .attention_variants import (
    BaselineMSA,
    CrossViewMixerMSA,
    EdgewiseGateHead,
    EdgewiseMSA,
    MultiHopMSA,
    UnifiedMSA,
)
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
from .gpt_comparison import ComparisonConfig, GPTComparisonFramework, create_comparison_framework
from .gpt_mop import (GPT_MoP, FuseExcInh1D, Kernels1D, MoPBlock, ViewsLinear1D, create_gpt_mop,
                      create_gpt_mop_causal)
from .layers import Conv1d, Dropout, Embedding, set_generator
from .quartet_attn_patch import (
    CausalSelfAttention,
    TinyTransformerLM,
    TransformerConfig,
    create_gpt_baseline,
    create_gpt_quartet,
)
from .vit_baseline import ViT_Baseline
from .vit_mop import ViT_MoP
from .vit_variants import DualPathMSA, ViTCrossView, ViTEdgewise, ViTGated, ViTMultiHop

__all__ = [
    "ViT_MoP",
    "ViT_Baseline",
    "ViTEdgewise",
    "ViTCrossView",
    "ViTMultiHop",
    "ViTGated",
    "ViewsLinear",
    "Kernels3",
    "FuseExcInh",
    "ViTEncoder",
    "PatchEmbed",
    "MSA",
    "MLP",
    "Block",
    "DropPath",
    "Conv1d",
    "Dropout",
    "Embedding",
    "set_generator",
    "BaselineMSA",
    "CrossViewMixerMSA",
    "MultiHopMSA",
    "DualPathMSA",
    "UnifiedMSA",
    "EdgewiseMSA",
    "EdgewiseGateHead",
    "TransformerConfig",
    "CausalSelfAttention",
    "TinyTransformerLM",
    "create_gpt_baseline",
    "create_gpt_quartet",
    "GPT_MoP",
    "MoPBlock",
    "ViewsLinear1D",
    "Kernels1D",
    "FuseExcInh1D",
    "create_gpt_mop",
    "create_gpt_mop_causal",
    "ComparisonConfig",
    "GPTComparisonFramework",
    "create_comparison_framework",
]
