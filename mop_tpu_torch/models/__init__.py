"""Models of the PyTorch port: the CIFAR ViTs A (baseline), B (MoP, with an
optional top-1 MoE encoder), C (cross-view), D (multi-hop), the two-hop
gated ViT and E (edgewise-gated attention), the VOC box localizer (modes A,
B, E), the attention-variant zoo, the Quartet / baseline causal LM and
GPT-MoP with their decoders (the exact full-window sampler, the KV-cached
decoder, beam search, speculative decoding), and Whisper-MoP with its
comparison framework and greedy and beam transcription."""

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
    BlockMoE,
    DropPath,
    FuseExcInh,
    Kernels3,
    MoEMLP,
    PatchEmbed,
    ViewsLinear,
    ViTEncoder,
    ViTEncoderMoE,
)
from .beam import generate_beam, whisper_transcribe_beam
from .generate import (decode_chunk, decode_params, decode_step, generate, generate_cached,
                       init_decode_cache, prefill, prefill_padded, whisper_transcribe,
                       whisper_transcribe_auto, whisper_transcribe_cached)
from .gpt_comparison import ComparisonConfig, GPTComparisonFramework, create_comparison_framework
from .gpt_mop import (GPT_MoP, FuseExcInh1D, Kernels1D, MoPBlock, ViewsLinear1D, create_gpt_mop,
                      create_gpt_mop_causal)
from .layers import Conv1d, Dropout, Embedding, set_generator
from .speculative import speculative_generate, verify_sampled
from .quartet_attn_patch import (
    CausalSelfAttention,
    TinyTransformerLM,
    TransformerConfig,
    create_gpt_baseline,
    create_gpt_quartet,
)
from .vit_baseline import ViT_Baseline
from .vit_localizer import ViTLocalizer, ViTLocHead, bbox_iou, smooth_l1
from .vit_mop import ViT_MoP
from .vit_variants import DualPathMSA, ViTCrossView, ViTEdgewise, ViTGated, ViTMultiHop
from .whisper_comparison import (WhisperComparisonConfig, WhisperComparisonFramework,
                                 create_whisper_comparison_framework)
from .whisper_mop import (DecoderBlock, EncoderBlock, FuseExcInh2D, Kernels2D, MoP2D,
                          ViewsConv2D, WhisperConfig, WhisperMoP, create_whisper_baseline,
                          create_whisper_mop, zero_mop_alphas)

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
    "ViTEncoderMoE",
    "MoEMLP",
    "BlockMoE",
    "ViTLocalizer",
    "ViTLocHead",
    "bbox_iou",
    "smooth_l1",
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
    "WhisperMoP",
    "create_whisper_mop",
    "create_whisper_baseline",
    "zero_mop_alphas",
    "WhisperConfig",
    "ViewsConv2D",
    "Kernels2D",
    "FuseExcInh2D",
    "MoP2D",
    "EncoderBlock",
    "DecoderBlock",
    "WhisperComparisonFramework",
    "WhisperComparisonConfig",
    "create_whisper_comparison_framework",
    "whisper_transcribe",
    "whisper_transcribe_cached",
    "whisper_transcribe_auto",
    "whisper_transcribe_beam",
    "decode_params",
    "init_decode_cache",
    "prefill",
    "prefill_padded",
    "decode_step",
    "decode_chunk",
    "generate",
    "generate_cached",
    "generate_beam",
    "speculative_generate",
    "verify_sampled",
]
