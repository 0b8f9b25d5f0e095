"""mop_tpu_torch — the PyTorch / CUDA port of mop-tpu for NVIDIA Hopper.

A package beside ``mop_tpu`` (the JAX reference, which it never imports).
Plain tensor code is PyTorch; each Pallas kernel of the ported slice is a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use
(``ops/_build.py``). Entry points run on the GPU unless given
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

Ported so far: CIFAR ViT training and inference for A (``ViT_Baseline``), B
(``ViT_MoP``, with the top-1 MoE encoder, dense or routed), C (``ViTCrossView``), D (``ViTMultiHop``), the two-hop gated
ViT (``ViTGated``) and E (``ViTEdgewise``, lowrank and dense gates) through
``make_classifier_train_step``, ``make_scanned_classifier_train_step`` and
``make_classifier_eval_step``; the ImageNet train step
(``make_imagenet_train_step``: RandAugment, RandomErasing, Mixup/CutMix,
label smoothing, remat) with ``ema_update``; the VOC box localizer
(``ViTLocalizer``, ``bbox_iou``); the GPT family, forward and training: the
Quartet and baseline causal LM (``TinyTransformerLM``, ``create_gpt_quartet``,
``create_gpt_baseline``), GPT-MoP (``GPT_MoP``, ``create_gpt_mop``,
``create_gpt_mop_causal``), the comparison framework
(``GPTComparisonFramework``) and ``make_lm_train_step``, with the character-LM
CLI ``python -m mop_tpu_torch.cli.train_gpt_char``; the Whisper family:
the on-device log-mel frontend (``ops.mel``), ``WhisperMoP``
(``create_whisper_mop``, ``create_whisper_baseline``), its comparison
framework (``WhisperComparisonFramework``) and greedy transcription, full
window and KV-cached (``whisper_transcribe``, ``whisper_transcribe_cached``,
``whisper_transcribe_auto``) and beam transcription (``whisper_transcribe_beam``), with the demo
``python -m mop_tpu_torch.cli.whisper_demo``; GPT decoding: the exact
full-window sampler (``generate``, K5 in every layer of every step), the
KV-cached decoder (``prefill``, ``decode_step``, ``decode_chunk``,
``generate_cached`` over ``decode_params(model)``, with int8 / int4
weights from ``ops.quant``), beam search (``generate_beam``) and
speculative decoding (``speculative_generate``), the tokenizers
(``data.ByteBPETokenizer``, ``data.CharTokenizer``) and the demo
``python -m mop_tpu_torch.cli.generate_text``; the CIFAR experiment
harness (``experiments/``: data, parameter matching, lockstep training,
checkpoints and preemption, statistics, output files) with its CLIs:

- ``python -m mop_tpu_torch.experiments.cifar100_ab5_param_budgets``: A/B/C/D/E
  at matched parameter budgets, trained in lockstep on the same batches;
- ``python -m mop_tpu_torch.experiments.cifar{10,100}_{crossview_mixer,
  edgewise_gates,multihop_gates,twohop_gates}``: one model per seed;
- ``python -m mop_tpu_torch.experiments.voc_localization_vit``: the VOC
  single-box localizer, mode A, B or E;
- ``python -m mop_tpu_torch.experiments.imagenet_ab_param_budgets``: A/B/E at
  matched budgets on ImageNet-style data, with EMA.

They run on the GPU unless given ``--device cpu``. The kernel switches
(``config.py``: ``fused_attention``, ``fused_multihop``, ``fused_quartet``,
``fused_edgewise_train``, by the JAX package's environment variables) send a
module to its composed path.
"""

from .models import (GPT_MoP, ComparisonConfig, CrossViewMixerMSA, DualPathMSA, EdgewiseMSA,
                     GPTComparisonFramework, MultiHopMSA, TinyTransformerLM, TransformerConfig,
                     UnifiedMSA, ViT_Baseline, ViT_MoP, ViTCrossView, ViTEdgewise, ViTGated,
                     ViTLocalizer, ViTMultiHop, WhisperComparisonConfig, WhisperComparisonFramework,
                     WhisperConfig, WhisperMoP, create_comparison_framework, create_gpt_baseline,
                     create_gpt_mop, create_gpt_mop_causal, create_gpt_quartet,
                     create_whisper_baseline, create_whisper_comparison_framework,
                     create_whisper_mop, decode_params, generate, generate_beam,
                     generate_cached, set_generator, speculative_generate, whisper_transcribe,
                     whisper_transcribe_auto, whisper_transcribe_beam, whisper_transcribe_cached)
from .ops import fused, mel, quant
from .ops.preprocess import (CIFAR10_MEAN, CIFAR10_STD, CIFAR100_MEAN, CIFAR100_STD,
                             IMAGENET_MEAN, IMAGENET_STD, cifar_eval_transform,
                             cifar_train_augment, label_smoothing_onehot, random_crop,
                             random_hflip)
from .parallel import (cast_floats, make_classifier_eval_step, make_classifier_train_step,
                       make_imagenet_train_step, make_lm_train_step,
                       make_scanned_classifier_train_step)
from .utils import load_jax_params, resolve_device

__version__ = "0.1.0"

__all__ = [
    "ViT_Baseline",
    "ViT_MoP",
    "ViTEdgewise",
    "ViTCrossView",
    "ViTMultiHop",
    "ViTGated",
    "ViTLocalizer",
    "CrossViewMixerMSA",
    "MultiHopMSA",
    "DualPathMSA",
    "UnifiedMSA",
    "EdgewiseMSA",
    "TinyTransformerLM",
    "TransformerConfig",
    "create_gpt_baseline",
    "create_gpt_quartet",
    "GPT_MoP",
    "create_gpt_mop",
    "create_gpt_mop_causal",
    "ComparisonConfig",
    "GPTComparisonFramework",
    "create_comparison_framework",
    "WhisperConfig",
    "WhisperMoP",
    "create_whisper_mop",
    "create_whisper_baseline",
    "WhisperComparisonConfig",
    "WhisperComparisonFramework",
    "create_whisper_comparison_framework",
    "whisper_transcribe",
    "whisper_transcribe_cached",
    "whisper_transcribe_auto",
    "whisper_transcribe_beam",
    "decode_params",
    "generate",
    "generate_cached",
    "generate_beam",
    "speculative_generate",
    "set_generator",
    "fused",
    "mel",
    "quant",
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "CIFAR100_MEAN",
    "CIFAR100_STD",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "cifar_eval_transform",
    "cifar_train_augment",
    "label_smoothing_onehot",
    "random_crop",
    "random_hflip",
    "cast_floats",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_scanned_classifier_train_step",
    "make_imagenet_train_step",
    "make_lm_train_step",
    "load_jax_params",
    "resolve_device",
]
