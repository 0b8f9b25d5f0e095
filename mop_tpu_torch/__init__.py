"""mop_tpu_torch — the PyTorch / CUDA port of mop-tpu for NVIDIA Hopper.

A package beside ``mop_tpu`` (the JAX reference, which it never imports).
Plain tensor code is PyTorch; each Pallas kernel of the ported slice is a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use
(``ops/_build.py``). Entry points run on the GPU unless given
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

Ported so far: CIFAR ViT training and inference for A (``ViT_Baseline``), B
(``ViT_MoP``), C (``ViTCrossView``), D (``ViTMultiHop``), the two-hop gated
ViT (``ViTGated``) and E (``ViTEdgewise``, lowrank and dense gates) through
``make_classifier_train_step``, ``make_scanned_classifier_train_step`` and
``make_classifier_eval_step``; the GPT family, forward and training: the
Quartet and baseline causal LM (``TinyTransformerLM``, ``create_gpt_quartet``,
``create_gpt_baseline``), GPT-MoP (``GPT_MoP``, ``create_gpt_mop``,
``create_gpt_mop_causal``), the comparison framework
(``GPTComparisonFramework``) and ``make_lm_train_step``, with the character-LM
CLI ``python -m mop_tpu_torch.cli.train_gpt_char``; the Whisper family:
the on-device log-mel frontend (``ops.mel``), ``WhisperMoP``
(``create_whisper_mop``, ``create_whisper_baseline``), its comparison
framework (``WhisperComparisonFramework``) and greedy transcription, full
window and KV-cached (``whisper_transcribe``, ``whisper_transcribe_cached``,
``whisper_transcribe_auto``), with the demo
``python -m mop_tpu_torch.cli.whisper_demo``; the CIFAR experiment
harness (``experiments/``: data, parameter matching, lockstep training,
checkpoints and preemption, statistics, output files) with its CLIs:

- ``python -m mop_tpu_torch.experiments.cifar100_ab5_param_budgets``: A/B/C/D/E
  at matched parameter budgets, trained in lockstep on the same batches;
- ``python -m mop_tpu_torch.experiments.cifar{10,100}_{crossview_mixer,
  edgewise_gates,multihop_gates,twohop_gates}``: one model per seed.

They run on the GPU unless given ``--device cpu``. The kernel switches
(``config.py``: ``fused_attention``, ``fused_multihop``, ``fused_quartet``,
``fused_edgewise_train``, by the JAX package's environment variables) send a
module to its composed path.
"""

from .models import (GPT_MoP, ComparisonConfig, CrossViewMixerMSA, DualPathMSA, EdgewiseMSA,
                     GPTComparisonFramework, MultiHopMSA, TinyTransformerLM, TransformerConfig,
                     UnifiedMSA, ViT_Baseline, ViT_MoP, ViTCrossView, ViTEdgewise, ViTGated,
                     ViTMultiHop, WhisperComparisonConfig, WhisperComparisonFramework,
                     WhisperConfig, WhisperMoP, create_comparison_framework, create_gpt_baseline,
                     create_gpt_mop, create_gpt_mop_causal, create_gpt_quartet,
                     create_whisper_baseline, create_whisper_comparison_framework,
                     create_whisper_mop, set_generator, whisper_transcribe,
                     whisper_transcribe_auto, whisper_transcribe_cached)
from .ops import fused, mel
from .ops.preprocess import (CIFAR10_MEAN, CIFAR10_STD, CIFAR100_MEAN, CIFAR100_STD,
                             cifar_eval_transform, cifar_train_augment,
                             label_smoothing_onehot, random_crop, random_hflip)
from .parallel import (cast_floats, make_classifier_eval_step, make_classifier_train_step,
                       make_lm_train_step, make_scanned_classifier_train_step)
from .utils import load_jax_params, resolve_device

__version__ = "0.1.0"

__all__ = [
    "ViT_Baseline",
    "ViT_MoP",
    "ViTEdgewise",
    "ViTCrossView",
    "ViTMultiHop",
    "ViTGated",
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
    "set_generator",
    "fused",
    "mel",
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "CIFAR100_MEAN",
    "CIFAR100_STD",
    "cifar_eval_transform",
    "cifar_train_augment",
    "label_smoothing_onehot",
    "random_crop",
    "random_hflip",
    "cast_floats",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_scanned_classifier_train_step",
    "make_lm_train_step",
    "load_jax_params",
    "resolve_device",
]
