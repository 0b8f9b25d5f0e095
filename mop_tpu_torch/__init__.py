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
CLI ``python -m mop_tpu_torch.cli.train_gpt_char``.
"""

from .models import (GPT_MoP, ComparisonConfig, CrossViewMixerMSA, DualPathMSA, EdgewiseMSA,
                     GPTComparisonFramework, MultiHopMSA, TinyTransformerLM, TransformerConfig,
                     UnifiedMSA, ViT_Baseline, ViT_MoP, ViTCrossView, ViTEdgewise, ViTGated,
                     ViTMultiHop, create_comparison_framework, create_gpt_baseline,
                     create_gpt_mop, create_gpt_mop_causal, create_gpt_quartet, set_generator)
from .ops import fused
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
    "set_generator",
    "fused",
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
