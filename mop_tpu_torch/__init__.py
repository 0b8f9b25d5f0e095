"""mop_tpu_torch — the PyTorch / CUDA port of mop-tpu for NVIDIA Hopper.

A package beside ``mop_tpu`` (the JAX reference, which it never imports).
Plain tensor code is PyTorch; each Pallas kernel of the ported slice is a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use
(``ops/_build.py``). Entry points run on the GPU unless given
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

This slice: CIFAR ViT inference for A (``ViT_Baseline``), B (``ViT_MoP``) and
E (``ViTEdgewise``, lowrank gates) through ``make_classifier_eval_step``.
"""

from .models import ViT_Baseline, ViT_MoP, ViTEdgewise
from .ops import fused
from .ops.preprocess import CIFAR10_MEAN, CIFAR10_STD, CIFAR100_MEAN, CIFAR100_STD
from .parallel import cast_floats, make_classifier_eval_step
from .utils import load_jax_params, resolve_device

__version__ = "0.1.0"

__all__ = [
    "ViT_Baseline",
    "ViT_MoP",
    "ViTEdgewise",
    "fused",
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "CIFAR100_MEAN",
    "CIFAR100_STD",
    "cast_floats",
    "make_classifier_eval_step",
    "load_jax_params",
    "resolve_device",
]
