"""Classifier eval step on one device — the port of ``make_classifier_eval_step``
and ``cast_floats`` from ``mop_tpu/parallel/train_step.py``.

uint8 NCHW in, normalize on the device, forward, ``(#correct, #valid)`` out.
The train steps come with the training slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from ..ops import preprocess as pp
from ..utils.device import resolve_device

Tensor = torch.Tensor


def cast_floats(tree, dtype: torch.dtype):
    """Cast the float tensors of a nested dict / list / tuple to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def make_classifier_eval_step(
    model: nn.Module, mean, std, compute_dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """Eval step: returns ``step(x_u8, y, valid_mask) -> (#correct, #valid)``.

    fp32 by default (``compute_dtype=None``): eval statistics are
    accuracy-critical, and bf16 argmax flips on borderline samples. With a
    ``compute_dtype`` the input and the model's float parameters are cast to
    it at every call, as the JAX step casts its params. The step runs on
    ``device`` (the GPU unless given) and moves its inputs there; the model
    must already live on it.
    """
    device = resolve_device(device)
    model.eval()

    @torch.inference_mode()
    def step(x_u8: Tensor, y: Tensor, valid_mask: Tensor) -> Tuple[Tensor, Tensor]:
        x = pp.cifar_eval_transform(x_u8.to(device, non_blocking=True), mean, std)
        if compute_dtype is None:
            logits = model(x)
        else:
            state = cast_floats({**dict(model.named_parameters()),
                                 **dict(model.named_buffers())}, compute_dtype)
            logits = functional_call(model, state, (x.to(compute_dtype),))
        logits = logits.float()
        valid = valid_mask.to(device, torch.float32)
        correct = (logits.argmax(-1) == y.to(device)).to(torch.float32) * valid
        return correct.sum(), valid.sum()

    return step
