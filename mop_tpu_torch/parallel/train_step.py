"""Train and eval steps on one device — the port of
``make_classifier_train_step``, ``make_scanned_classifier_train_step``,
``make_classifier_eval_step``, ``make_lm_train_step`` and ``cast_floats``
from ``mop_tpu/parallel/train_step.py``.

Train: uint8 NCHW in, augment (or normalize) on the device, params cast to
the compute dtype, forward with ``train=True``, fp32 logits and
cross-entropy, fp32 grads, then the optimizer updates the model's fp32
parameters in place. Random draws (augment, drop-path, dropout) come from the
``torch.Generator`` the caller passes to each step, never from the global
RNG. Eval: normalize, forward in eval mode, ``(#correct, #valid)`` out.
Each step sets the model's mode on every call. The LM step takes token ids
and targets, which stay integer, and the model's fp32 mean cross-entropy.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..models.layers import set_generator
from ..ops import preprocess as pp
from ..utils.device import resolve_device

Tensor = torch.Tensor
Device = Optional[Union[str, torch.device]]


def cast_floats(tree, dtype: torch.dtype):
    """Cast the float tensors of a nested dict / list / tuple to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def _call(model: nn.Module, compute_dtype: Optional[torch.dtype], *args, **kwargs):
    """``model(*args, **kwargs)`` with its float params and buffers cast to
    ``compute_dtype`` (a differentiable cast: the grads reach the fp32 params
    in fp32); the arguments are passed as they are."""
    if compute_dtype is None:
        return model(*args, **kwargs)
    state = cast_floats({**dict(model.named_parameters()), **dict(model.named_buffers())},
                        compute_dtype)
    return functional_call(model, state, args, kwargs)


def _forward(model: nn.Module, x: Tensor, compute_dtype: Optional[torch.dtype]) -> Tensor:
    """The model on ``x``, with input and float params cast to ``compute_dtype``."""
    return _call(model, compute_dtype, x if compute_dtype is None else x.to(compute_dtype))


# The ops whose outputs remat="dots" saves: the matmuls, as JAX's
# checkpoint_dots saves the dot_general outputs. Everything else is recomputed.
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE



def _classifier_loss(model, mean, std, augment, label_smoothing, compute_dtype, n_classes,
                     remat):
    """``loss_fn(x_u8, y, generator) -> (loss, acc)`` of one (micro)batch."""

    def forward(x, generator):
        if remat == "none":
            return _forward(model, x, compute_dtype)
        # Recompute in backward ("full": all of the forward, "dots": all but
        # the matmuls). The recompute rewinds the generator to where the
        # forward started, so it draws the same drop masks.
        state = generator.get_state() if generator is not None else None

        def run(x):
            if state is not None:
                generator.set_state(state)
            return _forward(model, x, compute_dtype)

        if remat == "dots":
            return checkpoint(run, x, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
        return checkpoint(run, x, use_reentrant=False)

    def loss_fn(x_u8, y, generator):
        if augment:
            x = pp.cifar_train_augment(generator, x_u8, mean, std)
        else:
            x = pp.cifar_eval_transform(x_u8, mean, std)
        logits = forward(x, generator).float()
        if label_smoothing > 0.0:
            tgt = pp.label_smoothing_onehot(y, n_classes or logits.shape[-1], label_smoothing)
            loss = -(tgt * torch.log_softmax(logits, -1)).sum(-1).mean()
        else:
            loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return loss, acc

    return loss_fn


def _train_step(model, optimizer, mean, std, augment, label_smoothing, grad_clip,
                compute_dtype, n_classes, accum_steps, remat, device):
    device = resolve_device(device)
    loss_fn = _classifier_loss(model, mean, std, augment, label_smoothing, compute_dtype,
                               n_classes, remat)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x_u8: Tensor, y: Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Tensor]:
        if augment and generator is None:
            raise ValueError("the train augment draws from an explicit torch.Generator; "
                             "pass one on the step's device")
        model.train()
        set_generator(model, generator)
        x_u8 = x_u8.to(device, non_blocking=True)
        y = y.to(device, non_blocking=True).long()
        optimizer.zero_grad(set_to_none=True)
        loss, acc = _accumulate(lambda x, t: loss_fn(x, t, generator), (x_u8, y), accum_steps)
        _clip_and_update(params, optimizer, grad_clip)
        return {"loss": loss, "acc": acc}

    return step


def _accumulate(loss_fn, batch, accum_steps: int):
    """Backward of ``loss_fn(*batch) -> (loss, *metrics)`` and the detached
    ``(loss, *metrics)``. With ``accum_steps > 1`` the batch splits into
    interleaved microbatches, as the JAX steps split it (row r goes to
    microbatch r % accum_steps); each loss is scaled by 1 / accum_steps, so
    the grads sum to their mean, and the outputs are averaged."""
    if accum_steps == 1:
        out = loss_fn(*batch)
        out[0].backward()
        return [o.detach() for o in out]
    b = batch[0].shape[0]
    if b % accum_steps != 0:
        raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
    parts = [a.reshape(b // accum_steps, accum_steps, *a.shape[1:]).transpose(0, 1)
             for a in batch]
    total = None
    for i in range(accum_steps):
        out = loss_fn(*(p[i] for p in parts))
        (out[0] / accum_steps).backward()
        out = [o.detach() for o in out]
        total = out if total is None else [t + o for t, o in zip(total, out)]
    return [t / accum_steps for t in total]


def _clip_and_update(params, optimizer: torch.optim.Optimizer, grad_clip: Optional[float]):
    if grad_clip is not None:
        # min(1, clip / (norm + 1e-6)) times the grads, as the JAX steps.
        torch.nn.utils.clip_grad_norm_(params, grad_clip)
    optimizer.step()


def make_classifier_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, mean, std, augment: bool = True,
    label_smoothing: float = 0.0, grad_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, n_classes: Optional[int] = None,
    accum_steps: int = 1, device: Device = None,
) -> Callable[..., Dict[str, Tensor]]:
    """Train step: returns ``step(x_u8, y, generator) -> {"loss", "acc"}``.

    Each call updates the model's parameters and ``optimizer`` (built over
    them, e.g. ``torch.optim.AdamW(model.parameters(), 3e-3,
    weight_decay=0.05)``, the counterpart of ``optax.adamw``) in place.
    ``generator`` (on the step's device) feeds the augment and the model's
    drop-path and dropout masks; it may be None only when neither draws.
    ``accum_steps > 1`` splits the batch into interleaved microbatches whose
    fp32 grads are summed before one update. The step runs on ``device``
    (the GPU unless given) and moves its inputs there; the model must
    already live on it.
    """
    return _train_step(model, optimizer, mean, std, augment, label_smoothing, grad_clip,
                       compute_dtype, n_classes, accum_steps, "none", device)


def make_scanned_classifier_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, mean, std, unroll_steps: int,
    augment: bool = True, label_smoothing: float = 0.0, grad_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, remat: str = "none",
    device: Device = None,
) -> Callable[..., Dict[str, Tensor]]:
    """K = ``unroll_steps`` train steps over a stacked (K, B, ...) super-batch:
    ``step(x_u8 (K, B, C, H, W), y (K, B), generator) -> {"loss": (K,),
    "acc": (K,)}``, one optimizer update per step, as a Python loop.

    ``remat``: "none" | "full" (``torch.utils.checkpoint`` around the forward:
    recompute in backward) | "dots" (selective checkpointing that saves the
    matmul outputs, ``mm``, ``bmm`` and ``addmm``, and recomputes the rest).
    """
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat mode {remat!r}")
    one = _train_step(model, optimizer, mean, std, augment, label_smoothing, grad_clip,
                      compute_dtype, None, 1, remat, device)

    def step(x_u8: Tensor, y: Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Tensor]:
        if x_u8.shape[0] != unroll_steps or y.shape[0] != unroll_steps:
            raise ValueError(f"expected {unroll_steps} stacked batches, got "
                             f"{x_u8.shape[0]} and {y.shape[0]}")
        out = [one(x_u8[i], y[i], generator) for i in range(unroll_steps)]
        return {k: torch.stack([m[k] for m in out]) for k in ("loss", "acc")}

    return step


def make_classifier_eval_step(
    model: nn.Module, mean, std, compute_dtype: Optional[torch.dtype] = None,
    device: Device = None,
) -> Callable[[Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """Eval step: returns ``step(x_u8, y, valid_mask) -> (#correct, #valid)``.

    fp32 by default (``compute_dtype=None``): eval statistics are
    accuracy-critical, and bf16 argmax flips on borderline samples. With a
    ``compute_dtype`` the input and the model's float parameters are cast to
    it at every call, as the JAX step casts its params. Every call puts the
    model in eval mode (a train step in between leaves it in train mode). The
    step runs on ``device`` (the GPU unless given) and moves its inputs
    there; the model must already live on it.
    """
    device = resolve_device(device)

    @torch.inference_mode()
    def step(x_u8: Tensor, y: Tensor, valid_mask: Tensor) -> Tuple[Tensor, Tensor]:
        model.eval()
        x = pp.cifar_eval_transform(x_u8.to(device, non_blocking=True), mean, std)
        logits = _forward(model, x, compute_dtype).float()
        valid = valid_mask.to(device, torch.float32)
        correct = (logits.argmax(-1) == y.to(device)).to(torch.float32) * valid
        return correct.sum(), valid.sum()

    return step


def make_lm_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, grad_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, accum_steps: int = 1,
    device: Device = None,
) -> Callable[..., Dict[str, Tensor]]:
    """Causal-LM train step for the GPT family: returns ``step(idx, targets,
    generator=None) -> {"loss"}``.

    The model (``TinyTransformerLM``, ``GPT_MoP``) runs in train mode with
    its float params cast to ``compute_dtype`` (None: fp32); the token ids
    and targets stay integer. The loss is the model's fp32 mean
    cross-entropy and the grads reach the fp32 params in fp32; then
    ``optimizer`` (built over them, e.g. ``torch.optim.AdamW(
    model.parameters(), 3e-4, weight_decay=0.1)``) takes one step.
    ``generator`` (on the step's device) feeds the dropout masks; it may be
    None only at dropout 0. ``accum_steps > 1`` splits the batch into
    interleaved microbatches, one update a call. ``grad_clip`` scales the
    grads by ``min(1, clip / (norm + 1e-6))`` wherever it is not None, as
    the JAX LM step: a clip of 0 zeroes them. The step runs on ``device``
    (the GPU unless given) and moves its inputs there; the model must
    already live on it.
    """
    device = resolve_device(device)
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_fn(idx, targets):
        return (_call(model, compute_dtype, idx, targets=targets)[1].float(),)

    def step(idx: Tensor, targets: Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Tensor]:
        model.train()
        set_generator(model, generator)
        batch = (idx.to(device, non_blocking=True), targets.to(device, non_blocking=True))
        optimizer.zero_grad(set_to_none=True)
        (loss,) = _accumulate(loss_fn, batch, accum_steps)
        _clip_and_update(params, optimizer, grad_clip)
        return {"loss": loss}

    return step
