"""Train and eval steps on one device — the port of
``make_classifier_train_step``, ``make_scanned_classifier_train_step``,
``make_classifier_eval_step``, ``make_imagenet_train_step``,
``make_lm_train_step`` and ``cast_floats`` from
``mop_tpu/parallel/train_step.py``.

Train: uint8 NCHW in, augment (or normalize) on the device, params cast to
the compute dtype, forward with ``train=True``, fp32 logits and
cross-entropy, fp32 grads, then the optimizer updates the model's fp32
parameters in place. Random draws (augment, drop-path, dropout) come from the
``torch.Generator`` the caller passes to each step, never from the global
RNG. Eval: normalize, forward in eval mode, ``(#correct, #valid)`` out.
Each step sets the model's mode on every call. The LM step takes token ids
and targets, which stay integer, and the model's fp32 mean cross-entropy.

Data parallel: every step takes ``mesh`` (``parallel.mesh.make_mesh``).
Under a mesh each process passes its own B / D rows (``shard_batch``) and
holds the whole model; the step all-reduces the fp32 grads to their mean over
the data axis before the clip (one flat buffer per dtype), reports the global
mean loss and accuracy, and the eval step the summed counts. The per-sample
draws (augment, drop-path, dropout) are taken for the global batch from the
same generator on every process, which keeps its own rows
(``preprocess.global_rows``, ``layers.RandomDrop.shards``), so a D-process step
draws what the one-device step draws for the same rows. Mixup and CutMix pair
each row with the reversed global batch's: the rows held by the mirror
process, exchanged point to point. ``mesh=None`` (or a world-1 mesh with no
process group) is the one-device step and runs no collective.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from ..models.layers import RandomDrop, set_generator
from ..ops import preprocess as pp
from ..utils.device import resolve_device
from . import comm
from .mesh import DATA_AXIS

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


class _DataParallel:
    """The data axis of a step's mesh: its group (None: no collective), its
    size and this process's index on it, and the model's random-drop
    modules."""

    def __init__(self, mesh, model: nn.Module):
        self.group = mesh.group(DATA_AXIS) if mesh is not None else None
        self.size = mesh.shape[DATA_AXIS] if mesh is not None else 1
        self.index = mesh.axis_index(DATA_AXIS) if mesh is not None else 0
        # The per-sample draws' block of the global batch (preprocess.Shard).
        self.shard = (self.index, self.size) if self.size > 1 else None
        self.drops = [m for m in model.modules() if isinstance(m, RandomDrop)]

    def draw_shards(self, extra=lambda m: ()) -> None:
        """Each drop module's mask is the global batch's, plus ``extra(m)``."""
        own = ((0, self.index, self.size),) if self.size > 1 else ()
        for m in self.drops:
            m.shards = own + extra(m)

    def mean_grads(self, params) -> None:
        """Each grad replaced by its mean over the data axis."""
        grads = [p.grad for p in params if p.grad is not None]
        comm.all_reduce_flat_(grads, self.group, 1.0 / self.size)

    def mean(self, *values: Tensor):
        """The mean over the data axis of each of these scalars."""
        if self.group is None:
            return values
        v = torch.stack([t.float() for t in values])
        comm.all_reduce_(v, self.group)
        return tuple(v / self.size)

    def mirror(self, t: Tensor) -> Tensor:
        """The rows of the reversed global batch that pair with ``t``'s rows:
        the mirror process's (data index D - 1 - i) rows, reversed."""
        j = self.size - 1 - self.index
        if self.group is None or j == self.index:
            return t.flip(0)
        peer = dist.get_global_rank(self.group, j)
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer, self.group),
               dist.P2POp(dist.irecv, out, peer, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.flip(0)


def _step_device(device, mesh):
    """The step's device: the mesh's, which ``device`` (if given) must name."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


# The ops whose outputs remat="dots" saves: the matmuls, as JAX's
# checkpoint_dots saves the dot_general outputs. Everything else is recomputed.
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default))
# remat="dots_nb" saves only the products with no batch dimension, as JAX's
# dots_with_no_batch_dims_saveable: the linears' mm and addmm (weight
# stationary), not the attention's or the experts' batched bmm.
_NO_BATCH_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))
REMAT_MODES = ("none", "full", "dots", "dots_nb")


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_no_batch_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_POLICIES = {"dots": _save_dots, "dots_nb": _save_no_batch_dots}


def _blocks(model: nn.Module):
    """The model's transformer blocks: the children of each ``ModuleList``
    named ``blocks``."""
    found = [blk for name, mod in model.named_modules()
             if name.rsplit(".", 1)[-1] == "blocks" and isinstance(mod, nn.ModuleList)
             for blk in mod]
    if not found:
        raise ValueError(f"remat checkpoints each transformer block; {type(model).__name__} "
                         "has no ModuleList named 'blocks'")
    return found


@contextlib.contextmanager
def _checkpoint_blocks(blocks, generator, context_fn):
    """Within the context each block runs under ``torch.utils.checkpoint``:
    its input is saved (with whatever ``context_fn``'s policy saves) and the
    rest recomputed, one block at a time, in backward. The recompute calls
    the block with the params it ran with (the compute-dtype copies, which
    the backward no longer has in scope), and rewinds the generator to where
    the block's forward started, so it draws the same drop masks, then puts
    the generator back."""
    def wrap(blk):
        inner = blk.forward

        def forward(*args, **kwargs):
            if getattr(blk, "_in_recompute", False):
                return inner(*args, **kwargs)
            state = {**dict(blk.named_parameters()), **dict(blk.named_buffers())}
            at = generator.get_state() if generator is not None else None
            calls = []

            def run(*a):
                calls.append(1)
                now = None
                if at is not None and len(calls) > 1:
                    now = generator.get_state()
                    generator.set_state(at)
                blk._in_recompute = True
                try:
                    return functional_call(blk, state, a, kwargs)
                finally:
                    blk._in_recompute = False
                    if now is not None:
                        generator.set_state(now)

            return checkpoint(run, *args, use_reentrant=False, context_fn=context_fn)

        return forward

    for blk in blocks:
        blk.forward = wrap(blk)
    try:
        yield
    finally:
        for blk in blocks:
            del blk.forward


def _remat_forward(model, compute_dtype, remat):
    """``forward(x, generator) -> logits``: the model on ``x`` in
    ``compute_dtype``, under ``remat``, which checkpoints each transformer
    block: "none" (no checkpoint), "full" (recompute all of each block in
    backward), "dots" (all but the matmuls) or "dots_nb" (all but the
    products with no batch dimension). Per block, so that the backward holds
    one block's recomputed activations at a time, as ``jax.checkpoint``
    around each scanned block does."""
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}")
    if remat == "none":
        return lambda x, generator: _forward(model, x, compute_dtype)
    blocks = _blocks(model)
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _REMAT_POLICIES[remat])
                  if remat in _REMAT_POLICIES else noop_context_fn)

    def forward(x, generator):
        with _checkpoint_blocks(blocks, generator, context_fn):
            return _forward(model, x, compute_dtype)

    return forward


def _classifier_loss(model, mean, std, augment, label_smoothing, compute_dtype, n_classes,
                     remat, shard=None):
    """``loss_fn(x_u8, y, generator) -> (loss, acc)`` of one (micro)batch."""
    forward = _remat_forward(model, compute_dtype, remat)

    kw = {} if shard is None else {"shard": shard}

    def loss_fn(x_u8, y, generator):
        if augment:
            x = pp.cifar_train_augment(generator, x_u8, mean, std, **kw)
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
                compute_dtype, n_classes, accum_steps, remat, device, mesh=None):
    device = _step_device(device, mesh)
    dp = _DataParallel(mesh, model)
    loss_fn = _classifier_loss(model, mean, std, augment, label_smoothing, compute_dtype,
                               n_classes, remat, dp.shard)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x_u8: Tensor, y: Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Tensor]:
        if augment and generator is None:
            raise ValueError("the train augment draws from an explicit torch.Generator; "
                             "pass one on the step's device")
        model.train()
        set_generator(model, generator)
        dp.draw_shards()
        x_u8 = x_u8.to(device, non_blocking=True)
        y = y.to(device, non_blocking=True).long()
        optimizer.zero_grad(set_to_none=True)
        loss, acc = _accumulate(lambda x, t: loss_fn(x, t, generator), (x_u8, y), accum_steps)
        dp.mean_grads(params)
        _clip_and_update(params, optimizer, grad_clip)
        loss, acc = dp.mean(loss, acc)
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
    accum_steps: int = 1, device: Device = None, mesh=None,
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
    already live on it. Under ``mesh`` (data parallel, see the module's
    docstring) the step takes this process's rows and runs on the mesh's
    device.
    """
    return _train_step(model, optimizer, mean, std, augment, label_smoothing, grad_clip,
                       compute_dtype, n_classes, accum_steps, "none", device, mesh)


def make_scanned_classifier_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, mean, std, unroll_steps: int,
    augment: bool = True, label_smoothing: float = 0.0, grad_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, remat: str = "none",
    device: Device = None, mesh=None,
) -> Callable[..., Dict[str, Tensor]]:
    """K = ``unroll_steps`` train steps over a stacked (K, B, ...) super-batch:
    ``step(x_u8 (K, B, C, H, W), y (K, B), generator) -> {"loss": (K,),
    "acc": (K,)}``, one optimizer update per step, as a Python loop.

    ``remat``: "none" | "full" (``torch.utils.checkpoint`` around each
    transformer block: recompute in backward) | "dots" (selective
    checkpointing that saves the matmul outputs, ``mm``, ``bmm`` and
    ``addmm``, and recomputes the rest); see ``_remat_forward``.
    """
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat mode {remat!r}")
    one = _train_step(model, optimizer, mean, std, augment, label_smoothing, grad_clip,
                      compute_dtype, None, 1, remat, device, mesh)

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
    device: Device = None, mesh=None,
) -> Callable[[Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """Eval step: returns ``step(x_u8, y, valid_mask) -> (#correct, #valid)``.

    fp32 by default (``compute_dtype=None``): eval statistics are
    accuracy-critical, and bf16 argmax flips on borderline samples. With a
    ``compute_dtype`` the input and the model's float parameters are cast to
    it at every call, as the JAX step casts its params. Every call puts the
    model in eval mode (a train step in between leaves it in train mode). The
    step runs on ``device`` (the GPU unless given) and moves its inputs
    there; the model must already live on it. Under ``mesh`` each process
    passes its rows and the counts are summed over the data axis.
    """
    device = _step_device(device, mesh)
    group = mesh.group(DATA_AXIS) if mesh is not None else None

    @torch.inference_mode()
    def step(x_u8: Tensor, y: Tensor, valid_mask: Tensor) -> Tuple[Tensor, Tensor]:
        model.eval()
        x = pp.cifar_eval_transform(x_u8.to(device, non_blocking=True), mean, std)
        logits = _forward(model, x, compute_dtype).float()
        valid = valid_mask.to(device, torch.float32)
        correct = (logits.argmax(-1) == y.to(device)).to(torch.float32) * valid
        counts = comm.all_reduce_(torch.stack([correct.sum(), valid.sum()]), group)
        return counts[0], counts[1]

    return step


def make_imagenet_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, mean, std, n_classes: int,
    label_smoothing: float = 0.1, use_randaug: bool = False, randaug_n: int = 2,
    randaug_m: int = 9, random_erasing: float = 0.25, mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0, mix_prob: float = 0.5, grad_clip: Optional[float] = 1.0,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, remat: str = "none",
    device: Device = None, mesh=None,
) -> Callable[..., Dict[str, Tensor]]:
    """ImageNet-style train step with the full regularization suite, on the
    device: returns ``step(x_u8, y, generator) -> {"loss"}``.

    Crop with ``H // 8`` padding, flip, then RandAugment (``use_randaug``)
    and RandomErasing (``random_erasing`` > 0), normalize; label-smoothed
    one-hot targets; then Mixup or CutMix: with both alphas above 0 one of
    the two, Mixup with probability ``mix_prob`` (a uniform drawn first;
    only the chosen op draws from the generator, and reading the uniform
    waits for the stream once a step), else whichever alone is on. The
    forward runs with the float params cast to ``compute_dtype``; the soft
    cross-entropy is fp32 and the grads reach the fp32 params in fp32. The
    grads are scaled by ``min(1, clip / (norm + 1e-6))`` only where
    ``grad_clip > 0`` (the other steps clip wherever it is not None). Then
    ``optimizer`` takes one step. ``remat``: "none" | "full" | "dots" |
    "dots_nb" (see ``_remat_forward``) checkpoints each block of the
    network; the augment is never recomputed. ``generator`` (on the step's device) feeds
    the augment and the model's drop masks. The step runs on ``device``
    (the GPU unless given) and moves its inputs there; the model must
    already live on it. Under ``mesh``, data parallel (module docstring).
    """
    device = _step_device(device, mesh)
    dp = _DataParallel(mesh, model)
    forward = _remat_forward(model, compute_dtype, remat)
    params = [p for p in model.parameters() if p.requires_grad]
    both = mixup_alpha > 0 and cutmix_alpha > 0

    # The data-parallel arguments, given only under a data axis above 1.
    shard = {} if dp.shard is None else {"shard": dp.shard}
    pair = {} if dp.shard is None else {"reverse": dp.mirror}

    def loss_fn(x_u8, y, generator):
        use_mixup = both and float(torch.rand((), device=device, generator=generator)) < mix_prob
        x = pp.to_float(x_u8)
        x = pp.random_crop(generator, x, padding=x.shape[-1] // 8, **shard)
        x = pp.random_hflip(generator, x, **shard)
        if use_randaug:
            x = pp.rand_augment(generator, x, randaug_n, randaug_m, **shard)
        if random_erasing > 0:
            x = pp.random_erasing(generator, x, p=random_erasing, **shard)
        x = pp.normalize(x, mean, std)
        tgt = pp.label_smoothing_onehot(y, n_classes, label_smoothing)
        if use_mixup or (mixup_alpha > 0 and not both):
            x, tgt = pp.mixup(generator, x, tgt, alpha=mixup_alpha, **pair)
        elif cutmix_alpha > 0:
            x, tgt = pp.cutmix(generator, x, tgt, alpha=cutmix_alpha, **pair)
        logits = forward(x, generator).float()
        return -(tgt * torch.log_softmax(logits, -1)).sum(-1).mean()

    def step(x_u8: Tensor, y: Tensor, generator: torch.Generator) -> Dict[str, Tensor]:
        if generator is None:
            raise ValueError("the ImageNet augment draws from an explicit torch.Generator; "
                             "pass one on the step's device")
        model.train()
        set_generator(model, generator)
        dp.draw_shards()
        x_u8 = x_u8.to(device, non_blocking=True)
        y = y.to(device, non_blocking=True).long()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(x_u8, y, generator)
        loss.backward()
        dp.mean_grads(params)
        _clip_and_update(params, optimizer,
                         grad_clip if grad_clip is not None and grad_clip > 0 else None)
        (loss,) = dp.mean(loss.detach())
        return {"loss": loss}

    return step


def make_lm_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, grad_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, accum_steps: int = 1,
    device: Device = None, mesh=None,
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
    already live on it. Under ``mesh``, data parallel (module docstring).
    """
    device = _step_device(device, mesh)
    dp = _DataParallel(mesh, model)
    params = [p for p in model.parameters() if p.requires_grad]

    def loss_fn(idx, targets):
        return (_call(model, compute_dtype, idx, targets=targets)[1].float(),)

    def step(idx: Tensor, targets: Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Tensor]:
        model.train()
        set_generator(model, generator)
        dp.draw_shards()
        batch = (idx.to(device, non_blocking=True), targets.to(device, non_blocking=True))
        optimizer.zero_grad(set_to_none=True)
        (loss,) = _accumulate(loss_fn, batch, accum_steps)
        dp.mean_grads(params)
        _clip_and_update(params, optimizer, grad_clip)
        (loss,) = dp.mean(loss)
        return {"loss": loss}

    return step
