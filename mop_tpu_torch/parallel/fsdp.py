"""Fully-sharded data parallelism (FSDP / ZeRO-3) and ZeRO-1 over the mesh's
``data`` axis — the port of ``mop_tpu/parallel/fsdp.py``.

Which parameters are sharded, and along which dimension, is the JAX
package's rule, kept exactly: ``fsdp_spec`` picks the largest dimension that
divides by the data axis and replicates anything below ``min_size``
elements. The port applies it to each parameter in its JAX layout
(``paths.jax_axes``), so it shards the same dimension of the same tensor.

``fsdp_shard_params`` keeps on each process only its slice of each sharded
parameter, as the module's parameter, under a parametrization
(``torch.nn.utils.parametrize``) that all-gathers the whole tensor each time
the module reads it, cast to the step's compute dtype first, and
reduce-scatters its fp32 gradient (the mean over the data axis) back to the
slice: what FSDP2's ``fully_shard`` does with ``MixedPrecisionPolicy(
param_dtype=compute_dtype, reduce_dtype=float32)``, on the JAX rule's dim
rather than always dim 0. Replicated parameters are cast likewise and their
gradients all-reduced. The optimizer, built over the model's parameters
after the sharding, then holds 1/D of each sharded moment
(``fsdp_init_opt_state``). A gathered copy lives until its layer's backward
has used it.

ZeRO-1 (``shard_params=False``): the weights stay whole on every process;
the gradients are reduce-scattered by the same rule, the optimizer updates
each process's slice (its moments 1/D, ``zero1_init_opt_state``) and the
updated slices are all-gathered into the weights.

Semantics: the fp32 step equals the replicated data-parallel step up to
reduction order (``tests/test_torch_parallel_fsdp.py``).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from ..models.layers import set_generator
from ..ops import preprocess as pp
from . import comm
from .mesh import DATA_AXIS, Mesh, Sharding
from .paths import jax_axes
from .train_step import _DataParallel, _call, _step_device

Tensor = torch.Tensor

# Parameters smaller than this many elements stay replicated: gathering a
# 1-D LayerNorm scale costs more in latency than its storage saves.
DEFAULT_MIN_SIZE = 2**12


def fsdp_spec(shape, n_shards: int, min_size: int = DEFAULT_MIN_SIZE):
    """The spec (a tuple, one entry per dim) sharding the largest dividing
    dim over the data axis; () (replicated) for scalars, tensors below
    ``min_size`` elements and tensors with no dim divisible by ``n_shards``."""
    if not shape or math.prod(shape) < min_size:
        return ()
    order = sorted(range(len(shape)), key=lambda i: (-shape[i], i))
    for i in order:
        if shape[i] % n_shards == 0:
            spec = [None] * len(shape)
            spec[i] = DATA_AXIS
            return tuple(spec)
    return ()


def _torch_spec(model: nn.Module, name: str, shape, n: int, min_size: int):
    """``fsdp_spec`` of the parameter's JAX layout, as a spec of its torch
    dims."""
    axes = jax_axes(model, name, len(shape))
    jspec = fsdp_spec(tuple(shape[a] for a in axes), n, min_size)
    if not jspec:
        return ()
    spec = [None] * len(shape)
    spec[axes[jspec.index(DATA_AXIS)]] = DATA_AXIS
    return tuple(spec)


def _orig_name(name: str) -> str:
    return re.sub(r"\.parametrizations\.(\w+)\.original$", r".\1", name)


def fsdp_param_shardings(model: nn.Module, mesh: Mesh,
                         min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, Sharding]:
    """``{name: Sharding}`` of every parameter by ``fsdp_spec`` (the spec's
    entries are the torch tensor's dims)."""
    n = mesh.shape[DATA_AXIS]
    out = {}
    for name, p in model.named_parameters():
        name = _orig_name(name)
        shape = getattr(p, "full_shape", tuple(p.shape))
        out[name] = Sharding(mesh, _torch_spec(model, name, shape, n, min_size))
    return out


def _slice(t: Tensor, dim: int, group) -> Tensor:
    w, r = comm.group_size(group), comm.group_rank(group)
    n = t.shape[dim] // w
    return t.narrow(dim, r * n, n)


class _GatherParam(torch.autograd.Function):
    """The whole parameter from each process's slice, cast to ``dtype``; its
    gradient in fp32, reduce-scattered and scaled back to the slice."""

    @staticmethod
    def forward(ctx, local, dim, group, dtype, scale):
        ctx.dim, ctx.group, ctx.scale, ctx.dtype = dim, group, scale, local.dtype
        x = local.to(dtype) if dtype is not None else local
        return comm._gather(x, dim, group) if group is not None else x

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.dtype)
        if ctx.group is not None:
            g = comm._reduce_scatter(g, ctx.dim, ctx.group)
        return g * ctx.scale, None, None, None, None


class FSDPParam(nn.Module):
    """The parametrization of one parameter: ``dim`` None for a replicated
    one. ``param_dtype`` is the compute dtype the step sets."""

    def __init__(self, dim: Optional[int], group, size: int):
        super().__init__()
        self.dim, self.group, self.scale = dim, group, 1.0 / size
        self.param_dtype: Optional[torch.dtype] = None

    def forward(self, local: Tensor) -> Tensor:
        if self.dim is None:  # its gradient is all-reduced by the step, with the others'
            return local.to(self.param_dtype) if self.param_dtype is not None else local
        return _GatherParam.apply(local, self.dim, self.group, self.param_dtype, self.scale)


def fsdp_shard_params(model: nn.Module, mesh: Mesh,
                      min_size: int = DEFAULT_MIN_SIZE) -> nn.Module:
    """Shard ``model`` in place (the module's docstring) and return it. Each
    sharded parameter keeps 1/D of its dim as ``...parametrizations.<name>.
    original``, with ``full_shape`` and ``shard_dim`` attributes; the model
    must already be on the mesh's device with the same values everywhere
    (``mesh.replicate``)."""
    group, n = mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS]
    specs = fsdp_param_shardings(model, mesh, min_size)
    for name, sh in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        p = getattr(owner, leaf)
        dim = sh.spec.index(DATA_AXIS) if sh.spec else None
        with torch.no_grad():
            local = nn.Parameter((_slice(p, dim, group) if dim is not None else p).clone())
        local.full_shape, local.shard_dim, local.sharding = tuple(p.shape), dim, sh
        owner._parameters[leaf] = local
        parametrize.register_parametrization(owner, leaf, FSDPParam(dim, group, n), unsafe=True)
    model._fsdp_mesh = mesh
    return model


def _fsdp_params(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, FSDPParam)]


def fsdp_init_opt_state(make_optimizer: Callable, model: nn.Module, mesh: Mesh,
                        min_size: int = DEFAULT_MIN_SIZE) -> torch.optim.Optimizer:
    """The optimizer (``make_optimizer(params)``, e.g. ``lambda p:
    torch.optim.AdamW(p, 1e-3)``) over an FSDP model's parameters, each
    process's slices: its moments are sharded exactly like them. Shards the
    model first if ``fsdp_shard_params`` has not."""
    if not _fsdp_params(model):
        fsdp_shard_params(model, mesh, min_size)
    return make_optimizer(list(model.parameters()))


class Zero1Optimizer:
    """ZeRO-1: ``make_optimizer`` over each process's slice of every
    parameter (the whole of a replicated one), the weights kept whole.
    ``reduce_grads()`` reduce-scatters (all-reduces) each gradient's mean into
    the slices; ``step()`` updates them and all-gathers the weights."""

    def __init__(self, make_optimizer: Callable, model: nn.Module, mesh: Mesh,
                 min_size: int = DEFAULT_MIN_SIZE):
        self.group, self.size = mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS]
        specs = fsdp_param_shardings(model, mesh, min_size)
        self.entries = []  # (param, shard dim or None, slice parameter)
        for name, p in model.named_parameters():
            dim = specs[name].spec.index(DATA_AXIS) if specs[name].spec else None
            if dim is None:
                self.entries.append((p, None, p))
            else:
                with torch.no_grad():
                    own = nn.Parameter(_slice(p, dim, self.group).clone())
                own.full_shape, own.shard_dim = tuple(p.shape), dim
                own.sharding = specs[name]
                self.entries.append((p, dim, own))
        self.optimizer = make_optimizer([own for _, _, own in self.entries])
        self.param_groups = self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, _, own in self.entries:
            p.grad = None
            own.grad = None

    def reduce_grads(self) -> None:
        rep = []
        for p, dim, own in self.entries:
            if p.grad is None:
                continue
            if dim is None:
                rep.append(p.grad)
            elif self.group is None:
                own.grad = p.grad
            else:
                own.grad = comm._reduce_scatter(p.grad, dim, self.group) / self.size
        comm.all_reduce_flat_(rep, self.group, 1.0 / self.size)

    def shard_grads(self):
        """(the slices' grads, the replicated params' grads)."""
        return ([own.grad for _, d, own in self.entries if d is not None and own.grad is not None],
                [own.grad for _, d, own in self.entries if d is None and own.grad is not None])

    @torch.no_grad()
    def step(self) -> None:
        self.optimizer.step()
        for p, dim, own in self.entries:
            if dim is not None:
                p.copy_(comm._gather(own, dim, self.group) if self.group is not None else own)


def zero1_init_opt_state(make_optimizer: Callable, model: nn.Module, mesh: Mesh,
                         min_size: int = DEFAULT_MIN_SIZE) -> Zero1Optimizer:
    """The ZeRO-1 optimizer: replicated weights, moments sharded by the same
    rule (``Zero1Optimizer``)."""
    return Zero1Optimizer(make_optimizer, model, mesh, min_size)


def _clip(sharded: Sequence[Tensor], replicated: Sequence[Tensor], group,
          grad_clip: Optional[float]) -> None:
    """Scale every grad by ``min(1, clip / (global norm + 1e-6))``, the global
    norm over the whole (unsharded) gradient, as the JAX step clips."""
    if grad_clip is None:
        return
    ref = (list(sharded) + list(replicated))[0]
    sq = torch.zeros((), dtype=torch.float32, device=ref.device)
    for g in sharded:
        sq = sq + g.float().pow(2).sum()
    comm.all_reduce_(sq, group)
    for g in replicated:
        sq = sq + g.float().pow(2).sum()
    scale = torch.clamp(grad_clip / (sq.sqrt() + 1e-6), max=1.0)
    for g in list(sharded) + list(replicated):
        g.mul_(scale)


def _fsdp_step(model, optimizer, mesh, loss_fn, grad_clip, compute_dtype, shard_params,
               device):
    """``step(*batch, generator) -> {"loss"}`` of either layout; ``loss_fn(
    forward, *batch, generator)`` with ``forward(*args, **kwargs)`` the
    model's in the compute dtype."""
    device = _step_device(device, mesh)
    dp = _DataParallel(mesh, model)
    group = mesh.group(DATA_AXIS)
    if shard_params:
        if not _fsdp_params(model):
            raise ValueError("shard_params=True: pass the model through fsdp_shard_params "
                             "and the optimizer through fsdp_init_opt_state first")
        for m in _fsdp_params(model):
            m.param_dtype = compute_dtype

        def forward(*args, **kwargs):
            return model(*args, **kwargs)
    else:
        if not isinstance(optimizer, Zero1Optimizer):
            raise ValueError("shard_params=False (ZeRO-1): build the optimizer with "
                             "zero1_init_opt_state")

        def forward(*args, **kwargs):
            return _call(model, compute_dtype, *args, **kwargs)

    def step(*batch, generator: Optional[torch.Generator] = None):
        model.train()
        set_generator(model, generator)
        dp.draw_shards()
        batch = [b.to(device, non_blocking=True) for b in batch]
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(forward, *batch, generator)
        loss.backward()
        if shard_params:
            sharded = [p.grad for p in model.parameters()
                       if p.grad is not None and getattr(p, "shard_dim", None) is not None]
            rep = [p.grad for p in model.parameters()
                   if p.grad is not None and getattr(p, "shard_dim", None) is None]
            comm.all_reduce_flat_(rep, group, 1.0 / dp.size)
        else:
            optimizer.reduce_grads()
            sharded, rep = optimizer.shard_grads()
        _clip(sharded, rep, group, grad_clip)
        optimizer.step()
        (loss,) = dp.mean(loss.detach())
        return {"loss": loss}

    return step


def make_fsdp_classifier_train_step(
    model: nn.Module, optimizer, mesh: Mesh, mean, std, augment: bool = True,
    grad_clip: Optional[float] = None, compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    shard_params: bool = True, device=None,
):
    """FSDP train step for an image classifier: ``step(x_u8, y, generator) ->
    {"loss"}``, each process passing its rows (``shard_batch``).

    ``shard_params=True`` (FSDP / ZeRO-3): the model through
    ``fsdp_shard_params`` and the optimizer from ``fsdp_init_opt_state``.
    ``shard_params=False`` (ZeRO-1): the model replicated and the optimizer
    from ``zero1_init_opt_state``. The augment's draws are the global batch's
    (see ``train_step``)."""
    dp = _DataParallel(mesh, model)

    def loss_fn(forward, x_u8, y, generator):
        if augment:
            x = pp.cifar_train_augment(generator, x_u8, mean, std, shard=dp.shard)
        else:
            x = pp.cifar_eval_transform(x_u8, mean, std)
        x = x.to(compute_dtype) if compute_dtype is not None else x
        return F.cross_entropy(forward(x).float(), y.long())

    step = _fsdp_step(model, optimizer, mesh, loss_fn, grad_clip, compute_dtype, shard_params,
                      device)

    def classifier_step(x_u8: Tensor, y: Tensor, generator: Optional[torch.Generator] = None):
        if augment and generator is None:
            raise ValueError("the train augment draws from an explicit torch.Generator; "
                             "pass one on the step's device")
        return step(x_u8, y, generator=generator)

    return classifier_step


def make_fsdp_lm_train_step(
    model: nn.Module, optimizer, mesh: Mesh, grad_clip: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16, shard_params: bool = True,
    device=None,
):
    """FSDP train step for the GPT family: ``step(idx, targets, generator=None)
    -> {"loss"}`` over each process's rows of the batch."""
    def loss_fn(forward, idx, targets, generator):
        return forward(idx, targets=targets)[1].float()

    step = _fsdp_step(model, optimizer, mesh, loss_fn, grad_clip, compute_dtype, shard_params,
                      device)

    def lm_step(idx: Tensor, targets: Tensor, generator: Optional[torch.Generator] = None):
        return step(idx, targets, generator=generator)

    return lm_step


def full_state_dict(model: nn.Module) -> Dict[str, Tensor]:
    """Every parameter whole, under its name before the sharding (a
    collective over the data axis for the sharded ones)."""
    mesh = getattr(model, "_fsdp_mesh", None)
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = getattr(p, "shard_dim", None)
            if dim is not None and mesh is not None and mesh.group(DATA_AXIS) is not None:
                p = comm._gather(p.detach(), dim, mesh.group(DATA_AXIS))
            out[_orig_name(name)] = p.detach().clone()
    return out
