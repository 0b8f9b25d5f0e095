"""Sharded checkpoints over ``torch.distributed.checkpoint`` — the port of
the orbax paths of ``mop_tpu/training/utils.py`` (``save_checkpoint_orbax``
and ``AsyncCheckpointManager.save`` of a distributed layout,
``restore_checkpoint_sharded``, ``restore(..., shardings=)``).

A tensor of a sharded model carries its layout as its ``sharding``
attribute (``mesh.Sharding``: for each of its dims, the mesh axis it is
split over), set where the parallel modes split it: FSDP and ZeRO-1 over
``data``, tensor parallelism over ``model``, a pipeline stage over its stage
axis. Saving wraps each such local tensor as a ``DTensor`` of the mesh's
``device_mesh`` (``Shard(dim)`` on its axes, ``Replicate()`` on the others),
so every process writes its shards with their place in the global tensor
and a replicated one is written once. The packed ``qkv`` of a
tensor-parallel ViT, split by head rather than in one block, is gathered and
written whole. An optimizer's moments are written beside their parameters,
by the parameter's name, in its layout; its scalars (AdamW's ``step``) whole.

Restoring reads into whatever layout the target already has, which may
differ from the saved one (FSDP to replicated, or to dp x tp on another
mesh): each target tensor is a ``DTensor`` in its own layout, and the
reader copies the overlapping parts of every saved shard into it. Files are
``torch.distributed.checkpoint``'s, in the step directory; every process
calls the save and the restore (they are collectives).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch import nn

from . import comm
from .mesh import Sharding

Tensor = torch.Tensor

METADATA = ".metadata"  # the file that marks a torch.distributed.checkpoint directory


def _orig_name(name: str) -> str:
    from .fsdp import _orig_name as orig

    return orig(name)


def named_tensors(params) -> Dict[str, Tensor]:
    """``params`` (a module, or a dict of tensors, nested dicts joined by
    ``/``) as ``{name: local tensor}``, a module's parameters under their
    names before any FSDP parametrization."""
    if isinstance(params, nn.Module):
        out = {_orig_name(n): p for n, p in params.named_parameters()}
        out.update(params.named_buffers())
        return out
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in named_tensors(v).items()})
        elif isinstance(v, Tensor):
            out[k] = v
    return out


def _split(sh: Optional[Sharding]) -> bool:
    """Whether ``sh`` splits a dim over a mesh with a process group."""
    return sh is not None and sh.mesh.device_mesh is not None and any(sh.spec)


def is_sharded(params, opt_state=None) -> bool:
    """Whether a model (or tensors) or its optimizer holds sharded tensors."""
    tensors = list(named_tensors(params).values()) if params is not None else []
    tensors += [layout for _, layout, _ in _opt_entries(opt_state, {})]
    return any(_split(getattr(t, "sharding", None)) for t in tensors)


def _opt_entries(opt, names: Dict[int, str]) -> List[Tuple[str, Tensor, dict]]:
    """(parameter name, the tensor whose layout its state has, its state)
    for each parameter of ``opt`` (a ZeRO-1 optimizer's slices under their
    parameters' names)."""
    from .fsdp import Zero1Optimizer

    if opt is None or not hasattr(opt, "param_groups"):
        return []
    if isinstance(opt, Zero1Optimizer):
        return [(names.get(id(p), ""), own, opt.optimizer.state[own]) for p, _, own in opt.entries]
    return [(names.get(id(p), ""), p, opt.state[p]) for g in opt.param_groups for p in g["params"]]


def _global_shape(local: Tensor, sh: Sharding) -> List[int]:
    shape = list(local.shape)
    for dim, axis in enumerate(sh.spec):
        if axis is not None:
            shape[dim] *= sh.mesh.shape[axis]
    return shape


def _dtensor(local: Tensor, sh: Sharding):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate() for _ in sh.mesh.axis_names]
    for dim, axis in enumerate(sh.spec):
        if axis is not None:
            placements[sh.mesh.axis_names.index(axis)] = Shard(dim)
    shape = torch.Size(_global_shape(local, sh))
    return DTensor.from_local(local, sh.mesh.device_mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def _by_head_full(local: Tensor, sh: Sharding) -> Tensor:
    """The whole packed qkv from each process's heads (``tp._take``'s inverse)."""
    group = sh.mesh.group(next(a for a in sh.spec if a is not None))
    full = comm._gather(local.reshape(3, -1, local.shape[-1]), 1, group)
    return full.reshape(-1, local.shape[-1])


def _saved(t: Tensor, layout: Tensor):
    """What is written for ``t`` (a tensor in ``layout``'s layout, or a
    scalar beside it): a DTensor of its shards, or the whole tensor."""
    sh = getattr(layout, "sharding", None)
    t = t.detach()
    if not _split(sh) or t.shape != layout.shape:
        return t
    if getattr(layout, "by_head", False):
        return _by_head_full(t, sh)
    return _dtensor(t, sh)


def _names(params) -> Dict[int, str]:
    return {id(t): n for n, t in named_tensors(params).items()}


def save_sharded(path: str, params, opt_state=None, step: int = 0) -> None:
    """Write ``{step, params[, opt_state]}`` of a sharded layout into the
    directory ``path`` (replaced if it exists), every process its shards;
    the directory appears when whole. Every process calls it."""
    state: Dict[str, Any] = {"step": torch.tensor(int(step))}
    for n, t in named_tensors(params).items():
        state[f"params/{n}"] = _saved(t, t)
    for n, layout, st in _opt_entries(opt_state, _names(params)):
        for k, v in st.items():
            if isinstance(v, Tensor):
                state[f"opt_state/{n}/{k}"] = _saved(v, layout)
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-dcp"
    main = not dist.is_initialized() or dist.get_rank() == 0
    if main and os.path.exists(tmp):
        shutil.rmtree(tmp)
    _barrier()
    dcp.save(state, checkpoint_id=tmp, no_dist=not dist.is_initialized())
    _barrier()
    if main:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    _barrier()


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, METADATA))


def _coords_slice(full: Tensor, sh: Optional[Sharding], like: Tensor) -> Tensor:
    """This process's part of a whole tensor in ``like``'s layout ``sh``."""
    if sh is None or not any(sh.spec):
        return full
    if getattr(like, "by_head", False):
        axis = next(a for a in sh.spec if a is not None)
        n, i = sh.mesh.shape[axis], sh.mesh.axis_index(axis)
        return full.reshape(3, n, -1, full.shape[-1])[:, i].reshape(-1, full.shape[-1])
    for dim, axis in enumerate(sh.spec):
        if axis is not None:
            w = full.shape[dim] // sh.mesh.shape[axis]
            full = full.narrow(dim, sh.mesh.axis_index(axis) * w, w)
    return full


class _Target:
    """The read target of one tensor and how it lands in its destination."""

    def __init__(self, like: Tensor, sh: Optional[Sharding], size, dtype, name: str):
        self.like, self.sh, self.name = like, sh, name
        self.dtype = dtype
        if _split(sh) and not getattr(like, "by_head", False) and tuple(size) == tuple(
                _global_shape(like, sh)):
            self.read = _dtensor(torch.empty(like.shape, dtype=dtype, device=like.device), sh)
        else:
            self.read = torch.empty(tuple(size), dtype=dtype, device=like.device)

    def local(self) -> Tensor:
        from torch.distributed.tensor import DTensor

        if isinstance(self.read, DTensor):
            out = self.read.to_local()
        else:
            out = _coords_slice(self.read, self.sh, self.like)
        if out.shape != self.like.shape:
            raise ValueError(f"restore: {self.name} lands as {tuple(out.shape)} in its target "
                             f"layout but the target holds {tuple(self.like.shape)}; shard the "
                             "model (fsdp_shard_params / tp_shard_params) as its shardings say")
        return out


def _metadata(path: str):
    from torch.distributed.checkpoint import FileSystemReader

    return FileSystemReader(path).read_metadata().state_dict_metadata


def restore_sharded(path: str, like: Dict[str, Any], shardings: Optional[dict] = None
                    ) -> Dict[str, Any]:
    """Read a ``save_sharded`` directory into ``like``'s targets in place:
    ``like["params"]`` (a module or dict of tensors) and ``like["opt_state"]``
    (an optimizer, whose state is created for each parameter), each tensor
    in the layout ``shardings["params"][name]`` gives (default: its own
    ``sharding``, else whole). Returns ``like`` with ``step`` read."""
    md = _metadata(path)
    shardings = shardings or {}
    p_sh = shardings.get("params") or {}
    params = like.get("params")
    targets: Dict[str, _Target] = {}
    tensors = named_tensors(params) if params is not None else {}
    for n, t in tensors.items():
        key = f"params/{n}"
        if key not in md:
            raise KeyError(f"restore: {n} is not in the checkpoint at {path}")
        sh = p_sh.get(n, getattr(t, "sharding", None))
        targets[key] = _Target(t, sh, md[key].size, t.dtype, n)
    opt = like.get("opt_state")
    entries = _opt_entries(opt, _names(params)) if opt is not None and "opt_state" in like else []
    for n, layout, _ in entries:
        sh = p_sh.get(n, getattr(layout, "sharding", None))
        for key in [k for k in md if k.startswith(f"opt_state/{n}/")]:
            meta = md[key]
            dev = layout.device if tuple(meta.size) else torch.device("cpu")
            ref = layout if tuple(meta.size) else torch.empty((), device=dev)
            targets[key] = _Target(ref, sh if tuple(meta.size) else None, meta.size,
                                   meta.properties.dtype, key)
    step = torch.zeros((), dtype=md["step"].properties.dtype)
    state = {k: t.read for k, t in targets.items()}
    state["step"] = step
    dcp.load(state, checkpoint_id=path, no_dist=not dist.is_initialized())
    out = dict(like)
    with torch.no_grad():
        for n, t in tensors.items():
            t.copy_(targets[f"params/{n}"].local())
        for n, layout, st in entries:
            for key, tgt in targets.items():
                if key.startswith(f"opt_state/{n}/"):
                    k = key[len(f"opt_state/{n}/"):]
                    st[k] = tgt.local().clone()
                    if not tgt.read.shape and _on_param(opt, layout):
                        st[k] = st[k].to(layout.device)
        _sync_zero1(opt)
    out["step"] = int(step)
    return out


def _sync_zero1(opt) -> None:
    """A ZeRO-1 optimizer's slices from its restored whole weights."""
    from .fsdp import Zero1Optimizer, _slice

    if isinstance(opt, Zero1Optimizer):
        for p, dim, own in opt.entries:
            if dim is not None:
                own.copy_(_slice(p, dim, opt.group))


def _on_param(opt, p: Tensor) -> bool:
    """Whether the optimizer keeps a parameter's scalar state on its device
    (capturable or fused AdamW), else on the CPU."""
    groups = getattr(opt, "optimizer", opt).param_groups
    g = next((g for g in groups if any(q is p for q in g["params"])), {})
    return bool(g.get("capturable") or g.get("fused"))


def place_whole(payload: Dict[str, Any], like: Dict[str, Any], shardings: Optional[dict]
                ) -> Dict[str, Any]:
    """A whole-tensor payload (the ``torch.save`` format) into ``like``'s
    sharded params in place, each process keeping its part; an optimizer
    state of that format restores only into an unsharded optimizer."""
    p_sh = (shardings or {}).get("params") or {}
    saved = payload["params"]
    out = dict(payload)
    with torch.no_grad():
        for n, t in named_tensors(like["params"]).items():
            full = saved[n].to(t.device, t.dtype)
            local = _coords_slice(full, p_sh.get(n, getattr(t, "sharding", None)), t)
            if local.shape != t.shape:
                raise ValueError(f"restore: {n} {tuple(local.shape)} vs {tuple(t.shape)}")
            t.copy_(local)
    out["params"] = like["params"]
    if like.get("opt_state") is not None and "opt_state" in payload:
        if is_sharded(None, like["opt_state"]):
            raise NotImplementedError("a whole-tensor checkpoint's optimizer state restores into "
                                      "an unsharded optimizer only")
        like["opt_state"].load_state_dict(payload["opt_state"])
        out["opt_state"] = like["opt_state"]
    return out
