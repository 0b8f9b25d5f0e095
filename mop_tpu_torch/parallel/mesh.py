"""Device mesh and batch placement over ``torch.distributed`` — the port of
``mop_tpu/parallel/mesh.py``.

One process drives one device, as torch does; the JAX package drives every
local device from one process. So a ``Mesh`` here is one process's view of
the whole: its device, the axis sizes, its coordinate on each axis and each
axis's process group, from ``torch.distributed.device_mesh.init_device_mesh``.
Ranks are laid out row-major over ``(data, model)``, so a model group is a
run of consecutive ranks, on one node where the launcher numbers ranks node by
node (``multihost.make_multihost_mesh``).

With no process group and none asked for by the launcher's variables,
``make_mesh()`` is a world-1 mesh on the entry point's device with no groups:
a step built over it runs no collective at all and is the single-device step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"

Device = Optional[Union[str, torch.device]]


class Mesh:
    """This process's place in a device mesh.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh.shape``;
    ``coords`` this process's index on each axis; ``group(axis)`` the process
    group of the ranks that share every other coordinate with this one (None
    on a world-1 mesh with no group); ``device`` this process's device.
    """

    def __init__(self, device: torch.device, names: Sequence[str], sizes: Sequence[int],
                 device_mesh=None):
        self.device = device
        self.axis_names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in sizes)))
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.coords = {n: 0 for n in names}
            self._groups = {n: None for n in names}
        else:
            self.coords = dict(zip(names, device_mesh.get_coordinate()))
            self._groups = {n: device_mesh.get_group(n) for n in names}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.device_mesh is not None else 0

    def group(self, axis: str):
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, coords {self.coords}, "
                f"device {self.device})")


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: ``spec`` names, for each leading
    dimension, the axis it is split over (None: not split); an empty spec is
    replicated — the ``PartitionSpec`` of a ``NamedSharding``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def _build(device: torch.device, names: Sequence[str], sizes: Sequence[int]) -> Mesh:
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        return Mesh(device, names, sizes,
                    init_device_mesh(device.type, tuple(sizes), mesh_dim_names=tuple(names)))
    return Mesh(device, names, sizes)


def _world(n_devices: Optional[int], device: Device, what: str) -> Tuple[int, torch.device]:
    from .multihost import init_distributed

    init_distributed(device=resolve_device(device))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None:
        if n_devices > world:
            raise ValueError(
                f"{what}: requested n_devices={n_devices} but the process group has only "
                f"{world} (one process per device; start more with cli/launch_multihost.py or "
                "torchrun). A silent truncation here would fake multi-device validation on "
                "fewer devices.")
        if n_devices < world:
            raise ValueError(f"{what}: n_devices={n_devices} is part of the {world}-process "
                             "group; a mesh spans the whole group")
    return world, resolve_device(device)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: Device = None) -> Mesh:
    """A ('data', 'model') mesh over every process of the group.

    ``model_parallel=1`` is pure data parallelism. The process group is
    started here on first use from the launcher's variables
    (``multihost.init_distributed``: torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so every CLI runs
    data-parallel under a launcher unchanged. ``device`` is this process's
    device (the entry point's ``resolve_device``: ``cuda:LOCAL_RANK`` under
    a group). ``n_devices`` above the group's size raises.
    """
    world, dev = _world(n_devices, device, "make_mesh")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"make_mesh: model_parallel={model_parallel} does not divide the "
                         f"{world} processes")
    return _build(dev, (DATA_AXIS, MODEL_AXIS), (world // model_parallel, model_parallel))


def make_mesh3(n_devices: Optional[int] = None, tensor_parallel: int = 1,
               pipeline_parallel: int = 1, device: Device = None) -> Mesh:
    """('data', 'model', 'stage') mesh for composed dp x tp x pp."""
    world, dev = _world(n_devices, device, "make_mesh3")
    mp = tensor_parallel * pipeline_parallel
    if mp < 1 or world % mp:
        raise ValueError(f"make_mesh3: tp {tensor_parallel} x pp {pipeline_parallel} does not "
                         f"divide the {world} processes")
    return _build(dev, (DATA_AXIS, MODEL_AXIS, STAGE_AXIS),
                  (world // mp, tensor_parallel, pipeline_parallel))


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rows(n: int, mesh: Mesh) -> slice:
    d = mesh.shape[DATA_AXIS]
    if n % d:
        raise ValueError(f"batch of {n} rows does not divide by the data axis {d}")
    per = n // d
    i = mesh.axis_index(DATA_AXIS)
    return slice(i * per, (i + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This process's rows of a global batch, on its device.

    Every process passes the SAME full global batch (the experiment streams
    are seed-deterministic, so each makes it identically) and keeps the rows
    of its data index, ``[i * B / D, (i + 1) * B / D)``: the processes of one
    model group keep the same rows. Leaves are tensors or numpy arrays.
    """
    def take(a):
        a = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
        return a[_rows(a.shape[0], mesh)].to(mesh.device, non_blocking=True)

    return _tree_map(take, batch)


def replicate(tree, mesh: Mesh):
    """The same values on every process: each tensor (or an ``nn.Module``'s
    parameters and buffers, in place) on this process's device, broadcast
    from global rank 0. Returns the tree (or the module)."""
    if isinstance(tree, torch.nn.Module):
        tree.to(mesh.device)
        if mesh.device_mesh is not None:
            with torch.no_grad():
                for t in list(tree.parameters()) + list(tree.buffers()):
                    comm.broadcast_(t.data)
        return tree

    def put(a):
        a = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
        a = a.to(mesh.device).clone()
        return comm.broadcast_(a) if mesh.device_mesh is not None else a

    return _tree_map(put, tree)
