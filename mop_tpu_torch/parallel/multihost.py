"""Multi-process training: the process group, node-aware meshes and each
process's share of the global batch — the port of
``mop_tpu/parallel/multihost.py``.

One process per device. ``init_distributed`` starts the process group from
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``; ``cli/launch_multihost.py`` sets the
same), with NCCL when this process's device is a GPU and gloo when it is the
CPU, under a timeout. The JAX package starts its runtime at import
(``mop_tpu/config.py``), since ``jax.distributed`` must come before the
backend initialises; torch has no such rule, so ``make_mesh`` calls
``init_distributed`` lazily, on first use, and nothing happens at import.

- ``make_multihost_mesh``: a ('data', 'model') mesh whose model groups never
  cross a node (consecutive ranks, ``LOCAL_WORLD_SIZE`` per node).
- ``process_batch_slice`` / ``global_batch``: the rows this process supplies.
- ``replicate_multihost``: the same values on every process, from rank 0.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import DATA_AXIS, Mesh, _rows, _tree_map, make_mesh, replicate

# Seconds a collective (and the group's start) may wait before it raises.
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     local_rank: Optional[int] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group, once. Returns True when a group is (or already
    was) up, False when neither the arguments nor the environment ask for one
    (a single-process run: library code may call this unconditionally).

    Arguments default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK``. A world of 1 asked for still starts a group
    (one rank over NCCL on one card runs every collective of a mode). The
    backend is NCCL when ``device`` (``resolve_device``'s) is a GPU, which
    becomes ``cuda:LOCAL_RANK``, and gloo on the CPU. A failed or timed-out
    start raises.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", process_id or 0))
    if coordinator_address is None and num_processes is None:
        return False
    missing = [n for n, v in (("coordinator address (MASTER_ADDR, MASTER_PORT)",
                               coordinator_address),
                              ("process count (WORLD_SIZE)", num_processes),
                              ("process id (RANK)", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_distributed: a process group was asked for but the "
                         f"{', '.join(missing)} is not set")
    device = resolve_device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    os.environ["LOCAL_RANK"] = str(local_rank)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return True


def make_multihost_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """('data', 'model') mesh over every process, node-aware: a model group
    is ``model_parallel`` consecutive ranks, which must divide the processes
    of a node (``LOCAL_WORLD_SIZE``) so that tensor-parallel collectives stay
    on one node's links and only the data axis crosses nodes.

    One process, no group: ``make_mesh``'s world-1 mesh.
    """
    init_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if model_parallel < 1 or local % model_parallel:
        raise ValueError(
            f"make_multihost_mesh: model_parallel={model_parallel} must divide the {local} "
            f"processes of a node; a model group crossing nodes would put tensor-parallel "
            f"collectives on the network")
    return make_mesh(model_parallel=model_parallel, device=device)


def process_batch_slice(global_batch_size: int, mesh: Optional[Mesh] = None) -> slice:
    """The rows of the global batch THIS process supplies: ``[p * B / P,
    (p + 1) * B / P)`` for its data index p of P (its rank of the world
    without a mesh)."""
    if mesh is not None:
        return _rows(global_batch_size, mesh)
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by process count {n}")
    per = global_batch_size // n
    return slice(p * per, (p + 1) * per)


def global_batch(local_tree, mesh: Mesh, global_batch_size: Optional[int] = None):
    """This process's rows (``process_batch_slice``) as the mesh's batch: each
    leaf on this process's device. The steps take each process's rows and
    reduce over the data axis, so the global batch is never assembled in one
    place; ``global_batch_size`` checks each leaf's row count."""
    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if global_batch_size is not None:
            expect = global_batch_size // mesh.shape[DATA_AXIS]
            if x.shape[0] != expect:
                raise ValueError(
                    f"global_batch: leaf has {x.shape[0]} local rows, expected {expect} "
                    f"(global {global_batch_size} over {mesh.shape[DATA_AXIS]} processes)")
        return x.to(mesh.device)

    return _tree_map(put, local_tree)


def replicate_multihost(tree, mesh: Mesh):
    """The same values on every process, broadcast from rank 0
    (``mesh.replicate``)."""
    return replicate(tree, mesh)
