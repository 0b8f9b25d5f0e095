"""Multi-seed training: S independent runs in one step — the port of
``mop_tpu/parallel/multiseed.py``.

The JAX package stacks S seeds' parameters on a leading axis and ``vmap``s
the train step over it. The port's kernels are called through ctypes and do
not vmap, so the seeds are spread over the processes instead: when S divides
the data axis each process trains S / D whole seeds, with no gradient
collective at all (seed parallelism replaces data parallelism); otherwise
every process holds every seed and loops over them, each seed's batch split
over the data axis as the data-parallel step splits it. Either way seed s
follows exactly the trajectory of a single-seed run from the same init,
generator and batches (``make_scanned_classifier_train_step``).

A "stack" here is the list of (seed index, model) this process holds, and
its optimizers one per model.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import comm
from .mesh import DATA_AXIS, Mesh, Sharding
from .train_step import make_scanned_classifier_train_step

Tensor = torch.Tensor


def seed_shardings(mesh: Mesh, n_seeds: int) -> Tuple[Sharding, Sharding, Sharding]:
    """(params / optimizer, (K, S, B, ...) batch, (S,) generators) layouts:
    the seed axis over the data axis when S divides it (and it is above 1),
    else replicated seeds with each seed's batch axis over the data axis —
    the JAX function's specs."""
    n_data = mesh.shape[DATA_AXIS]
    if n_seeds % n_data == 0 and n_data > 1:
        return (Sharding(mesh, (DATA_AXIS,)), Sharding(mesh, (None, DATA_AXIS)),
                Sharding(mesh, (DATA_AXIS,)))
    return (Sharding(mesh, ()), Sharding(mesh, (None, None, DATA_AXIS)), Sharding(mesh, ()))


def _seed_sharded(mesh: Optional[Mesh], n_seeds: int) -> bool:
    return mesh is not None and seed_shardings(mesh, n_seeds)[0].spec == (DATA_AXIS,)


def local_seeds(mesh: Optional[Mesh], n_seeds: int) -> List[int]:
    """The seed indices this process holds."""
    if not _seed_sharded(mesh, n_seeds):
        return list(range(n_seeds))
    per = n_seeds // mesh.shape[DATA_AXIS]
    i = mesh.axis_index(DATA_AXIS)
    return list(range(i * per, (i + 1) * per))


class SeedStack(list):
    """This process's ``[(seed index, model)]``, with the number of seeds and
    the mesh they are spread over."""

    def __init__(self, items, n_seeds: int, mesh: Optional[Mesh]):
        super().__init__(items)
        self.n_seeds, self.mesh = n_seeds, mesh


def multiseed_init(make_model: Callable[[int], nn.Module], seeds: Sequence[int],
                   mesh: Optional[Mesh] = None) -> SeedStack:
    """This process's ``[(seed index, make_model(seed))]``: each seed's own
    initialisation, as S separate constructions would give."""
    return SeedStack([(i, make_model(int(seeds[i]))) for i in local_seeds(mesh, len(seeds))],
                     len(seeds), mesh)


def multiseed_opt_init(make_optimizer: Callable, stack) -> List[torch.optim.Optimizer]:
    """One optimizer per model of the stack."""
    return [make_optimizer(model.parameters()) for _, model in stack]


def unstack_seed(stack: SeedStack, i: int) -> Dict[str, Tensor]:
    """Seed ``i``'s parameters (a state dict on the CPU). Where the seeds are
    spread over the processes it is broadcast from the one that holds it, so
    every process must call this."""
    local = dict(stack)
    if not _seed_sharded(stack.mesh, stack.n_seeds):
        return {k: v.detach().cpu().clone() for k, v in local[i].state_dict().items()}
    group = stack.mesh.group(DATA_AXIS)
    owner = i // (stack.n_seeds // stack.mesh.shape[DATA_AXIS])
    src = torch.distributed.get_global_rank(group, owner) if group is not None else 0
    ref = next(iter(local.values())).state_dict()
    out = {}
    for k, v in ref.items():
        t = local[i].state_dict()[k].detach().clone() if i in local else torch.empty_like(v)
        out[k] = comm.broadcast_(t, group, src).cpu()
    return out


def make_multiseed_scanned_train_step(stack, optimizers, mesh: Optional[Mesh], mean, std,
                                      n_seeds: int, unroll_steps: int, augment: bool = True,
                                      label_smoothing: float = 0.0,
                                      grad_clip: Optional[float] = None,
                                      compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                                      device=None):
    """K train steps for S seeds: ``step(x_u8 (K, S, B, C, H, W), y (K, S, B),
    generators) -> {"loss": (K, S), "acc": (K, S)}``.

    Every process passes the same whole super-batch (seed-deterministic
    data) and the seeds' generators, one per seed (those of other processes'
    seeds are not drawn from); the step takes its seeds' share — its seeds
    whole, or its rows of every seed. Per seed the step is
    ``make_scanned_classifier_train_step``'s: the same draws, augment,
    forward, backward and update. The losses and accuracies of every seed
    come back on every process (an all-reduce of each process's entries).
    """
    sharded = _seed_sharded(mesh, n_seeds)
    step_mesh = None if sharded else mesh
    steps = {i: make_scanned_classifier_train_step(
        model, opt, mean, std, unroll_steps, augment=augment, label_smoothing=label_smoothing,
        grad_clip=grad_clip, compute_dtype=compute_dtype, device=device if mesh is None
        else mesh.device, mesh=step_mesh) for (i, model), opt in zip(stack, optimizers)}
    dev = mesh.device if mesh is not None else next(stack[0][1].parameters()).device
    group = mesh.group(DATA_AXIS) if sharded else None

    def step(x_u8: Tensor, y: Tensor, generators: Sequence[torch.Generator]):
        if x_u8.shape[:2] != (unroll_steps, n_seeds):
            raise ValueError(f"expected a ({unroll_steps}, {n_seeds}, B, ...) super-batch, "
                             f"got {tuple(x_u8.shape)}")
        loss = torch.zeros(unroll_steps, n_seeds, device=dev)
        acc = torch.zeros(unroll_steps, n_seeds, device=dev)
        for i, run in steps.items():
            xi, yi = x_u8[:, i], y[:, i]
            if step_mesh is not None:  # this process's rows of the seed's batch
                b = xi.shape[1]
                per = b // mesh.shape[DATA_AXIS]
                rows = slice(mesh.axis_index(DATA_AXIS) * per,
                             (mesh.axis_index(DATA_AXIS) + 1) * per)
                xi, yi = xi[:, rows], yi[:, rows]
            m = run(xi, yi, generators[i])
            loss[:, i], acc[:, i] = m["loss"], m["acc"]
        if group is not None:  # each process filled its own seeds' columns
            both = torch.stack([loss, acc])
            comm.all_reduce_(both, group)
            loss, acc = both[0], both[1]
        return {"loss": loss, "acc": acc}

    return step
