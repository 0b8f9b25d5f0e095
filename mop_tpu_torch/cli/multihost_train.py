#!/usr/bin/env python
"""Data-parallel training worker: one process per device.

Each process makes the whole global batch from the same seed, keeps its own
rows (``process_batch_slice``) and runs the data-parallel train step; the
gradients are all-reduced over the group (NCCL on GPUs, gloo on the CPU).
Any number of processes trains the same trajectory as one, up to the
reduction order.

One process (no launcher): ``python -m mop_tpu_torch.cli.multihost_train
--steps 3 --device cpu``. Two, on the CPU::

    python -m mop_tpu_torch.cli.launch_multihost --nproc 2 -- \\
        python -m mop_tpu_torch.cli.multihost_train --steps 3 --device cpu

On GPUs drop ``--device cpu``: process i drives ``cuda:i``. The last line
of standard output is the JSON record ``{process, n_processes, loss, acc,
param_l2}``, the same on every process (replicated state).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import ViT_MoP
from ..ops.preprocess import CIFAR100_MEAN, CIFAR100_STD
from ..parallel import global_batch, make_classifier_train_step, make_multihost_mesh
from ..parallel.multihost import process_batch_slice
from ..parallel.mesh import replicate


def run_worker(steps: int = 3, global_batch_size: int = 16, dim: int = 32, depth: int = 1,
               heads: int = 2, lr: float = 1e-3, device=None, seed: int = 0) -> dict:
    """Train a small ViT-MoP for ``steps`` fp32 steps on seeded synthetic
    data over every process of the group (one process: no group), and
    return the record."""
    mesh = make_multihost_mesh(device=device)
    model = ViT_MoP(dim=dim, depth=depth, heads=heads, n_classes=10, n_views=2, n_kernels=2,
                    device="cpu", generator=torch.Generator().manual_seed(seed))
    replicate(model, mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=lr)
    step = make_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD, augment=False,
                                      compute_dtype=None, mesh=mesh)
    rs = np.random.RandomState(seed)
    rows = process_batch_slice(global_batch_size, mesh)
    m = {}
    for _ in range(steps):
        x = rs.randint(0, 256, (global_batch_size, 3, 32, 32), dtype=np.uint8)
        y = rs.randint(0, 10, (global_batch_size,)).astype(np.int64)
        xg, yg = global_batch((x[rows], y[rows]), mesh, global_batch_size)
        m = step(xg, yg)
    with torch.no_grad():
        l2 = torch.sqrt(sum(p.double().pow(2).sum() for p in model.parameters()))
    return {"process": mesh.rank, "n_processes": mesh.size, "loss": float(m["loss"]),
            "acc": float(m["acc"]), "param_l2": float(l2)}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (gloo)")
    return ap


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    out = run_worker(steps=args.steps, global_batch_size=args.global_batch, dim=args.dim,
                     depth=args.depth, heads=args.heads, device=args.device)
    print(json.dumps(out), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
