#!/usr/bin/env python
"""CIFAR-10 MoP sweep over views x kernels, on the port.

The counterpart of ``experiments/cifar10_mop_sweep.py``, with its flags,
defaults and output: ``ViT_MoP`` at 256 / 6 / 4 for every (``--views``,
``--kernels``) pair and seed; CSV ``cifar10_mop_sweep.csv`` with
``seed,views,kernels,acc`` and the mean per pair printed. ``--device cpu``
runs on the CPU (default: the GPU).
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from ..models import ViT_MoP
from ..parallel import make_mesh
from . import common as C


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--views", type=int, nargs="+", default=[3, 5, 7])
    ap.add_argument("--kernels", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--out", type=str, default="results/cifar10_mop_sweep")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def main(argv=None):
    """Returns [(seed, views, kernels, final val accuracy)]."""
    args = build_argparser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    device = mesh.device
    print(f"Device: {C.get_device_str(device)}")
    train_iter_f, val_batches, _, mean, std, _ = C.get_loaders(
        "cifar10", args.batch, tiny=args.tiny, val_frac=0.0, synthetic=args.synthetic)

    results = []
    for seed in args.seeds:
        for n_views, n_kernels in itertools.product(args.views, args.kernels):
            cfg_name = f"seed{seed}_v{n_views}_k{n_kernels}"
            print(f"\nRunning {cfg_name}")
            C.set_seed(seed)
            run = C.ModelRun(
                "m",
                ViT_MoP(dim=256, depth=6, heads=4, n_classes=10, n_views=n_views,
                        n_kernels=n_kernels, device=device,
                        generator=torch.Generator().manual_seed(seed)),
                args.lr, mean, std, args.steps, 0.0, args.weight_decay, seed=seed,
                device=device, mesh=mesh)
            print(f"Params: {run.n_params:,}")
            C.lockstep_train({"m": run}, train_iter_f(seed), val_batches, args.steps,
                             args.eval_every, mesh=mesh)
            final_acc = run.evaluate(val_batches())
            results.append((seed, n_views, n_kernels, final_acc))
            print(f"done {cfg_name}: acc={final_acc:.4f}")

    csv_path = os.path.join(args.out, "cifar10_mop_sweep.csv")
    C.save_csv(csv_path, ["seed", "views", "kernels", "acc"],
               [[s, v, k, f"{a:.4f}"] for s, v, k, a in results])

    grouped = {}
    for s, v, k, a in results:
        grouped.setdefault((v, k), []).append(a)
    for (v, k), accs in sorted(grouped.items()):
        print(f"views={v:2d} kernels={k:2d} | acc={float(np.mean(accs)):.4f} "
              f"± {float(np.std(accs)):.4f} (n={len(accs)})")
    print(f"Results saved to: {csv_path}")
    return results


if __name__ == "__main__":
    main()
