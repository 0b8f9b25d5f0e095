#!/usr/bin/env python
"""CIFAR-10 multi-seed A-vs-B experiment, on the port.

The counterpart of ``experiments/cifar10_multi_seed.py``, with its flags,
defaults and output: ``ViT_Baseline`` and ``ViT_MoP`` (5 views, 3 kernels)
at a fixed 256 / 6 / 4, trained in lockstep per seed on the same batches;
CSV ``cifar10_acc.csv`` with ``seed,baseline,mop,diff`` and, for the last
seed, ``summary.json`` with McNemar's test and a bootstrap interval of the
accuracy delta. ``--device cpu`` runs on the CPU (default: the GPU).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..models import ViT_Baseline, ViT_MoP
from ..parallel import make_mesh
from . import common as C


def build_argparser(steps: int = 1000, eval_every: int = 200,
                    out: str = "results/cifar10") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=eval_every)
    ap.add_argument("--tiny", action="store_true",
                    help="use small subset for a quick smoke run")
    ap.add_argument("--out", type=str, default=out)
    ap.add_argument("--synthetic", action="store_true",
                    help="use deterministic synthetic data (zero-egress envs)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def run(args, dataset: str, n_classes: int, depth: int, csv_name: str):
    """Train A and B at ``dim 256 / depth / 4 heads`` per seed; write the
    CSV and the last seed's ``summary.json``. Returns (A's, B's) final val
    accuracies per seed."""
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    device = mesh.device
    print(f"Device: {C.get_device_str(device)}")
    train_iter_f, val_batches, _, mean, std, _ = C.get_loaders(
        dataset, args.batch, tiny=args.tiny, val_frac=0.0, synthetic=args.synthetic)

    accs_base, accs_mop = [], []
    for s in args.seeds:
        print(f"\nRunning experiment with seed {s}")
        C.set_seed(s)
        kw = dict(dim=256, depth=depth, heads=4, n_classes=n_classes, device=device)
        runs = {
            "b": C.ModelRun("b", ViT_Baseline(**kw, generator=torch.Generator().manual_seed(s)),
                            args.lr, mean, std, args.steps, 0.0, args.weight_decay, seed=s,
                            device=device, mesh=mesh),
            "m": C.ModelRun("m", ViT_MoP(**kw, n_views=5, n_kernels=3,
                                         generator=torch.Generator().manual_seed(s)),
                            args.lr, mean, std, args.steps, 0.0, args.weight_decay, seed=s,
                            device=device, mesh=mesh),
        }
        print(f"Baseline params: {runs['b'].n_params:,}")
        print(f"MoP params: {runs['m'].n_params:,}")
        print(f"Param ratio: {runs['m'].n_params / runs['b'].n_params:.3f}")

        C.lockstep_train(runs, train_iter_f(s), val_batches, args.steps, args.eval_every,
                         mesh=mesh)

        a_b = runs["b"].evaluate(val_batches())
        a_m = runs["m"].evaluate(val_batches())
        accs_base.append(a_b)
        accs_mop.append(a_m)
        print(f"seed {s}: baseline={a_b:.4f}  mop={a_m:.4f}  diff={a_m - a_b:+.4f}")
        if s == args.seeds[-1]:
            ca = runs["b"].per_sample_correct(val_batches())
            cb = runs["m"].per_sample_correct(val_batches())
            summary = {
                "seed": s,
                "params_base": runs["b"].n_params,
                "params_mop": runs["m"].n_params,
                "test_acc_A": float(ca.mean()),
                "test_acc_B": float(cb.mean()),
                **C.mcnemar(ca, cb),
                **C.bootstrap_delta(ca, cb),
            }
            with open(os.path.join(args.out, "summary.json"), "w") as f:
                json.dump(summary, f, indent=2)

    csv_path = os.path.join(args.out, csv_name)
    C.save_csv(csv_path, ["seed", "baseline", "mop", "diff"],
               [[args.seeds[i], f"{b:.4f}", f"{m:.4f}", f"{m - b:.4f}"]
                for i, (b, m) in enumerate(zip(accs_base, accs_mop))])

    mean_base, mean_mop = np.mean(accs_base), np.mean(accs_mop)
    print(f"\nFinal Results (across {len(args.seeds)} seeds):")
    print(f"Baseline: {mean_base:.4f} ± {np.std(accs_base):.4f}")
    print(f"MoP:      {mean_mop:.4f} ± {np.std(accs_mop):.4f}")
    print(f"Diff:     {mean_mop - mean_base:+.4f}")
    print(f"Results saved to: {csv_path}")
    print("MoP shows improvement!" if mean_mop - mean_base > 0 else "MoP shows no improvement")
    return accs_base, accs_mop


def main(argv=None):
    return run(build_argparser().parse_args(argv), "cifar10", 10, 6, "cifar10_acc.csv")


if __name__ == "__main__":
    main()
