#!/usr/bin/env python
"""CIFAR-10 two-hop parameter-budget experiment, on the port.

The counterpart of ``experiments/cifar10_twohop_param_budgets.py``, with its
flags, defaults and output: ``ViTGated`` (its gates from the CLI)
grid-matched to each ``--targets`` budget, one run per seed; CSV
``cifar10_twohop_target_{N}.csv`` with ``seed,acc``. The model trains
through the composed path and evaluates through the multi-hop kernel at two
hops. ``--device cpu`` runs on the CPU (default: the GPU).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import ViTGated
from ..parallel import make_mesh
from . import common as C


def build_argparser(steps: int = 1000, eval_every: int = 200,
                    out: str = "results/cifar10_twohop_param_budgets"
                    ) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=eval_every)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--targets", type=int, nargs="+", default=[5_000_000, 50_000_000])
    ap.add_argument("--gate_base", type=float, default=1.0)
    ap.add_argument("--gate_and", type=float, default=1.0)
    ap.add_argument("--gate_or", type=float, default=0.0)
    ap.add_argument("--gate_not", type=float, default=0.0)
    ap.add_argument("--gate_chain", type=float, default=0.0)
    ap.add_argument("--beta_not", type=float, default=0.5)
    ap.add_argument("--out", type=str, default=out)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def gated_extra(args):
    gates = dict(base=args.gate_base, and_=args.gate_and, or_=args.gate_or,
                 not_=args.gate_not, chain=args.gate_chain)
    return dict(gates=gates, beta_not=args.beta_not)


def match_config(args, n_classes: int, target: int):
    """``ViTGated``'s (config, params) nearest to ``target``."""
    return C.find_config_for_target(ViTGated, n_classes=n_classes, target_params=int(target),
                                    extra_kwargs=gated_extra(args))


def run(args, dataset: str, n_classes: int):
    """Every target: the matched config, one run per seed, the CSV.
    Returns {target: {"config", "params", "accs"}}."""
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    device = mesh.device
    print(f"Device: {C.get_device_str(device)}")
    train_iter_f, val_batches, _, mean, std, _ = C.get_loaders(
        dataset, args.batch, tiny=args.tiny, val_frac=0.0, synthetic=args.synthetic)

    results = {}
    for target in args.targets:
        print(f"\nTarget parameters: {int(target):,}")
        cfg, p = match_config(args, n_classes, target)
        print(f"Config: {cfg} | params={p:,}")

        accs = []
        for s in args.seeds:
            print(f"\nSeed {s}")
            C.set_seed(s)
            run_ = C.ModelRun(
                "m", ViTGated(n_classes=n_classes, **cfg, **gated_extra(args), device=device,
                              generator=torch.Generator().manual_seed(s)),
                args.lr, mean, std, args.steps, 0.0, args.weight_decay, seed=s, device=device,
                mesh=mesh)
            print(f"Params: {run_.n_params:,}")
            C.lockstep_train({"m": run_}, train_iter_f(s), val_batches, args.steps,
                             args.eval_every, mesh=mesh)
            a = run_.evaluate(val_batches())
            accs.append(a)
            print(f"seed {s}: acc={a:.4f}")

        csv_path = os.path.join(args.out, f"{dataset}_twohop_target_{int(target)}.csv")
        C.save_csv(csv_path, ["seed", "acc"],
                   [[s, f"{accs[i]:.4f}"] for i, s in enumerate(args.seeds)])
        print(f"\nFinal: {float(np.mean(accs)):.4f} ± {float(np.std(accs)):.4f}")
        print(f"Results saved to: {csv_path}")
        results[int(target)] = {"config": cfg, "params": p, "accs": accs}
    return results


def main(argv=None):
    return run(build_argparser().parse_args(argv), "cifar10", 10)


if __name__ == "__main__":
    main()
