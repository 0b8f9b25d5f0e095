"""Shared runner of the port's single-model variant-gate CLIs: the counterpart
of ``experiments/_single_model.py``.

Per seed, one model trains with the cosine schedule (no warmup) and a
periodic val eval; the final CSV is ``seed,acc``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..parallel import make_mesh
from . import common as C


def run_single_model_seeds(args, dataset: str, model_factory, csv_name: str,
                           extra_header=None, extra_row=None):
    """Train one model per seed; save the ``seed,acc`` CSV; return the accs.

    ``model_factory(device, generator)`` builds the model on ``device``,
    initialised from ``generator``."""
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    device = mesh.device
    print(f"Device: {C.get_device_str(device)}")
    train_iter_f, val_batches, _, mean, std, _ = C.get_loaders(
        dataset, args.batch, tiny=args.tiny, val_frac=0.0,
        synthetic=bool(getattr(args, "synthetic", False)),
        download=bool(getattr(args, "download", False)),
    )

    accs = []
    for s in args.seeds:
        print(f"\nSeed {s}")
        C.set_seed(s)
        run = C.ModelRun(
            "m", model_factory(device, torch.Generator().manual_seed(s)), args.lr, mean, std,
            args.steps, 0.0, args.weight_decay, seed=s, device=device, mesh=mesh,
        )
        print(f"Params: {run.n_params:,}")
        C.lockstep_train({"m": run}, train_iter_f(s), val_batches, args.steps,
                         args.eval_every, mesh=mesh)
        final_acc = run.evaluate(val_batches())
        accs.append(final_acc)
        print(f"seed {s}: acc={final_acc:.4f}")

    csv_path = os.path.join(args.out, csv_name)
    header = ["seed", "acc"] + (extra_header or [])
    rows = []
    for i, s in enumerate(args.seeds):
        row = [s, f"{accs[i]:.4f}"] + (extra_row or [])
        rows.append(row)
    C.save_csv(csv_path, header, rows)
    print(f"\nFinal: {float(np.mean(accs)):.4f} ± {float(np.std(accs)):.4f}")
    print(f"Results saved to: {csv_path}")
    return accs


def base_argparser(steps_default: int, eval_default: int, out_default: str,
                   depth_default: int) -> argparse.ArgumentParser:
    """The JAX CLIs' common flags and defaults, plus ``--device`` (the GPU
    unless given; ``--device cpu`` runs on the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=steps_default)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=eval_default)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=depth_default)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--drop_path", type=float, default=0.1)
    ap.add_argument("--out", type=str, default=out_default)
    ap.add_argument("--synthetic", action="store_true",
                    help="use deterministic synthetic data (zero-egress envs)")
    ap.add_argument("--download", action="store_true",
                    help="opt-in CIFAR download when absent (egress hosts)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap
