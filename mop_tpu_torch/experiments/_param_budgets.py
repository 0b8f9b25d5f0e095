"""Shared parts of the port's A/B, A/B/C and A/B/C/D parameter-budget CLIs
(the counterparts of ``experiments/cifar10_ab_param_budgets.py``,
``cifar{10,100}_ab3_param_budgets.py`` and ``cifar100_ab4_param_budgets.py``):
their flags, the families' extra arguments, the matcher over A's budget and
the per-seed lockstep training.

The families: ``base`` (A, ``ViT_Baseline``), ``mop`` (B, ``ViT_MoP``),
``xview`` (C, ``ViTCrossView``) and ``multihop`` (D, ``ViTMultiHop``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import ViT_Baseline, ViT_MoP, ViTCrossView, ViTMultiHop
from ..parallel import make_mesh
from . import common as C

CLASSES = {"base": ViT_Baseline, "mop": ViT_MoP, "xview": ViTCrossView,
           "multihop": ViTMultiHop}


def argparser(steps: int, eval_every: int, schedule: bool = True) -> argparse.ArgumentParser:
    """The flags every budget CLI shares, with its defaults; ``schedule``
    adds the A/B/C and A/B/C/D CLIs' LR rule and warmup."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    if schedule:
        ap.add_argument("--lr_large", type=float, default=1e-3)
        ap.add_argument("--large_threshold", type=int, default=50_000_000)
        ap.add_argument("--warmup_frac", type=float, default=0.1)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=eval_every)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--targets", type=int, nargs="+", default=[5_000_000, 50_000_000])
    ap.add_argument("--mop_views", type=int, default=5)
    ap.add_argument("--mop_kernels", type=int, default=3)
    return ap


def add_xview_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--xview_transpose", action="store_true")
    ap.add_argument("--xview_t1", type=float, default=0.0)
    ap.add_argument("--xview_t2", type=float, default=0.0)
    ap.add_argument("--xview_enable_prior", action="store_true")
    ap.add_argument("--xview_prior_weight", type=float, default=0.5)
    ap.add_argument("--xview_anchor_mode", type=str,
                    choices=["argmax_row_sum", "fixed", "none"],
                    default="argmax_row_sum")
    ap.add_argument("--xview_k_star", type=int, default=0)
    return ap


def add_multihop_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--mh_hops", type=int, default=3)
    ap.add_argument("--mh_beta_not", type=float, default=0.5)
    ap.add_argument("--mh_gate_base", type=float, default=1.0)
    ap.add_argument("--mh_gate_and", type=float, default=1.0)
    ap.add_argument("--mh_gate_or", type=float, default=0.0)
    ap.add_argument("--mh_gate_not", type=float, default=0.0)
    ap.add_argument("--mh_gate_chain", type=float, default=1.0)
    return ap


def add_output_flags(ap: argparse.ArgumentParser, out: str) -> argparse.ArgumentParser:
    ap.add_argument("--out", type=str, default=out)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def xview_extra(args) -> Dict:
    return dict(
        use_transpose_cues=args.xview_transpose, t1=args.xview_t1, t2=args.xview_t2,
        enable_per_key_prior=args.xview_enable_prior,
        prior_weight=args.xview_prior_weight,
        anchor_mode=args.xview_anchor_mode, fixed_k_star=args.xview_k_star,
    )


def multihop_extra(args) -> Dict:
    return dict(
        gates=dict(base=args.mh_gate_base, and_=args.mh_gate_and,
                   or_=args.mh_gate_or, not_=args.mh_gate_not,
                   chain=args.mh_gate_chain),
        beta_not=args.mh_beta_not, hops=args.mh_hops,
    )


def extra_kwargs(args, family: str) -> Dict:
    """The constructor arguments of ``family`` beyond dim / depth / heads."""
    if family == "mop":
        return {"n_views": args.mop_views, "n_kernels": args.mop_kernels}
    if family == "xview":
        return xview_extra(args)
    if family == "multihop":
        return multihop_extra(args)
    return {}


def match_configs(args, n_classes: int, target: int, families: List[str]
                  ) -> Dict[str, Tuple[Dict[str, int], int, bool]]:
    """A grid-matched to ``target``, then each other family matched under
    A's budget: {family: (cfg, params, within 1% of A)}, A's flag True."""
    base_cfg, base_p = C.find_config_for_target(
        ViT_Baseline, n_classes=n_classes, target_params=int(target))
    cfgs = {"base": (base_cfg, base_p, True)}
    for family in families:
        if family == "base":
            continue
        cfgs[family] = C.find_model_config_match_baseline(
            CLASSES[family], n_classes=n_classes, target_params=int(target),
            baseline_cfg=base_cfg, baseline_params=base_p, max_ratio_diff=0.01,
            extra_kwargs=extra_kwargs(args, family))
    return cfgs


def start(args, dataset: str):
    """The output directory, the mesh over the device (printed) and the
    loaders."""
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    print(f"Device: {C.get_device_str(mesh.device)}")
    loaders = C.get_loaders(dataset, args.batch, tiny=args.tiny, val_frac=0.0,
                            synthetic=args.synthetic)
    return mesh, loaders


def _report(seed: int, accs: Dict[str, float]) -> None:
    print("seed", seed, " ".join(f"{k}={a:.4f}" for k, a in accs.items()))


def train_seeds(args, mesh, loaders, n_classes: int, runs_spec: Dict[str, str],
                cfgs, lr: float, warmup_frac: float, report=_report) -> Dict[str, List[float]]:
    """Per seed, one run per key of ``runs_spec`` (key -> family) in lockstep
    on the same batches, each model initialised from the seed, then
    ``report(seed, {key: final val accuracy})``; returns each key's final
    val accuracy per seed."""
    train_iter_f, val_batches, _, mean, std, _ = loaders
    device = mesh.device
    accs: Dict[str, List[float]] = {k: [] for k in runs_spec}
    for s in args.seeds:
        print(f"\nSeed {s}")
        C.set_seed(s)
        runs = {}
        for key, family in runs_spec.items():
            model = CLASSES[family](n_classes=n_classes, **cfgs[family][0],
                                    **extra_kwargs(args, family), device=device,
                                    generator=torch.Generator().manual_seed(s))
            runs[key] = C.ModelRun(key, model, lr, mean, std, args.steps, warmup_frac,
                                   args.weight_decay, seed=s, device=device, mesh=mesh)
        C.lockstep_train(runs, train_iter_f(s), val_batches, args.steps, args.eval_every,
                         mesh=mesh)
        for key, run in runs.items():
            accs[key].append(run.evaluate(val_batches()))
        report(s, {k: v[-1] for k, v in accs.items()})
    return accs


LABELS = {"base": "Baseline cfg", "mop": "MoP cfg     ", "xview": "XView cfg   ",
          "multihop": "MultiHop cfg"}


def run(args, dataset: str, n_classes: int, families: List[str], csv_prefix: str) -> Dict:
    """The A/B/C and A/B/C/D CLIs: per target, the matched configs, every
    family trained per seed (LR ``--lr``, or ``--lr_large`` from
    ``--large_threshold`` on) and ``{csv_prefix}_target_{N}.csv`` with
    ``seed``, ``acc_{family}``, ``params_{family}`` and each config (C's and
    D's extras too). Returns {target: {"configs", "accs"}}."""
    mesh, loaders = start(args, dataset)
    results = {}
    for target in args.targets:
        print(f"\nTarget parameters: {int(target):,}")
        lr = args.lr if int(target) < int(args.large_threshold) else args.lr_large
        cfgs = match_configs(args, n_classes, target, families)
        for f in families:
            print(f"{LABELS[f]}: {cfgs[f][0]} | params={cfgs[f][1]:,}")
        accs = train_seeds(args, mesh, loaders, n_classes, {f: f for f in families}, cfgs,
                           lr, args.warmup_frac)
        cfg_cols, cfg_vals = [], []
        for f in families:
            cfg_cols.append(f"{f}_cfg")
            cfg_vals.append(f'"{cfgs[f][0]}"')
            if f in ("xview", "multihop"):
                cfg_cols.append(f"{f}_extra")
                cfg_vals.append(f'"{extra_kwargs(args, f)}"')
        csv_path = os.path.join(args.out, f"{csv_prefix}_target_{int(target)}.csv")
        C.save_csv(
            csv_path,
            ["seed"] + [f"acc_{f}" for f in families] + [f"params_{f}" for f in families]
            + cfg_cols,
            [[s] + [f"{accs[f][i]:.4f}" for f in families] + [cfgs[f][1] for f in families]
             + cfg_vals for i, s in enumerate(args.seeds)],
        )
        print("\n" + " | ".join(f"{k}={float(np.mean(v)):.4f}±{float(np.std(v)):.4f}"
                                for k, v in accs.items()))
        print(f"Results saved to: {csv_path}")
        results[int(target)] = {"configs": cfgs, "accs": accs}
    return results
