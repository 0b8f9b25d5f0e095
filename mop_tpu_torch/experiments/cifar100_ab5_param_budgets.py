#!/usr/bin/env python
"""A/B/C/D/E on CIFAR-100 at fixed parameter budgets, on the port.

The counterpart of ``experiments/cifar100_ab5_param_budgets.py``, with its
flags, defaults and output contract: A=Baseline, B=MoP, C=CrossView,
D=MultiHop, E=Edgewise (the views -> mlp_ratio -> use_k3 budget-fit ladder,
the per-model LR rules, ``--ew_variants`` spawning ``E_{mode}_{init}``), and
``{prefix}_target_{N}.csv``, ``_test.csv``, ``_val_summary.csv``,
``_summary.json`` and, with ``--plot``, ``_val_curve.png`` and
``_test_bar.png`` under ``--out``. Every model trains in lockstep on the
same batches.

``--device`` picks the torch device (the GPU unless given):

    python -m mop_tpu_torch.experiments.cifar100_ab5_param_budgets \\
        --device cpu --synthetic --tiny --steps 3 --batch 16 --targets 200000
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import ViT_Baseline, ViT_MoP, ViTCrossView, ViTEdgewise, ViTMultiHop
from ..parallel import make_mesh
from . import common as C


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=(
            "A/B/C/D/E on CIFAR-100 at fixed parameter budgets: "
            "A=Baseline, B=MoP, C=CrossView, D=MultiHop, E=Edgewise"
        )
    )
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lr_large", type=float, default=1e-3)
    ap.add_argument("--large_threshold", type=int, default=50_000_000)
    ap.add_argument("--warmup_frac", type=float, default=0.1)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--lr_e", type=float, default=None,
                    help="Absolute LR override for Edgewise (E).")
    ap.add_argument("--lr_mult_e", type=float, default=1.0,
                    help="Multiplier on base LR for Edgewise (E) when --lr_e unset.")
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--val_frac", type=float, default=0.1)
    ap.add_argument("--val_seed", type=int, default=0)
    ap.add_argument("--targets", type=int, nargs="+", default=[5_000_000, 50_000_000])
    ap.add_argument("--models", type=str, nargs="+",
                    choices=["A", "B", "C", "D", "E"],
                    default=["A", "B", "C", "D", "E"])
    # MoP
    ap.add_argument("--mop_views", type=int, default=5)
    ap.add_argument("--mop_kernels", type=int, default=3)
    # CrossView
    ap.add_argument("--xview_transpose", action="store_true")
    ap.add_argument("--xview_t1", type=float, default=0.0)
    ap.add_argument("--xview_t2", type=float, default=0.0)
    ap.add_argument("--xview_enable_prior", action="store_true")
    ap.add_argument("--xview_prior_weight", type=float, default=0.5)
    ap.add_argument("--xview_anchor_mode", type=str,
                    choices=["argmax_row_sum", "fixed", "none"],
                    default="argmax_row_sum")
    ap.add_argument("--xview_k_star", type=int, default=0)
    # MultiHop
    ap.add_argument("--mh_hops", type=int, default=3)
    ap.add_argument("--mh_beta_not", type=float, default=0.5)
    ap.add_argument("--mh_gate_chain", type=float, default=1.0)
    # Edgewise
    ap.add_argument("--ew_beta_not", type=float, default=0.5)
    ap.add_argument("--ew_use_k3", action="store_true")
    ap.add_argument("--ew_views", type=int, default=5)
    ap.add_argument("--ew_mlp_ratio", type=float, default=4.0)
    ap.add_argument("--ew_share_qkv", action="store_true")
    ap.add_argument("--ew_gate_mode", type=str, default="lowrank",
                    choices=["dense", "lowrank"])
    ap.add_argument("--ew_gate_rank", type=int, default=4)
    ap.add_argument("--ew_gate_init", type=str, default="neutral",
                    choices=["neutral", "and", "or", "not", "nor", "xor", "chain"])
    ap.add_argument("--ew_use_lens_bank_qk", action="store_true")
    ap.add_argument("--ew_lens_qk_dilations", type=int, nargs="+", default=None)
    ap.add_argument("--ew_lens_qk_causal", action="store_true")
    # S-channel lens bank (depthwise conv over the stacked score maps per dilation).
    ap.add_argument("--ew_use_lens_bank", action="store_true")
    ap.add_argument("--ew_lens_kernel_size", type=int, default=3)
    ap.add_argument("--ew_lens_dilations", type=int, nargs="+", default=None)
    ap.add_argument("--ew_variants", type=str, nargs="+", default=None,
                    help="Run multiple Edgewise variants; items like 'dense:and'")
    ap.add_argument("--debug_budget", action="store_true")
    ap.add_argument("--out", type=str, default="results/cifar100_ab5_param_budgets")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--download", action="store_true",
                    help="opt-in CIFAR download when absent (egress hosts)")
    ap.add_argument("--synthetic", action="store_true",
                    help="use deterministic synthetic data (zero-egress envs)")
    ap.add_argument("--ckpt_every", type=int, default=0,
                    help="save per-model checkpoints every N steps (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoints under --out")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def fit_edgewise(args, target, base_cfg, base_p):
    """Budget-fit fallback ladder: views -> mlp_ratio -> use_k3."""
    try_views = list(range(int(args.ew_views), 1, -1))
    mlp_order = [args.ew_mlp_ratio, 4.0, 3.0, 2.0, 1.5, 1.0]
    seen, mlp_try = set(), []
    for r in mlp_order:
        if r > 0 and r not in seen:
            mlp_try.append(r)
            seen.add(r)
    use_k3_try = [bool(args.ew_use_k3), False] if args.ew_use_k3 else [False, True]
    if args.debug_budget:
        print(f"[DEBUG] E search: views={try_views}, mlp_ratios={mlp_try}, "
              f"use_k3 order={use_k3_try}, share_qkv={args.ew_share_qkv}")
    for v in try_views:
        for r in mlp_try:
            for k3 in use_k3_try:
                try:
                    xkwargs = {
                        "beta_not": args.ew_beta_not,
                        "use_k3": bool(k3),
                        "n_views": int(v),
                        "share_qkv": args.ew_share_qkv,
                        "mlp_ratio": float(r),
                        "gate_mode": args.ew_gate_mode,
                        "gate_rank": int(args.ew_gate_rank),
                        "gate_init": str(args.ew_gate_init),
                        "use_lens_bank_qk": bool(args.ew_use_lens_bank_qk),
                        "lens_qk_dilations": tuple(args.ew_lens_qk_dilations)
                        if args.ew_lens_qk_dilations is not None else None,
                        "lens_qk_causal": bool(args.ew_lens_qk_causal),
                        "use_lens_bank": bool(args.ew_use_lens_bank),
                        "lens_kernel_size": int(args.ew_lens_kernel_size),
                        "lens_dilations": tuple(args.ew_lens_dilations)
                        if args.ew_lens_dilations is not None else None,
                    }
                    cfg, p, within = C.find_model_config_match_baseline(
                        ViTEdgewise, n_classes=100, target_params=int(target),
                        baseline_cfg=base_cfg, baseline_params=base_p,
                        max_ratio_diff=0.01,
                        dims_choices=(64, 96, 112, 128, 160, 192, 224, 256,
                                      320, 384, 448, 512, 640, 768),
                        depths_choices=(3, 4, 5, 6, 7, 8, 9, 10, 12),
                        heads_choices=(4, 6, 8),
                        extra_kwargs=xkwargs,
                    )
                    cfg["_ew_views"] = int(v)
                    cfg["_ew_mlp_ratio"] = float(r)
                    cfg["_ew_use_k3"] = bool(k3)
                    if args.debug_budget:
                        print(f"[DEBUG] E fit: views={v}, mlp_ratio={r}, use_k3={k3} "
                              f"-> cfg={cfg}, params={p:,}, within1%={within}")
                    return cfg, p
                except Exception as e:
                    if args.debug_budget:
                        print(f"[DEBUG] E try failed: views={v}, mlp_ratio={r}, "
                              f"use_k3={k3} err={e}")
                    continue
    raise RuntimeError(
        "Edgewise (E) could not fit under baseline budget. "
        "Try reducing --ew_views or target params."
    )


def match_configs(args, target) -> Dict[str, Tuple[Dict[str, int], int]]:
    """The budget-matched config and parameter count of A and of each of B,
    C, D, E in ``args.models`` at ``target``."""
    base_cfg, base_p = C.find_config_for_target(
        ViT_Baseline, n_classes=100, target_params=int(target)
    )
    cfgs: Dict[str, Tuple[Dict[str, int], int]] = {"A": (base_cfg, base_p)}
    if "B" in args.models:
        cfgs["B"] = C.find_model_config_match_baseline(
            ViT_MoP, n_classes=100, target_params=int(target),
            baseline_cfg=base_cfg, baseline_params=base_p, max_ratio_diff=0.01,
            extra_kwargs={"n_views": args.mop_views, "n_kernels": args.mop_kernels},
        )[:2]
    if "C" in args.models:
        cfgs["C"] = C.find_model_config_match_baseline(
            ViTCrossView, n_classes=100, target_params=int(target),
            baseline_cfg=base_cfg, baseline_params=base_p, max_ratio_diff=0.01,
            extra_kwargs=xview_extra(args),
        )[:2]
    if "D" in args.models:
        cfgs["D"] = C.find_model_config_match_baseline(
            ViTMultiHop, n_classes=100, target_params=int(target),
            baseline_cfg=base_cfg, baseline_params=base_p, max_ratio_diff=0.01,
            extra_kwargs=mh_extra(args),
        )[:2]
    if "E" in args.models:
        cfgs["E"] = fit_edgewise(args, target, base_cfg, base_p)
    return cfgs


def xview_extra(args):
    return dict(
        use_transpose_cues=args.xview_transpose,
        t1=args.xview_t1, t2=args.xview_t2,
        enable_per_key_prior=args.xview_enable_prior,
        prior_weight=args.xview_prior_weight,
        anchor_mode=args.xview_anchor_mode,
        fixed_k_star=args.xview_k_star,
    )


def mh_extra(args):
    return dict(
        gates=dict(base=1.0, and_=1.0, or_=0.0, not_=0.0,
                   chain=args.mh_gate_chain),
        beta_not=args.mh_beta_not, hops=args.mh_hops,
    )


def model_keys_for(args) -> Tuple[List[str], Optional[List[Tuple[str, str]]]]:
    """The run keys (A, then B/C/D as asked, then E or one ``E_{mode}_{init}``
    a ``--ew_variants`` item) and the E variants' (mode, init) pairs."""
    model_keys: List[str] = ["A"]
    for k in ("B", "C", "D"):
        if k in args.models:
            model_keys.append(k)
    e_variant_specs: Optional[List[Tuple[str, str]]] = None
    if "E" in args.models:
        if args.ew_variants:
            e_variant_specs = []
            for spec in args.ew_variants:
                if ":" not in spec:
                    raise SystemExit(
                        f"Invalid --ew_variants item '{spec}'. Use 'mode:init'"
                    )
                mode, init = spec.split(":", 1)
                model_keys.append(f"E_{mode}_{init}")
                e_variant_specs.append((mode, init))
        else:
            model_keys.append("E")
    return model_keys, e_variant_specs


def make_model(args, cfgs, key, device, generator):
    """The model of run ``key`` on ``device``, initialised from ``generator``."""
    kw = dict(n_classes=100, device=device, generator=generator)
    if key == "A":
        return ViT_Baseline(**cfgs["A"][0], **kw)
    if key == "B":
        return ViT_MoP(**cfgs["B"][0], n_views=args.mop_views, n_kernels=args.mop_kernels,
                       **kw)
    if key == "C":
        return ViTCrossView(**cfgs["C"][0], **xview_extra(args), **kw)
    if key == "D":
        return ViTMultiHop(**cfgs["D"][0], **mh_extra(args), **kw)
    # E / E_{mode}_{init}
    cfg_e = cfgs["E"][0]
    base_kwargs = {k: v for k, v in cfg_e.items() if not k.startswith("_")}
    mode, init = args.ew_gate_mode, args.ew_gate_init
    if key.startswith("E_"):
        _, mode, init = key.split("_", 2)
    return ViTEdgewise(
        **base_kwargs, **kw,
        beta_not=args.ew_beta_not,
        use_k3=bool(cfg_e.get("_ew_use_k3", args.ew_use_k3)),
        n_views=int(cfg_e.get("_ew_views", args.ew_views)),
        share_qkv=args.ew_share_qkv,
        mlp_ratio=float(cfg_e.get("_ew_mlp_ratio", args.ew_mlp_ratio)),
        gate_mode=str(mode), gate_rank=int(args.ew_gate_rank),
        gate_init=str(init),
        use_lens_bank_qk=bool(args.ew_use_lens_bank_qk),
        lens_qk_dilations=tuple(args.ew_lens_qk_dilations)
        if args.ew_lens_qk_dilations is not None else None,
        lens_qk_causal=bool(args.ew_lens_qk_causal),
        use_lens_bank=bool(args.ew_use_lens_bank),
        lens_kernel_size=int(args.ew_lens_kernel_size),
        lens_dilations=tuple(args.ew_lens_dilations)
        if args.ew_lens_dilations is not None else None,
    )


def run(args, csv_prefix: str = "cifar100_ab5") -> Dict[int, Dict]:
    """Run every target and write its files. Returns, by target, the matched
    ``configs`` ({key: (cfg, params)}), each run's ``params``, the last
    seed's ``hist`` (val acc and loss at each eval step) and ``test_acc``."""
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    device = mesh.device
    print(f"Device: {C.get_device_str(device)}")

    train_iter_f, val_batches, test_batches, mean, std, _ = C.get_loaders(
        "cifar100", args.batch, tiny=args.tiny,
        val_frac=float(args.val_frac), val_seed=int(args.val_seed),
        synthetic=args.synthetic, download=bool(args.download),
    )

    results: Dict[int, Dict] = {}
    for target in args.targets:
        print(f"\nTarget parameters: {int(target):,}")
        lr_current = args.lr if int(target) < int(args.large_threshold) else args.lr_large
        print(f"Using learning rate: {lr_current} (warmup_frac={args.warmup_frac})")

        cfgs = match_configs(args, target)
        print(f"Baseline cfg: {cfgs['A'][0]} | params={cfgs['A'][1]:,}")
        for k in ("B", "C", "D", "E"):
            if k in cfgs:
                print(f"{k} cfg: {cfgs[k][0]} | params={cfgs[k][1]:,}")

        model_keys, _ = model_keys_for(args)
        accs: Dict[str, List[float]] = {k: [] for k in model_keys}
        last_seed_hist = {k: {"steps": [], "acc": [], "loss": []} for k in model_keys}
        runs = None

        for s in args.seeds:
            print(f"\nSeed {s}")
            C.set_seed(s)
            runs = {}
            for key in model_keys:
                lr_for_model = lr_current
                if key == "E" or key.startswith("E_"):
                    if args.lr_e is not None and args.lr_e > 0:
                        lr_for_model = float(args.lr_e)
                    else:
                        lr_for_model = float(lr_current) * float(args.lr_mult_e)
                model = make_model(args, cfgs, key, device, torch.Generator().manual_seed(s))
                runs[key] = C.ModelRun(
                    key, model, lr_for_model, mean, std,
                    args.steps, args.warmup_frac, args.weight_decay, seed=s, device=device,
                    mesh=mesh,
                )
            print("Params | " + " | ".join(
                f"{k}: {r.n_params:,}" for k, r in runs.items()))

            hist = C.lockstep_train(
                runs, train_iter_f(s), val_batches, args.steps, args.eval_every,
                ckpt_dir=os.path.join(args.out, f"ckpt_t{int(target)}_s{s}"),
                ckpt_every=args.ckpt_every, resume=args.resume, mesh=mesh,
            )
            if s == args.seeds[-1]:
                last_seed_hist = hist

            for key, run_ in runs.items():
                accs[key].append(run_.evaluate(val_batches()))
            print("seed", s, " " + " ".join(
                f"{k}={accs[k][-1]:.4f}" for k in accs))

        # Test-set evaluation (last seed models)
        print("\nTest-set evaluation (last seed models):")
        test_acc_report = [(key, run_.evaluate(test_batches())) for key, run_ in runs.items()]
        print(" ".join(f"T{key}={acc:.4f}" for key, acc in test_acc_report))

        C.save_csv(
            os.path.join(args.out, f"{csv_prefix}_target_{int(target)}_test.csv"),
            ["model", "test_acc"],
            [[k, f"{a:.6f}"] for k, a in test_acc_report],
        )

        # Significance statistics vs A: McNemar counts / chi2 and a bootstrap
        # interval of the accuracy delta.
        if "A" in runs and len(runs) > 1:
            per_sample = {k: r.per_sample_correct(test_batches()) for k, r in runs.items()}
            summary = {
                "seed": int(args.seeds[-1]),
                "target": int(target),
                "params": {k: int(r.n_params) for k, r in runs.items()},
                "test_acc": {k: float(a) for k, a in test_acc_report},
                "vs_A": {},
            }
            for k in runs:
                if k == "A":
                    continue
                summary["vs_A"][k] = {
                    **C.mcnemar(per_sample["A"], per_sample[k]),
                    **C.bootstrap_delta(per_sample["A"], per_sample[k]),
                }
            spath = os.path.join(
                args.out, f"{csv_prefix}_target_{int(target)}_summary.json")
            with open(spath, "w") as f:
                json.dump(summary, f, indent=2)
            print(f"wrote {spath}")
        C.save_csv(
            os.path.join(args.out, f"{csv_prefix}_target_{int(target)}_val_summary.csv"),
            ["model", "mean_val", "std_val"],
            [[k, f"{float(np.mean(v)):.6f}", f"{float(np.std(v)):.6f}"]
             for k, v in accs.items()],
        )

        if args.plot:
            C.save_val_curve_plot(
                os.path.join(args.out, f"{csv_prefix}_target_{int(target)}_val_curve.png"),
                last_seed_hist,
                f"CIFAR-100 A/B/C/D/E @ {int(target):,} params (last seed)",
            )
            C.save_test_bar_plot(
                os.path.join(args.out, f"{csv_prefix}_target_{int(target)}_test_bar.png"),
                [k for k, _ in test_acc_report], [v for _, v in test_acc_report],
                f"CIFAR-100 Test Acc @ {int(target):,} params (last seed)",
            )

        C.save_csv(
            os.path.join(args.out, f"{csv_prefix}_target_{int(target)}.csv"),
            ["seed"] + [f"acc_{k}" for k in accs],
            [[s] + [f"{accs[k][i]:.4f}" for k in accs]
             for i, s in enumerate(args.seeds)],
        )
        print("\n" + " ".join(
            f"{k}={float(np.mean(v)):.4f}±{float(np.std(v)):.4f}"
            for k, v in accs.items()))
        print(f"Results saved to: {args.out}")
        results[int(target)] = {
            "configs": cfgs, "params": {k: r.n_params for k, r in runs.items()},
            "hist": last_seed_hist, "test_acc": dict(test_acc_report),
        }
    return results


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
