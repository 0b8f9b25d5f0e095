#!/usr/bin/env python
"""A/B/C/D/E tournament on CIFAR-100, on the port.

The counterpart of ``experiments/ab5_tournament.py``: the ab5 harness
(``cifar100_ab5_param_budgets``' flags, matcher and lockstep training) with
5 seeds and the 5M target by default, CSVs ``tournament_target_{N}*.csv``;
``--plan_only`` prints heuristic configs for budgets of 1B and more, and
writes ``tournament_plan_{N}.txt``, without building a model or touching a
device. ``--device cpu`` runs the training on the CPU (default: the GPU).
"""

from __future__ import annotations

import os
from typing import Dict

from .cifar100_ab5_param_budgets import build_argparser as ab5_argparser
from .cifar100_ab5_param_budgets import run


def heuristic_plan_1b(target_params: int) -> Dict[str, Dict[str, int]]:
    """Indicative large-budget configs, no instantiation."""
    plans: Dict[str, Dict[str, int]] = {}
    if target_params >= 1_000_000_000:
        plans["A"] = {"dim": 1280, "depth": 32, "heads": 16}
        plans["B"] = {"dim": 1280, "depth": 32, "heads": 16}
        plans["C"] = {"dim": 1280, "depth": 32, "heads": 16}
        plans["D"] = {"dim": 1152, "depth": 36, "heads": 16}
        plans["E"] = {"dim": 1024, "depth": 40, "heads": 16}
    else:
        plans["A"] = {"dim": 768, "depth": 12, "heads": 12}
        plans["B"] = {"dim": 768, "depth": 12, "heads": 12}
        plans["C"] = {"dim": 768, "depth": 12, "heads": 12}
        plans["D"] = {"dim": 640, "depth": 16, "heads": 10}
        plans["E"] = {"dim": 640, "depth": 16, "heads": 10}
    return plans


def build_argparser():
    ap = ab5_argparser()
    ap.set_defaults(
        seeds=[0, 1, 2, 3, 4],
        targets=[5_000_000],
        out="results/ab5_tournament",
    )
    ap.add_argument("--plan_only", action="store_true",
                    help="Do not train; print per-model planned configs and exit.")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.plan_only:
        os.makedirs(args.out, exist_ok=True)
        for target in args.targets:
            plan = heuristic_plan_1b(int(target))
            print(f"Tournament target parameters: {int(target):,}")
            print("Planned per-model configs (heuristic, no instantiation):")
            for k in args.models:
                print(f"  {k}: {plan.get(k, {})}")
            with open(os.path.join(args.out, f"tournament_plan_{int(target)}.txt"), "w") as f:
                for k in args.models:
                    f.write(f"{k}: {plan.get(k, {})}\n")
        return None
    return run(args, csv_prefix="tournament")


if __name__ == "__main__":
    main()
