#!/usr/bin/env python
"""CIFAR-10 A/B parameter-budget experiment, on the port.

The counterpart of ``experiments/cifar10_ab_param_budgets.py``, with its
flags, defaults and output: A grid-matched to each ``--targets`` budget, B
(MoP) matched under A's budget, both trained in lockstep per seed; CSV
``cifar10_ab_target_{N}.csv``. ``--device cpu`` runs on the CPU (default:
the GPU).
"""

import os

import numpy as np

from . import _param_budgets as PB
from . import common as C


def build_argparser():
    return PB.add_output_flags(PB.argparser(1000, 200, schedule=False),
                               "results/cifar10_ab_param_budgets")


def _report(seed, accs):
    print(f"seed {seed}: baseline={accs['b']:.4f}  mop={accs['m']:.4f}  "
          f"diff={accs['m'] - accs['b']:+.4f}")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    mesh, loaders = PB.start(args, "cifar10")
    results = {}
    for target in args.targets:
        print(f"\nTarget parameters: {int(target):,}")
        cfgs = PB.match_configs(args, 10, target, ["base", "mop"])
        (base_cfg, base_p, _), (mop_cfg, mop_p, within) = cfgs["base"], cfgs["mop"]
        print(f"Baseline cfg: {base_cfg} | params={base_p:,}")
        print(f"MoP cfg     : {mop_cfg} | params={mop_p:,} (within 1%: {within})")
        accs = PB.train_seeds(args, mesh, loaders, 10, {"b": "base", "m": "mop"}, cfgs,
                              args.lr, 0.0, report=_report)
        accs_base, accs_mop = accs["b"], accs["m"]
        csv_path = os.path.join(args.out, f"cifar10_ab_target_{int(target)}.csv")
        C.save_csv(
            csv_path,
            ["seed", "baseline_acc", "mop_acc", "diff", "baseline_params",
             "mop_params", "baseline_cfg", "mop_cfg"],
            [[s, f"{accs_base[i]:.4f}", f"{accs_mop[i]:.4f}",
              f"{accs_mop[i] - accs_base[i]:.4f}", base_p, mop_p,
              f'"{base_cfg}"', f'"{mop_cfg}"']
             for i, s in enumerate(args.seeds)],
        )
        mean_diff = float(np.mean(accs_mop)) - float(np.mean(accs_base))
        print(f"\nBaseline: {float(np.mean(accs_base)):.4f} ± {float(np.std(accs_base)):.4f}")
        print(f"MoP:      {float(np.mean(accs_mop)):.4f} ± {float(np.std(accs_mop)):.4f}")
        print(f"Diff:     {mean_diff:+.4f}")
        print(f"Results saved to: {csv_path}")
        results[int(target)] = {"configs": cfgs, "accs": accs}
    return results


if __name__ == "__main__":
    main()
