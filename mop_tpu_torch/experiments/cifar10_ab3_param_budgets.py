#!/usr/bin/env python
"""CIFAR-10 A/B/C parameter-budget experiment, on the port.

The counterpart of ``experiments/cifar10_ab3_param_budgets.py``, with its
flags, defaults and output: A grid-matched to each ``--targets`` budget, B
(MoP) and C (CrossView) matched under A's budget, the three trained in
lockstep per seed; CSV ``cifar10_ab3_target_{N}.csv``. ``--device cpu``
runs on the CPU (default: the GPU).
"""

from . import _param_budgets as PB

FAMILIES = ["base", "mop", "xview"]


def build_argparser():
    return PB.add_output_flags(PB.add_xview_flags(PB.argparser(1000, 200)),
                               "results/cifar10_ab3_param_budgets")


def main(argv=None):
    return PB.run(build_argparser().parse_args(argv), "cifar10", 10, FAMILIES, "cifar10_ab3")


if __name__ == "__main__":
    main()
