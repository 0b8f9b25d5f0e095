#!/usr/bin/env python
"""CIFAR-100 A/B/C parameter-budget experiment, on the port.

The counterpart of ``experiments/cifar100_ab3_param_budgets.py``: the
CIFAR-10 script's flags and output at CIFAR-100's defaults (1500 steps, eval
every 250); CSV ``cifar100_ab3_target_{N}.csv``. ``--device cpu`` runs on
the CPU (default: the GPU).
"""

from . import _param_budgets as PB
from .cifar10_ab3_param_budgets import FAMILIES


def build_argparser():
    return PB.add_output_flags(PB.add_xview_flags(PB.argparser(1500, 250)),
                               "results/cifar100_ab3_param_budgets")


def main(argv=None):
    return PB.run(build_argparser().parse_args(argv), "cifar100", 100, FAMILIES, "cifar100_ab3")


if __name__ == "__main__":
    main()
