#!/usr/bin/env python
"""CIFAR-100 two-hop parameter-budget experiment, on the port.

The counterpart of ``experiments/cifar100_twohop_param_budgets.py``: the
CIFAR-10 script at CIFAR-100's defaults (1500 steps, eval every 250); CSV
``cifar100_twohop_target_{N}.csv`` with ``seed,acc``. ``--device cpu`` runs
on the CPU (default: the GPU).
"""

from .cifar10_twohop_param_budgets import build_argparser as _argparser
from .cifar10_twohop_param_budgets import run


def build_argparser():
    return _argparser(1500, 250, "results/cifar100_twohop_param_budgets")


def main(argv=None):
    return run(build_argparser().parse_args(argv), "cifar100", 100)


if __name__ == "__main__":
    main()
