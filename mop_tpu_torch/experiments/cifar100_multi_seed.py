#!/usr/bin/env python
"""CIFAR-100 multi-seed A-vs-B experiment, on the port.

The counterpart of ``experiments/cifar100_multi_seed.py``: the CIFAR-10
script at 256 / 8 / 4 and CIFAR-100's defaults (1500 steps, eval every
250); CSV ``cifar100_acc.csv`` with ``seed,baseline,mop,diff`` and
``summary.json``. ``--device cpu`` runs on the CPU (default: the GPU).
"""

from .cifar10_multi_seed import build_argparser as _argparser
from .cifar10_multi_seed import run


def build_argparser():
    return _argparser(1500, 250, "results/cifar100")


def main(argv=None):
    return run(build_argparser().parse_args(argv), "cifar100", 100, 8, "cifar100_acc.csv")


if __name__ == "__main__":
    main()
