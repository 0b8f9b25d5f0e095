#!/usr/bin/env python
"""CIFAR-10 cross-view mixer experiment, on the port.

The counterpart of ``experiments/cifar10_crossview_mixer.py``: the CIFAR-100
script's model and flags at CIFAR-10's defaults (1000 steps, eval every 200,
depth 6); CSV ``cifar10_crossview_mixer.csv`` with ``seed,acc``.
"""

from ._single_model import base_argparser, run_single_model_seeds
from .cifar100_crossview_mixer import add_flags, make_factory


def build_argparser():
    return add_flags(base_argparser(1000, 200, "results/cifar10_crossview_mixer", 6))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run_single_model_seeds(args, "cifar10", make_factory(args, 10),
                                  "cifar10_crossview_mixer.csv")


if __name__ == "__main__":
    main()
