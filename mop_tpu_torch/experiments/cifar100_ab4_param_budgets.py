#!/usr/bin/env python
"""CIFAR-100 A/B/C/D parameter-budget experiment, on the port.

The counterpart of ``experiments/cifar100_ab4_param_budgets.py``, with its
flags, defaults and output: A grid-matched to each ``--targets`` budget, B
(MoP), C (CrossView) and D (MultiHop, ``--mh_*``) matched under A's budget,
the four trained in lockstep per seed; CSV ``cifar100_ab4_target_{N}.csv``.
D trains through the composed path and evaluates through the multi-hop
kernel. ``--device cpu`` runs on the CPU (default: the GPU).
"""

from . import _param_budgets as PB

FAMILIES = ["base", "mop", "xview", "multihop"]


def build_argparser():
    ap = PB.add_multihop_flags(PB.add_xview_flags(PB.argparser(1500, 250)))
    return PB.add_output_flags(ap, "results/cifar100_ab4_param_budgets")


def main(argv=None):
    return PB.run(build_argparser().parse_args(argv), "cifar100", 100, FAMILIES, "cifar100_ab4")


if __name__ == "__main__":
    main()
