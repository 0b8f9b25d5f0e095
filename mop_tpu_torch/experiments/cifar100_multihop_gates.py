#!/usr/bin/env python
"""CIFAR-100 multi-hop gated-attention experiment, on the port.

The counterpart of ``experiments/cifar100_multihop_gates.py``, with its flags
and defaults: ``ViTMultiHop`` (gated multi-hop score composition and chained
value transport) with fixed scalar logic gates from the CLI; CSV
``cifar100_multihop_gates.csv`` with ``seed,acc``. ``--device cpu`` runs on
the CPU (default: the GPU).
"""

from ..models import ViTMultiHop
from ._single_model import base_argparser, run_single_model_seeds


def add_flags(ap):
    ap.add_argument("--beta_not", type=float, default=0.5)
    ap.add_argument("--hops", type=int, default=3)
    ap.add_argument("--gate_base", type=float, default=1.0)
    ap.add_argument("--gate_and", type=float, default=1.0)
    ap.add_argument("--gate_or", type=float, default=0.0)
    ap.add_argument("--gate_not", type=float, default=0.0)
    ap.add_argument("--gate_chain", type=float, default=0.0)
    return ap


def make_factory(args, n_classes: int):
    gates = dict(base=args.gate_base, and_=args.gate_and, or_=args.gate_or,
                 not_=args.gate_not, chain=args.gate_chain)

    def factory(device=None, generator=None):
        return ViTMultiHop(
            dim=args.dim, depth=args.depth, heads=args.heads,
            n_classes=n_classes, drop_path=args.drop_path,
            beta_not=args.beta_not, gates=gates, hops=args.hops,
            device=device, generator=generator,
        )

    return factory


def build_argparser():
    return add_flags(base_argparser(1500, 250, "results/cifar100_multihop_gates", 8))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run_single_model_seeds(args, "cifar100", make_factory(args, 100),
                                  "cifar100_multihop_gates.csv")


if __name__ == "__main__":
    main()
