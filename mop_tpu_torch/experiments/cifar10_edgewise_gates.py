#!/usr/bin/env python
"""CIFAR-10 edgewise-gated attention experiment, on the port.

The counterpart of ``experiments/cifar10_edgewise_gates.py``, with its flags
and defaults: ``ViTEdgewise`` with the dense or lowrank gate head and its
presets; CSV ``cifar10_edgewise_gates.csv`` with ``seed,acc``. ``--device
cpu`` runs on the CPU (default: the GPU).
"""

from ..models import ViTEdgewise
from ._single_model import base_argparser, run_single_model_seeds


def build_argparser():
    ap = base_argparser(1000, 200, "results/cifar10_edgewise_gates", 6)
    ap.add_argument("--beta_not", type=float, default=0.5)
    ap.add_argument("--ew_gate_mode", type=str, default="dense",
                    choices=["dense", "lowrank"])
    ap.add_argument("--ew_gate_rank", type=int, default=4)
    ap.add_argument("--ew_gate_init", type=str, default="neutral",
                    choices=["neutral", "and", "or", "not", "nor", "xor", "chain"])
    return ap


def make_factory(args, n_classes: int = 10):
    def factory(device=None, generator=None):
        return ViTEdgewise(
            dim=args.dim, depth=args.depth, heads=args.heads,
            n_classes=n_classes, drop_path=args.drop_path,
            beta_not=args.beta_not,
            gate_mode=args.ew_gate_mode,
            gate_rank=args.ew_gate_rank,
            gate_init=args.ew_gate_init,
            device=device, generator=generator,
        )

    return factory


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run_single_model_seeds(args, "cifar10", make_factory(args),
                                  "cifar10_edgewise_gates.csv")


if __name__ == "__main__":
    main()
