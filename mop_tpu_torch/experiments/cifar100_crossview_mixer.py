#!/usr/bin/env python
"""CIFAR-100 cross-view mixer experiment, on the port.

The counterpart of ``experiments/cifar100_crossview_mixer.py``, with its
flags and defaults: ``ViTCrossView`` (2-view binding, 2x2 learnable mixer,
transpose cues, optional per-key prior); CSV ``cifar100_crossview_mixer.csv``
with ``seed,acc``. ``--device cpu`` runs on the CPU (default: the GPU).
"""

from ..models import ViTCrossView
from ._single_model import base_argparser, run_single_model_seeds


def add_flags(ap):
    ap.add_argument("--use_transpose_cues", action="store_true")
    ap.add_argument("--t1", type=float, default=0.0)
    ap.add_argument("--t2", type=float, default=0.0)
    ap.add_argument("--enable_prior", action="store_true")
    ap.add_argument("--prior_weight", type=float, default=0.5)
    ap.add_argument("--anchor_mode", type=str,
                    choices=["argmax_row_sum", "fixed", "none"],
                    default="argmax_row_sum")
    ap.add_argument("--k_star", type=int, default=0)
    return ap


def make_factory(args, n_classes: int):
    def factory(device=None, generator=None):
        return ViTCrossView(
            dim=args.dim, depth=args.depth, heads=args.heads,
            n_classes=n_classes, drop_path=args.drop_path,
            use_transpose_cues=args.use_transpose_cues,
            t1=args.t1, t2=args.t2,
            enable_per_key_prior=args.enable_prior,
            prior_weight=args.prior_weight,
            anchor_mode=args.anchor_mode,
            fixed_k_star=args.k_star,
            device=device, generator=generator,
        )

    return factory


def build_argparser():
    return add_flags(base_argparser(1500, 250, "results/cifar100_crossview_mixer", 8))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run_single_model_seeds(args, "cifar100", make_factory(args, 100),
                                  "cifar100_crossview_mixer.csv")


if __name__ == "__main__":
    main()
