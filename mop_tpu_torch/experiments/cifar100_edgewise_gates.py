#!/usr/bin/env python
"""CIFAR-100 edgewise-gated attention experiment, on the port.

The counterpart of ``experiments/cifar100_edgewise_gates.py``, with its flags
and defaults: ``ViTEdgewise`` with ``use_k3`` (the dense head's 3x3 mid
conv, which composes: no kernel takes it), the Q/K lens bank (which needs
shared QKV) and the S-channel lens bank; CSV ``cifar100_edgewise_gates.csv``
with ``seed,acc``. ``--device cpu`` runs on the CPU (default: the GPU).
"""

from ..models import ViTEdgewise
from ._single_model import base_argparser, run_single_model_seeds


def build_argparser():
    ap = base_argparser(1500, 250, "results/cifar100_edgewise_gates", 8)
    ap.add_argument("--beta_not", type=float, default=0.5)
    ap.add_argument("--ew_gate_mode", type=str, default="dense",
                    choices=["dense", "lowrank"])
    ap.add_argument("--ew_gate_rank", type=int, default=4)
    ap.add_argument("--ew_gate_init", type=str, default="neutral",
                    choices=["neutral", "and", "or", "chain"])
    ap.add_argument("--use_lens_bank_qk", action="store_true")
    ap.add_argument("--lens_qk_kernel_size", type=int, default=3)
    ap.add_argument("--lens_qk_dilations", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--lens_qk_causal", action="store_true")
    # S-channel lens bank: a depthwise Conv2d over the stacked score maps per dilation.
    ap.add_argument("--use_lens_bank", action="store_true")
    ap.add_argument("--lens_kernel_size", type=int, default=3)
    ap.add_argument("--lens_dilations", type=int, nargs="+", default=[1, 2])
    return ap


def make_factory(args, n_classes: int = 100):
    def factory(device=None, generator=None):
        return ViTEdgewise(
            dim=args.dim, depth=args.depth, heads=args.heads,
            n_classes=n_classes, drop_path=args.drop_path,
            beta_not=args.beta_not,
            use_k3=True,
            share_qkv=args.use_lens_bank_qk,  # the QK lens bank needs shared QKV
            gate_mode=args.ew_gate_mode,
            gate_rank=args.ew_gate_rank,
            gate_init=args.ew_gate_init,
            use_lens_bank_qk=args.use_lens_bank_qk,
            lens_qk_kernel_size=args.lens_qk_kernel_size,
            lens_qk_dilations=tuple(args.lens_qk_dilations),
            lens_qk_causal=args.lens_qk_causal,
            use_lens_bank=args.use_lens_bank,
            lens_kernel_size=args.lens_kernel_size,
            lens_dilations=tuple(args.lens_dilations),
            device=device, generator=generator,
        )

    return factory


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run_single_model_seeds(args, "cifar100", make_factory(args),
                                  "cifar100_edgewise_gates.csv")


if __name__ == "__main__":
    main()
