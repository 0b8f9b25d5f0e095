#!/usr/bin/env python
"""VOC07/12 single-object localization with a ViT backbone, on the port.

The counterpart of ``experiments/voc_localization_vit.py``, with its flags,
defaults and output: modes A (plain), B (MoP token gate), E (``UnifiedMSA``
edgewise blocks); AdamW with warmup and cosine decay, the SmoothL1 box loss,
the IoU / L1 eval on the val split, and ``voc_<model>_results.csv`` under
``--out``. The synthetic rectangles stand in when there is no VOCdevkit
under ``--data_root`` (or with ``--synthetic``).

``--device`` picks the torch device (the GPU unless given):

    python -m mop_tpu_torch.experiments.voc_localization_vit \\
        --device cpu --synthetic --tiny --epochs 1 --dim 32 --depth 1 --img_size 64
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from ..data.voc import has_real_voc, load_voc_boxes, synthetic_voc
from ..models.layers import set_generator
from ..models.vit_localizer import ViTLocalizer, bbox_iou, smooth_l1
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize, to_float
from ..utils.device import resolve_device
from . import common as C


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="VOC07/12 single-object localization with ViT backbone")
    ap.add_argument("--data_root", type=str, default="./data")
    ap.add_argument("--year", type=str, default="2007", choices=["2007", "2012"])
    ap.add_argument("--download", action="store_true",
                    help="(no-op in zero-egress envs; place VOCdevkit under data_root)")
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--mlp_ratio", type=float, default=4.0)
    ap.add_argument("--drop_path", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup_frac", type=float, default=0.1)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=1)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", type=str, default="results/voc_localization")
    ap.add_argument("--model", type=str, default="A", choices=["A", "B", "E"],
                    help="A=baseline, B=MoP gate, E=Edgewise attention")
    ap.add_argument("--mop_views", type=int, default=5)
    ap.add_argument("--mop_kernels", type=int, default=3)
    ap.add_argument("--ew_views", type=int, default=4)
    ap.add_argument("--ew_use_k3", action="store_true")
    ap.add_argument("--ew_share_qkv", action="store_true")
    ap.add_argument("--ew_gate_mode", type=str, default="lowrank",
                    choices=["dense", "lowrank"])
    ap.add_argument("--ew_gate_rank", type=int, default=4)
    ap.add_argument("--ew_gate_init", type=str, default="neutral",
                    choices=["neutral", "and", "or", "not", "nor", "xor",
                             "chain", "mix5"])
    ap.add_argument("--ew_use_lens_bank_qk", action="store_true")
    ap.add_argument("--ew_lens_qk_dilations", type=int, nargs="+", default=None)
    ap.add_argument("--ew_lens_qk_causal", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def load_data(args):
    """(train images, train boxes, val images, val boxes): VOCdevkit's train
    and val splits where present, else the synthetic rectangles (256 / 64
    with ``--tiny``, 2000 / 500 without)."""
    if not args.synthetic and has_real_voc(args.data_root, args.year):
        tx_img, tx_box = load_voc_boxes(args.data_root, args.year, "train", args.img_size)
        vx_img, vx_box = load_voc_boxes(args.data_root, args.year, "val", args.img_size)
        print(f"Loaded VOC{args.year}: {len(tx_img)} train / {len(vx_img)} val")
    else:
        n_train, n_val = (256, 64) if args.tiny else (2000, 500)
        tx_img, tx_box = synthetic_voc(n_train, args.img_size, seed=0)
        vx_img, vx_box = synthetic_voc(n_val, args.img_size, seed=1)
        print(f"Synthetic rectangles: {n_train} train / {n_val} val")
    return tx_img, tx_box, vx_img, vx_box


def make_model(args, device, generator) -> ViTLocalizer:
    """The ``--model`` localizer on ``device``, initialised from ``generator``."""
    attn_kwargs = None
    if args.model == "E":
        attn_kwargs = dict(n_views=args.ew_views, use_k3=args.ew_use_k3,
                           share_qkv=args.ew_share_qkv, gate_mode=str(args.ew_gate_mode),
                           gate_rank=int(args.ew_gate_rank),
                           gate_init=str(args.ew_gate_init))
    return ViTLocalizer(dim=args.dim, depth=args.depth, heads=args.heads,
                        mlp_ratio=args.mlp_ratio, drop_path=args.drop_path, patch=args.patch,
                        img_size=args.img_size, attn_mode=args.model, attn_kwargs=attn_kwargs,
                        mop_views=args.mop_views, mop_kernels=args.mop_kernels,
                        device=device, generator=generator)


def run(args) -> Dict:
    """Train and evaluate; write the CSV. Returns each step's ``losses``,
    each eval's ``(epoch, iou, l1)`` in ``evals``, the final ``iou`` and
    ``l1`` and the ``csv`` path."""
    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    print(f"Device: {C.get_device_str(device)}")
    tx_img, tx_box, vx_img, vx_box = load_data(args)

    model = make_model(args, device, torch.Generator().manual_seed(0))
    n_batches = max(1, len(tx_img) // args.batch)
    total_steps = args.epochs * n_batches
    opt, schedule = C.make_opt(model.parameters(), args.lr, total_steps, args.warmup_frac,
                               args.weight_decay)
    generator = torch.Generator(device=device)

    def prep(x_u8):
        return normalize(to_float(torch.from_numpy(x_u8).to(device)), IMAGENET_MEAN,
                         IMAGENET_STD)

    def train_step(xb, yb, step):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        generator.manual_seed(step)  # the drop-path masks of update ``step``
        model.train()
        set_generator(model, generator)
        opt.zero_grad(set_to_none=True)
        loss = smooth_l1(model(prep(xb)), torch.from_numpy(yb).to(device)).mean()
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.inference_mode()
    def evaluate():
        model.eval()
        ious, l1s = [], []
        for i in range(0, len(vx_img) - args.batch + 1, args.batch):
            pred = model(prep(vx_img[i:i + args.batch]))
            yb = torch.from_numpy(vx_box[i:i + args.batch]).to(device)
            ious.append(float(bbox_iou(pred, yb).mean()))
            l1s.append(float((pred - yb).abs().mean()))
        return float(np.mean(ious)), float(np.mean(l1s))

    order_rng = np.random.RandomState(0)
    losses, evals = [], []
    step = 0
    for epoch in range(1, args.epochs + 1):
        order = order_rng.permutation(len(tx_img))
        for i in range(n_batches):
            idx = order[i * args.batch:(i + 1) * args.batch]
            if len(idx) < args.batch:
                continue
            losses.append(train_step(tx_img[idx], tx_box[idx], step))
            step += 1
        if epoch % max(args.eval_every, 1) == 0:
            iou, l1 = evaluate()
            evals.append((epoch, iou, l1))
            print(f"epoch {epoch}/{args.epochs} | loss={float(losses[-1]):.4f} "
                  f"| val IoU={iou:.4f} L1={l1:.4f}")

    iou, l1 = evaluate()
    csv_path = os.path.join(args.out, f"voc_{args.model}_results.csv")
    C.save_csv(csv_path, ["model", "val_iou", "val_l1"], [[args.model, f"{iou:.4f}", f"{l1:.4f}"]])
    print(f"\nFinal: IoU={iou:.4f} L1={l1:.4f}")
    print(f"Results saved to: {csv_path}")
    return {"losses": [float(v) for v in losses], "evals": evals, "iou": iou, "l1": l1,
            "csv": csv_path}


def main(argv=None) -> Dict:
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
