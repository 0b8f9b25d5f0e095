#!/usr/bin/env python
"""ImageNet A/B/E at fixed parameter budgets, on the port.

The counterpart of ``experiments/imagenet_ab_param_budgets.py``, with its
flags, defaults and output files: ImageFolder data (``$IMAGENET_ROOT``) with
its val split cut into val and test (test_frac 0.2), or the synthetic
ImageFolder (``--synthetic``, or when there is none); A=Baseline, B=MoP and
E=Edgewise matched to A's budget (``max_ratio_diff`` 0.01) on the ImageNet
grids, ``--ew_variants`` spawning ``E_{mode}_{init}``; every model trained
in lockstep on the same batches by ``make_imagenet_train_step``
(RandAugment, RandomErasing, Mixup/CutMix by ``--mix_prob``, label
smoothing, grad clip), the large-budget LR switch; ``--ema`` keeps a shadow
copy of each model, updated every step and used for every eval;
``--ckpt_every`` / ``--resume`` (the EMA in the payload's ``extra``); and
``imagenet_ab_target_{N}.csv``, ``_val_summary.csv`` and ``_test.csv``
under ``--out``.

``--device`` picks the torch device (the GPU unless given):

    python -m mop_tpu_torch.experiments.imagenet_ab_param_budgets --device cpu \\
        --synthetic --tiny --targets 200000 --steps 2 --batch 8 --img_size 32 --seeds 0
"""

from __future__ import annotations

import argparse
import copy
import glob
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data import BatchIterator, eval_batches
from ..data.imagenet import (has_imagefolder, load_imagefolder, synthetic_imagenet,
                             val_test_split)
from ..models import ViT_Baseline, ViT_MoP, ViTEdgewise
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from ..parallel import make_classifier_eval_step, make_imagenet_train_step
from ..training.utils import ema_update, load_checkpoint, save_checkpoint, step_seed
from ..parallel import make_mesh
from ..parallel.mesh import replicate, shard_batch
from . import common as C

IMAGENET_DIMS = (192, 224, 256, 320, 384, 448, 512, 640, 768, 1024, 1280)
IMAGENET_DEPTHS = (8, 10, 12, 16, 24, 32)
IMAGENET_HEADS = (3, 4, 6, 8, 12, 16)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str,
                    default=os.environ.get("IMAGENET_ROOT", "./data/imagenet"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lr_large", type=float, default=1e-3)
    ap.add_argument("--large_threshold", type=int, default=100_000_000)
    ap.add_argument("--warmup_frac", type=float, default=0.1)
    ap.add_argument("--weight_decay", type=float, default=5e-2)
    ap.add_argument("--eval_every", type=int, default=1000)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--targets", type=int, nargs="+",
                    default=[50_000_000, 300_000_000])
    ap.add_argument("--models", type=str, nargs="+", choices=["A", "B", "E"],
                    default=["A", "B"])
    ap.add_argument("--mop_views", type=int, default=5)
    ap.add_argument("--mop_kernels", type=int, default=3)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--drop_path", type=float, default=0.4)
    ap.add_argument("--ew_beta_not", type=float, default=0.5)
    ap.add_argument("--ew_use_k3", action="store_true")
    ap.add_argument("--ew_views", type=int, default=5)
    ap.add_argument("--ew_share_qkv", action="store_true")
    ap.add_argument("--ew_mlp_ratio", type=float, default=4.0)
    ap.add_argument("--ew_variants", type=str, nargs="+", default=None)
    ap.add_argument("--ew_gate_mode", type=str, default="dense",
                    choices=["dense", "lowrank"])
    ap.add_argument("--ew_gate_rank", type=int, default=4)
    ap.add_argument("--ew_gate_init", type=str, default="neutral",
                    choices=["neutral", "and", "or", "not", "nor", "xor", "chain"])
    ap.add_argument("--label_smoothing", type=float, default=0.1)
    ap.add_argument("--use_randaug", action="store_true")
    ap.add_argument("--randaug_n", type=int, default=2)
    ap.add_argument("--randaug_m", type=int, default=9)
    ap.add_argument("--random_erasing", type=float, default=0.25)
    ap.add_argument("--mixup_alpha", type=float, default=0.8)
    ap.add_argument("--cutmix_alpha", type=float, default=1.0)
    ap.add_argument("--mix_prob", type=float, default=0.5)
    ap.add_argument("--grad_clip", type=float, default=1.0)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--ema_decay", type=float, default=0.9999)
    ap.add_argument("--out", type=str, default="results/imagenet_ab_param_budgets")
    ap.add_argument("--ckpt_every", type=int, default=0,
                    help="save per-model checkpoints every N steps (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoints under --out")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    return ap


def load_data(args):
    """(train x, train y, val x, val y, test x, test y, n_classes): the
    ImageFolder under ``--data_root`` where present (50 train and 10 val
    images a class with ``--tiny``), else the synthetic set of 100 classes
    (512 / 256 images with ``--tiny``, 4000 / 1000 without); its val split
    cut 0.8 / 0.2 into val and test."""
    if not args.synthetic and has_imagefolder(args.data_root, "train"):
        tr_x, tr_y, classes = load_imagefolder(args.data_root, "train", args.img_size,
                                               limit_per_class=50 if args.tiny else None)
        va_all_x, va_all_y, _ = load_imagefolder(args.data_root, "val", args.img_size,
                                                 limit_per_class=10 if args.tiny else None)
        n_classes = len(classes)
        va_x, va_y, te_x, te_y = val_test_split(va_all_x, va_all_y, test_frac=0.2)
    else:
        n_classes = 100
        n_tr, n_te = (512, 256) if args.tiny else (4000, 1000)
        tr_x, tr_y, va_all_x, va_all_y = synthetic_imagenet(n_tr, n_te, n_classes,
                                                            args.img_size)
        va_x, va_y, te_x, te_y = val_test_split(va_all_x, va_all_y, test_frac=0.2)
        print(f"Synthetic ImageFolder: {n_tr} train / {len(va_x)} val / {len(te_x)} test")
    return tr_x, tr_y, va_x, va_y, te_x, te_y, n_classes


def _ew_extra(args) -> Dict:
    return {"patch": args.patch, "beta_not": args.ew_beta_not, "use_k3": args.ew_use_k3,
            "n_views": args.ew_views, "share_qkv": args.ew_share_qkv,
            "mlp_ratio": args.ew_mlp_ratio, "gate_mode": args.ew_gate_mode,
            "gate_rank": args.ew_gate_rank, "gate_init": args.ew_gate_init,
            "num_tokens": (args.img_size // args.patch) ** 2}


def match_configs(args, target: int, n_classes: int) -> Dict[str, Tuple[Dict[str, int], int]]:
    """A's config nearest ``target`` on the ImageNet grids, and B's and E's
    (those in ``--models``) matched under A's count within 1%."""
    base_extra = {"patch": args.patch, "img_size": args.img_size}
    base_cfg, base_p = C.find_config_for_target(
        ViT_Baseline, n_classes=n_classes, target_params=int(target),
        dims=IMAGENET_DIMS, depths=IMAGENET_DEPTHS, heads_list=IMAGENET_HEADS,
        extra_kwargs=base_extra, img_size=args.img_size,
    )
    cfgs: Dict[str, Tuple[Dict[str, int], int]] = {"A": (base_cfg, base_p)}
    if "B" in args.models:
        cfgs["B"] = C.find_model_config_match_baseline(
            ViT_MoP, n_classes=n_classes, target_params=int(target),
            baseline_cfg=base_cfg, baseline_params=base_p, max_ratio_diff=0.01,
            depths_choices=IMAGENET_DEPTHS, heads_choices=IMAGENET_HEADS,
            extra_kwargs={**base_extra, "n_views": args.mop_views,
                          "n_kernels": args.mop_kernels},
            img_size=args.img_size,
        )[:2]
    if "E" in args.models:
        cfgs["E"] = C.find_model_config_match_baseline(
            ViTEdgewise, n_classes=n_classes, target_params=int(target),
            baseline_cfg=base_cfg, baseline_params=base_p, max_ratio_diff=0.01,
            depths_choices=IMAGENET_DEPTHS, heads_choices=IMAGENET_HEADS,
            extra_kwargs=_ew_extra(args), img_size=args.img_size,
        )[:2]
    return cfgs


def model_keys_for(args) -> List[str]:
    """A always, then B if asked, then E or one ``E_{mode}_{init}`` per
    ``--ew_variants`` item."""
    keys = [k for k in ("A", "B") if k in args.models or k == "A"]
    if "E" in args.models:
        if args.ew_variants:
            keys += [f"E_{spec.replace(':', '_', 1)}" for spec in args.ew_variants]
        else:
            keys.append("E")
    return keys


def make_model(args, cfgs, key: str, n_classes: int, device, generator):
    """The model of run ``key`` on ``device``, initialised from ``generator``."""
    kw = dict(n_classes=n_classes, drop_path=args.drop_path, device=device,
              generator=generator)
    if key == "A":
        return ViT_Baseline(**cfgs["A"][0], patch=args.patch, img_size=args.img_size, **kw)
    if key == "B":
        return ViT_MoP(**cfgs["B"][0], patch=args.patch, img_size=args.img_size,
                       n_views=args.mop_views, n_kernels=args.mop_kernels, **kw)
    extra = _ew_extra(args)
    if key.startswith("E_"):
        _, extra["gate_mode"], extra["gate_init"] = key.split("_", 2)
    return ViTEdgewise(**cfgs["E"][0], **extra, **kw)


class _Run:
    """One model of the lockstep run: its optimizer and schedule, train and
    eval steps, generator and, with ``--ema``, its shadow copy. Under
    ``mesh`` the steps are data parallel over each process's rows."""

    def __init__(self, args, model, lr, n_classes, device, mesh=None):
        self.mesh = mesh
        self.model = model if mesh is None else replicate(model, mesh)
        self.opt, self.schedule = C.make_opt(model.parameters(), lr, args.steps,
                                             args.warmup_frac, args.weight_decay)
        self.step = make_imagenet_train_step(
            model, self.opt, IMAGENET_MEAN, IMAGENET_STD, n_classes,
            label_smoothing=args.label_smoothing, use_randaug=args.use_randaug,
            randaug_n=args.randaug_n, randaug_m=args.randaug_m,
            random_erasing=args.random_erasing, mixup_alpha=args.mixup_alpha,
            cutmix_alpha=args.cutmix_alpha, mix_prob=args.mix_prob, grad_clip=args.grad_clip,
            device=device, mesh=mesh)
        self.ema = copy.deepcopy(model).requires_grad_(False) if args.ema else None
        self.eval_step = make_classifier_eval_step(self.ema or model, IMAGENET_MEAN,
                                                   IMAGENET_STD, device=device, mesh=mesh)
        self.generator = torch.Generator(device=device)
        self.count = 0  # updates so far: the schedule's step
        self.losses: List[torch.Tensor] = []

    def train(self, xb, yb, seed: int, step_i: int, ema_decay: float):
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.generator.manual_seed(step_seed(seed, step_i))
        self.losses.append(self.step(xb, yb, self.generator)["loss"])
        self.count += 1
        if self.ema is not None:
            ema_update(self.ema.parameters(), self.model.parameters(), ema_decay)

    def evaluate(self, batches) -> float:
        """Accuracy over ``batches``, by the EMA weights where kept."""
        correct = total = 0.0
        for xb, yb, mb in batches:
            batch = tuple(torch.as_tensor(np.asarray(a)) for a in (xb, yb, mb))
            c, t = self.eval_step(*(batch if self.mesh is None else
                                    shard_batch(batch, self.mesh)))
            correct += float(c)
            total += float(t)
        return correct / max(total, 1)

    def save(self, path: str, step_i: int) -> None:
        if not C.is_main_process():
            return
        save_checkpoint(path, self.model.state_dict(), opt_state=self.opt.state_dict(),
                        step=step_i, extra=None if self.ema is None else self.ema.state_dict())

    def load(self, path: str, device) -> None:
        payload = load_checkpoint(path, map_location=device)
        self.model.load_state_dict(payload["state_dict"])
        self.opt.load_state_dict(payload["opt_state"])
        if self.ema is not None and payload.get("extra") is not None:
            self.ema.load_state_dict(payload["extra"])
        self.count = int(payload["step"])


def run(args) -> Dict[int, Dict]:
    """Run every target and write its files. Returns, by target, the matched
    ``configs``, each run's ``params``, the last seed's per-step ``losses``,
    the per-seed ``val_acc`` and the last seed's ``test_acc``."""
    os.makedirs(args.out, exist_ok=True)
    mesh = make_mesh(device=args.device)
    device = mesh.device
    print(f"Device: {C.get_device_str(device)}")
    tr_x, tr_y, va_x, va_y, te_x, te_y, n_classes = load_data(args)

    results: Dict[int, Dict] = {}
    for target in args.targets:
        print(f"\nTarget parameters: {int(target):,}")
        lr_current = args.lr if int(target) < int(args.large_threshold) else args.lr_large
        cfgs = match_configs(args, target, n_classes)
        print(f"Baseline cfg: {cfgs['A'][0]} | params={cfgs['A'][1]:,}")
        for k in ("B", "E"):
            if k in cfgs:
                print(f"{k} cfg: {cfgs[k][0]} | params={cfgs[k][1]:,}")
        model_keys = model_keys_for(args)
        accs: Dict[str, List[float]] = {k: [] for k in model_keys}
        runs: Dict[str, _Run] = {}

        for s in args.seeds:
            print(f"\nSeed {s}")
            C.set_seed(s)
            runs = {key: _Run(args, make_model(args, cfgs, key, n_classes, device,
                                               torch.Generator().manual_seed(s)),
                              lr_current, n_classes, device, mesh) for key in model_keys}

            def ckpt_path(key, step_i):
                return os.path.join(args.out, f"ckpt_s{s}_{key}_step{step_i}.pkl")

            start_step = 1
            if args.resume:
                found = [[int(f.rsplit("step", 1)[1].split(".")[0])
                          for f in glob.glob(os.path.join(args.out, f"ckpt_s{s}_{key}_step*.pkl"))]
                         for key in model_keys]
                common = min(max(f) if f else 0 for f in found)
                if common > 0:
                    for key, r in runs.items():
                        r.load(ckpt_path(key, common), device)
                    start_step = common + 1
                    print(f"resumed seed {s} from step {common}")

            it = BatchIterator(tr_x, tr_y, args.batch, seed=s)
            for step_i in range(start_step, args.steps + 1):
                xb, yb = shard_batch(tuple(np.asarray(a) for a in next(it)), mesh)
                for r in runs.values():
                    r.train(xb, yb, s, step_i, args.ema_decay)
                if args.ckpt_every and step_i % args.ckpt_every == 0:
                    for key, r in runs.items():
                        r.save(ckpt_path(key, step_i), step_i)
                    if mesh.device_mesh is not None:
                        torch.distributed.barrier()  # written before any process reads
                if step_i % max(args.eval_every, 1) == 0 or step_i == 1:
                    report = [(k, r.evaluate(eval_batches(va_x, va_y, args.batch)))
                              for k, r in runs.items()]
                    print(f"step {step_i} | " + " ".join(f"A{k}={a:.3f}" for k, a in report))
            for key, r in runs.items():
                accs[key].append(r.evaluate(eval_batches(va_x, va_y, args.batch)))
            print("seed", s, " ".join(f"{k}={accs[k][-1]:.4f}" for k in accs))

        # Test eval: the last seed's models (their EMA where kept).
        test_report = [(k, r.evaluate(eval_batches(te_x, te_y, args.batch)))
                       for k, r in runs.items()]
        prefix = os.path.join(args.out, f"imagenet_ab_target_{int(target)}")
        C.save_csv(prefix + ".csv", ["seed"] + [f"acc_{k}" for k in accs],
                   [[s] + [f"{accs[k][i]:.4f}" for k in accs]
                    for i, s in enumerate(args.seeds)])
        C.save_csv(prefix + "_val_summary.csv", ["model", "mean_val", "std_val"],
                   [[k, f"{float(np.mean(v)):.6f}", f"{float(np.std(v)):.6f}"]
                    for k, v in accs.items()])
        C.save_csv(prefix + "_test.csv", ["model", "test_acc"],
                   [[k, f"{a:.6f}"] for k, a in test_report])
        print("\n" + " ".join(f"{k}={float(np.mean(v)):.4f}±{float(np.std(v)):.4f}"
                              for k, v in accs.items()))
        print(f"Results saved to: {args.out}")
        results[int(target)] = {
            "configs": cfgs, "runs": runs,
            "params": {k: C.count_parameters(r.model) for k, r in runs.items()},
            "losses": {k: [float(v) for v in r.losses] for k, r in runs.items()},
            "val_acc": accs, "test_acc": dict(test_report)}
    return results


def main(argv=None) -> Dict[int, Dict]:
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
