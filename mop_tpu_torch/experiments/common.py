"""Shared experiment machinery of the port: the counterpart of
``experiments/common.py``, function by function, in PyTorch.

- Data: ``get_loaders`` (the native prefetching loader where it builds, else
  ``BatchIterator``, as the JAX harness chooses), so one seed gives both
  packages the same batches.
- Parameter matching: ``estimate_params`` counts a model built on the
  ``meta`` device (no weights are allocated), ``find_config_for_target`` and
  ``find_model_config_match_baseline`` search as the JAX harness does, with
  its scoring and windows.
- Training: ``make_lr_schedule`` (optax's linear warmup joined to its cosine
  decay, step for step), ``make_opt`` (``torch.optim.AdamW``), ``ModelRun``
  (one model with its optimizer, its train and eval steps and its generator)
  and ``lockstep_train`` (every run on the same batches, periodic eval,
  checkpoints, ``--resume``, SIGTERM -> checkpoint -> exit 75).
- Statistics and output: ``mcnemar``, ``bootstrap_delta``, ``save_csv`` and
  the two plots.

Entry points run on the GPU unless a device is given (``device="cpu"``).
Every CLI builds a mesh with ``parallel.make_mesh`` (a world-1 mesh with no
process group when started alone) and passes it to ``ModelRun`` and
``lockstep_train``: under ``cli/launch_multihost.py`` or torchrun each
process trains on its rows of every batch (data parallel), and only the main
process writes files.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data import BatchIterator, eval_batches, load_cifar, native_loader, train_val_split
from ..ops.preprocess import (CIFAR10_MEAN, CIFAR10_STD, CIFAR100_MEAN, CIFAR100_STD,
                              cifar_eval_transform)
from ..parallel import make_classifier_eval_step, make_classifier_train_step
from ..parallel import comm
from ..parallel.mesh import DATA_AXIS, replicate, shard_batch
from ..training.preemption import PREEMPTED_EXIT_CODE, PreemptionGuard
from ..training.utils import count_params, load_checkpoint, save_checkpoint, step_seed
from ..training.utils import set_seed  # noqa: F401  (the CLIs call it as common.set_seed)
from ..utils.device import resolve_device

Device = Optional[Union[str, torch.device]]


def get_device_str(device: Device = None) -> str:
    """This process's device (``cuda:LOCAL_RANK`` under a process group), its
    name, and the number of processes."""
    device = resolve_device(device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available() and torch.distributed.is_initialized() else 1)
    if device.type == "cuda":
        return f"{device}:{torch.cuda.get_device_name(device)} x{world}"
    return f"{device.type} x{world}"


def is_main_process() -> bool:
    """Under a multi-process launch every process holds the same replicated
    results; only rank 0 writes files."""
    return not (torch.distributed.is_available() and torch.distributed.is_initialized()) \
        or torch.distributed.get_rank() == 0


# ----------------------------- data -----------------------------


def get_loaders(
    dataset: str,
    batch: int,
    tiny: bool = False,
    val_frac: float = 0.1,
    val_seed: int = 0,
    synthetic: bool = False,
    seed: int = 0,
    download: bool = False,
):
    """Train iterator and val/test eval-batch factories.

    Returns (train_iter_factory(seed), val_batches_fn, test_batches_fn,
    mean, std, n_classes). The batches are numpy arrays, as JAX's.
    """
    name = "cifar10" if dataset == "cifar10" else "cifar100"
    mean, std = (CIFAR10_MEAN, CIFAR10_STD) if name == "cifar10" else (
        CIFAR100_MEAN, CIFAR100_STD)
    n_classes = 10 if name == "cifar10" else 100
    tr_x, tr_y, te_x, te_y = load_cifar(name, synthetic=synthetic, download=download)
    if tiny:
        tr_x, tr_y = tr_x[:2000], tr_y[:2000]
        te_x, te_y = te_x[:1000], te_y[:1000]
    if val_frac > 0:
        tr_x, tr_y, va_x, va_y = train_val_split(tr_x, tr_y, val_frac, val_seed)
    else:
        va_x, va_y = te_x, te_y

    def train_iter(seed_=0):
        try:
            if native_loader.is_available():
                return native_loader.NativeBatchIterator(tr_x, tr_y, batch, seed=seed_)
        except Exception:
            pass
        return BatchIterator(tr_x, tr_y, batch, seed=seed_)

    def val_batches():
        return eval_batches(va_x, va_y, batch)

    def test_batches():
        return eval_batches(te_x, te_y, batch)

    return train_iter, val_batches, test_batches, mean, std, n_classes


# ----------------------- parameter matching -----------------------


count_parameters = count_params


_ESTIMATE_CACHE: Dict = {}


def estimate_params(
    ctor,
    n_classes: int,
    dim: int,
    depth: int,
    heads: int,
    extra_kwargs: Optional[Dict] = None,
    img_size: int = 32,
) -> int:
    """Parameter count of ``ctor(dim, depth, heads, n_classes, **extra_kwargs)``
    built on the ``meta`` device, so no weights are allocated. Memoized: the
    edgewise fallback ladder asks for the same candidates many times."""
    key = (ctor, n_classes, dim, depth, heads, img_size,
           tuple(sorted((extra_kwargs or {}).items(),
                        key=lambda kv: kv[0])).__repr__())
    if key in _ESTIMATE_CACHE:
        return _ESTIMATE_CACHE[key]
    kwargs = dict(dim=dim, depth=depth, heads=heads, n_classes=n_classes)
    if extra_kwargs:
        kwargs.update(extra_kwargs)
    with torch.device("meta"):
        model = ctor(**kwargs, device="meta")
    n = count_parameters(model)
    _ESTIMATE_CACHE[key] = n
    return n


def find_config_for_target(
    ctor,
    n_classes: int,
    target_params: int,
    dims: Iterable[int] = (128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768),
    depths: Iterable[int] = (6, 8, 10, 12),
    heads_list: Iterable[int] = (4, 6, 8),
    extra_kwargs: Optional[Dict] = None,
    img_size: int = 32,
) -> Tuple[Dict[str, int], int]:
    """Grid search minimizing |target - params|."""
    best_diff, best_cfg, best_params = None, None, None
    for heads in heads_list:
        for dim in dims:
            if dim % heads != 0:
                continue
            for depth in depths:
                try:
                    p = estimate_params(
                        ctor, n_classes, dim, depth, heads, extra_kwargs, img_size
                    )
                except Exception:
                    continue
                diff = abs(int(target_params) - p)
                if best_diff is None or diff < best_diff:
                    best_diff, best_params = diff, p
                    best_cfg = {"dim": dim, "depth": depth, "heads": heads}
    if best_cfg is None:
        raise RuntimeError("Could not find a configuration close to target params.")
    return best_cfg, int(best_params)


def find_model_config_match_baseline(
    ctor,
    n_classes: int,
    target_params: int,
    baseline_cfg: Dict[str, int],
    baseline_params: int,
    max_ratio_diff: float = 0.01,
    dims_choices: Iterable[int] = tuple(range(64, 2049, 8)),
    depths_choices: Iterable[int] = (6, 8, 9, 10, 11, 12),
    heads_choices: Iterable[int] = (4, 6, 8),
    extra_kwargs: Optional[Dict] = None,
    img_size: int = 32,
) -> Tuple[Dict[str, int], int, bool]:
    """Structure-constrained matching: candidate <= baseline on every axis;
    prefer identical structure if it fits under budget; otherwise score =
    within-1%-flag*1e12 + target_diff*1e3 + (10000*dHeads + 1000*dDepth +
    dDim)."""
    base_dim, base_depth, base_heads = (
        baseline_cfg["dim"], baseline_cfg["depth"], baseline_cfg["heads"])

    dims = [d for d in dims_choices if 0 < d <= base_dim]
    if base_dim not in dims:
        dims.append(base_dim)
    depths = [d for d in depths_choices if 0 < d <= base_depth]
    if base_depth not in depths:
        depths.append(base_depth)
    heads_list = [h for h in heads_choices if 0 < h <= base_heads]
    if base_heads not in heads_list:
        heads_list.append(base_heads)

    try:
        p_same = estimate_params(
            ctor, n_classes, base_dim, base_depth, base_heads, extra_kwargs, img_size
        )
        if p_same <= baseline_params:
            rel_gap = abs(baseline_params - p_same) / max(1, baseline_params)
            return (
                {"dim": base_dim, "depth": base_depth, "heads": base_heads},
                int(p_same),
                (rel_gap <= max_ratio_diff),
            )
    except Exception:
        pass

    best_within = best_within_params = best_within_score = None
    best_under = best_under_params = best_under_score = None
    for heads in sorted(set(heads_list)):
        for depth in sorted(set(depths)):
            cand_dims = [d for d in sorted(set(dims)) if d % heads == 0]
            if not cand_dims:
                continue
            # Param count is monotonically increasing in dim (fixed depth/heads),
            # so instead of counting every dim, binary-search the boundary dims
            # (largest p <= baseline; p closest to target) and evaluate windows
            # around them. Selection-equivalent to the full scan: the score
            # strictly improves toward those boundaries (within-1%-of-baseline
            # flag, then |target - p|, then structure distance which also
            # prefers larger dim <= base_dim).
            def _p(d):
                try:
                    return estimate_params(
                        ctor, n_classes, d, depth, heads, extra_kwargs, img_size)
                except Exception:
                    return None

            def _boundary(limit):
                lo, hi = 0, len(cand_dims) - 1
                pos = -1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    pm = _p(cand_dims[mid])
                    if pm is None:
                        # fall back to linear scan on error
                        return None
                    if pm <= limit:
                        pos = mid
                        lo = mid + 1
                    else:
                        hi = mid - 1
                return pos

            window = set()
            for limit in (baseline_params, int(target_params)):
                pos = _boundary(limit)
                if pos is None:
                    window = set(range(len(cand_dims)))  # error fallback
                    break
                window.update(range(max(0, pos - 16), min(len(cand_dims), pos + 17)))
            for di in sorted(window):
                dim = cand_dims[di]
                p = _p(dim)
                if p is None:
                    continue
                if p > baseline_params:
                    continue
                rel_gap = abs(baseline_params - p) / max(1, baseline_params)
                target_diff = abs(int(target_params) - p)
                struct_penalty = (
                    10000 * abs(base_heads - heads)
                    + 1000 * abs(base_depth - depth)
                    + abs(base_dim - dim)
                )
                score = (
                    (0 if rel_gap <= max_ratio_diff else 1) * 10**12
                    + target_diff * 10**3
                    + struct_penalty
                )
                if rel_gap <= max_ratio_diff and (
                    best_within is None or score < best_within_score
                ):
                    best_within = {"dim": dim, "depth": depth, "heads": heads}
                    best_within_params, best_within_score = p, score
                if best_under is None or score < best_under_score:
                    best_under = {"dim": dim, "depth": depth, "heads": heads}
                    best_under_params, best_under_score = p, score

    if best_within is not None:
        return best_within, int(best_within_params), True
    if best_under is not None:
        return best_under, int(best_under_params), False
    raise RuntimeError("Could not find configuration under baseline budget.")


# --------------------------- training ---------------------------


def make_lr_schedule(lr: float, steps: int, warmup_frac: float) -> Callable[[int], float]:
    """``count -> lr`` for update ``count`` (0-based), as optax computes it:
    ``linear_schedule(lr * 1e-3, lr, warmup)`` joined at ``warmup`` to
    ``cosine_decay_schedule(lr, steps - warmup)``; the cosine alone when
    there is no warmup. In float32, with optax's operations in its order, so
    the values are optax's own (the warmup's first value carries float32's
    cancellation error, as it does in JAX)."""
    f32 = np.float32
    warmup_steps = int(max(steps, 1) * max(warmup_frac, 0.0))

    def cosine(count: int, decay_steps: int) -> float:
        count = min(max(count, 0), decay_steps)
        decay = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * f32(count) / f32(decay_steps)))
        return float(f32(lr) * decay)

    if warmup_steps > 0:
        init, decay_steps = lr * 1e-3, max(steps - warmup_steps, 1)

        def schedule(count: int) -> float:
            if count < warmup_steps:
                frac = f32(1.0) - f32(max(count, 0)) / f32(warmup_steps)
                return float(f32(init - lr) * frac + f32(lr))
            return cosine(count - warmup_steps, decay_steps)

        return schedule
    decay_steps = max(steps, 1)
    return lambda count: cosine(count, decay_steps)


def make_opt(params, lr: float, steps: int, warmup_frac: float, weight_decay: float
             ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """``torch.optim.AdamW`` with optax's adamw defaults (betas 0.9 / 0.999,
    eps 1e-8, decoupled decay scaled by the lr) and its schedule; the caller
    sets ``lr`` to ``schedule(count)`` before update ``count``."""
    schedule = make_lr_schedule(lr, steps, warmup_frac)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, schedule


class ModelRun:
    """One model in a lockstep comparison: the model on its device, its
    AdamW and schedule, its train step (bf16 compute, augment, ``grad_clip``),
    its fp32 eval step and a generator on the device seeded from ``seed``.

    The model comes built and initialised (the harness seeds it from
    ``seed``); it is moved to ``device`` (the GPU unless given). Under
    ``mesh`` it goes to the mesh's device with rank 0's values, and the steps
    are data parallel: each process trains and evaluates on its rows.
    """

    def __init__(self, key, model, lr, mean, std, steps, warmup_frac, weight_decay, seed,
                 grad_clip=None, augment=True, device: Device = None, mesh=None):
        self.key = key
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.model = model.to(self.device) if mesh is None else replicate(model, mesh)
        self.n_params = count_parameters(model)
        self.opt, self.schedule = make_opt(model.parameters(), lr, steps, warmup_frac,
                                           weight_decay)
        self.train_step = make_classifier_train_step(model, self.opt, mean, std,
                                                     augment=augment, grad_clip=grad_clip,
                                                     device=self.device, mesh=mesh)
        self.eval_step = make_classifier_eval_step(model, mean, std, device=self.device,
                                                   mesh=mesh)
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.count = 0  # updates so far: the schedule's step, as optax's count
        self._mean_std = (mean, std)
        self.loss_handle = None
        self.last_loss = float("nan")

    def step(self, xb, yb, step_i):
        """One update on (xb, yb). Its random draws come from the generator
        reseeded from (seed, step_i), as JAX folds step_i into its key."""
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.generator.manual_seed(step_seed(self.seed, step_i))
        m = self.train_step(torch.as_tensor(xb), torch.as_tensor(yb), self.generator)
        self.count += 1
        self.loss_handle = m["loss"]
        return m

    def sync_loss(self) -> float:
        self.last_loss = float(self.loss_handle)
        if not np.isfinite(self.last_loss):
            # Fail fast with context instead of training on NaNs until the
            # final eval.
            raise FloatingPointError(
                f"non-finite loss for model '{self.key}' "
                f"({self.n_params:,} params) — typical causes: LR too high "
                f"for this variant (try --lr_mult_e style overrides), bf16 "
                f"overflow, or bad input data."
            )
        return self.last_loss

    def _rows(self, *batch):
        """This process's rows of an eval batch (all of it without a mesh)."""
        batch = tuple(torch.as_tensor(np.asarray(a)) for a in batch)
        return batch if self.mesh is None else shard_batch(batch, self.mesh)

    def evaluate(self, batches) -> float:
        correct, total = 0.0, 0.0
        for xb, yb, mb in batches:
            c, t = self.eval_step(*self._rows(xb, yb, mb))
            correct += float(c)
            total += float(t)
        return correct / total if total else 0.0

    def per_sample_correct(self, batches) -> np.ndarray:
        """Per-sample correctness vector over an eval set (for McNemar)."""
        outs = []
        for xb, yb, mb in batches:
            c = self.predict_correct(xb, yb)
            outs.append(c[np.asarray(mb) > 0])
        return np.concatenate(outs)

    @torch.inference_mode()
    def predict_correct(self, xb, yb) -> np.ndarray:
        # fp32 on purpose: McNemar's per-sample statistics must not pick up
        # bf16 argmax flips on borderline samples.
        self.model.eval()
        mean, std = self._mean_std
        xb, yb = self._rows(xb, yb)
        x = cifar_eval_transform(xb.to(self.device), mean, std)
        logits = self.model(x).float()
        hit = logits.argmax(-1) == yb.to(self.device)
        if self.mesh is not None:  # every process's rows, in batch order
            hit = comm.gather_dim(hit.to(torch.uint8), 0, self.mesh.group(DATA_AXIS)).bool()
        return hit.cpu().numpy()

    def save(self, path: str, step: int) -> None:
        """Write the model's and the optimizer's state and the step (the main
        process only: every process holds the same)."""
        if is_main_process():
            save_checkpoint(path, self.model.state_dict(), opt_state=self.opt.state_dict(),
                            step=step, loss=self.last_loss)

    def load(self, path: str) -> int:
        payload = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(payload["state_dict"])
        self.opt.load_state_dict(payload["opt_state"])
        self.count = int(payload["step"])
        return self.count


def lockstep_train(
    runs: Dict[str, ModelRun],
    train_iter,
    val_batches_fn,
    steps: int,
    eval_every: int,
    log=print,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    mesh=None,
):
    """Lockstep multi-model training on identical batches; under ``mesh``
    each process steps on its rows of every batch.

    With ``ckpt_dir``/``ckpt_every``: periodic per-model checkpoints; with
    ``resume``: restart from the smallest step restored. When ``ckpt_dir`` is
    set the loop is also preemption-safe: SIGTERM checkpoints every model at
    the next step boundary and exits with code 75, so re-running the same
    command with ``--resume`` continues the run.
    Returns per-model history {key: {'steps': [...], 'acc': [...],
    'loss': [...]}}: at each eval step, the val accuracy and the step's loss.
    """
    hist = {k: {"steps": [], "acc": [], "loss": []} for k in runs}
    start_step = 1
    if ckpt_dir and resume:
        restored = []
        for k, run in runs.items():
            path = os.path.join(ckpt_dir, f"{k}.ckpt")
            if os.path.exists(path):
                restored.append(run.load(path))
        if restored:
            start_step = min(restored) + 1
            log(f"resumed from step {start_step - 1}")
    guard = PreemptionGuard().install() if ckpt_dir else None
    device = next(iter(runs.values())).device

    def _save_all(step_i):
        os.makedirs(ckpt_dir, exist_ok=True)
        for k, run in runs.items():
            run.save(os.path.join(ckpt_dir, f"{k}.ckpt"), step_i)
        if mesh is not None and mesh.device_mesh is not None:
            torch.distributed.barrier()  # written before any process goes on

    try:
        for step_i in range(start_step, steps + 1):
            xb, yb = next(train_iter)
            # One copy to the device for every run (this process's rows).
            if mesh is not None:
                xb, yb = shard_batch((np.asarray(xb), np.asarray(yb)), mesh)
            else:
                xb, yb = (torch.from_numpy(np.asarray(a)).to(device) for a in (xb, yb))
            for run in runs.values():
                run.step(xb, yb, step_i)
            if step_i % max(eval_every, 1) == 0 or step_i == 1:
                loss_str = " ".join(
                    f"L{k}={r.sync_loss():.3f}" for k, r in runs.items()
                )
                accs = []
                for k, r in runs.items():
                    a = r.evaluate(val_batches_fn())
                    hist[k]["steps"].append(step_i)
                    hist[k]["acc"].append(a)
                    hist[k]["loss"].append(r.last_loss)
                    accs.append(f"A{k}={a:.3f}")
                log(f"step {step_i:4d} | {loss_str} | {' '.join(accs)}")
            if ckpt_dir and ckpt_every and step_i % ckpt_every == 0:
                _save_all(step_i)
            if guard is not None and guard.preempted:
                for r in runs.values():
                    r.sync_loss()  # host barrier: the steps really landed
                _save_all(step_i)
                log(f"preempted at step {step_i}: checkpointed to "
                    f"{ckpt_dir}, exiting {PREEMPTED_EXIT_CODE} "
                    f"(re-run with --resume)")
                sys.exit(PREEMPTED_EXIT_CODE)
    finally:
        if guard is not None:
            guard.uninstall()
    return hist


# --------------------------- statistics ---------------------------


def mcnemar(correct_a: np.ndarray, correct_b: np.ndarray) -> Dict[str, float]:
    """McNemar test on paired per-sample correctness.

    n01 = A right, B wrong; n10 = A wrong, B right;
    chi2 with continuity correction.
    """
    a = np.asarray(correct_a, bool)
    b = np.asarray(correct_b, bool)
    n01 = int(np.sum(a & ~b))
    n10 = int(np.sum(~a & b))
    denom = n01 + n10
    chi2 = ((abs(n01 - n10) - 1) ** 2 / denom) if denom > 0 else 0.0
    return {"mcnemar_n01": n01, "mcnemar_n10": n10, "mcnemar_chi2": float(chi2)}


def bootstrap_delta(correct_a, correct_b, n_boot: int = 1000, seed: int = 0):
    """Mean accuracy delta (B - A) with a bootstrap 95% interval."""
    a = np.asarray(correct_a, np.float64)
    b = np.asarray(correct_b, np.float64)
    rng = np.random.RandomState(seed)
    n = len(a)
    deltas = np.empty(n_boot)
    for i in range(n_boot):
        idx = rng.randint(0, n, n)
        deltas[i] = b[idx].mean() - a[idx].mean()
    return {
        "delta_acc_mean": float(b.mean() - a.mean()),
        "delta_acc_lo": float(np.percentile(deltas, 2.5)),
        "delta_acc_hi": float(np.percentile(deltas, 97.5)),
    }


# ----------------------------- output -----------------------------


def save_csv(path: str, header: List[str], rows: List[List]) -> None:
    if not is_main_process():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")


def save_val_curve_plot(path, hist, title):
    if not is_main_process():
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 5))
    for key, h in hist.items():
        if h["steps"]:
            plt.plot(h["steps"], h["acc"], label=key)
    plt.xlabel("Step")
    plt.ylabel("Val Accuracy")
    plt.title(title)
    plt.legend()
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def save_test_bar_plot(path, labels, vals, title):
    if not is_main_process():
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(6, 4))
    plt.bar(labels, vals)
    plt.ylim(0, 1)
    plt.ylabel("Test Accuracy")
    plt.title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
