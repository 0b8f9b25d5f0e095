"""Step-based trainer of the port: the counterpart of
``mop_tpu/training/trainer.py`` (``Trainer`` and ``train_model``).

The model, its AdamW and its train and eval steps live on one device (the
GPU unless given). Parameters and optimizer state are updated in place, so
where the JAX methods return new params and optimizer state the port's
return only their metrics. Random draws (augment, drop-path) come from a
generator on the device reseeded before every step from (seed, step), as
JAX folds the step into its key, so a resumed run draws what an
uninterrupted one draws.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch import nn

from ..models.layers import init_params
from ..ops.preprocess import CIFAR10_MEAN, CIFAR10_STD
from ..parallel import make_classifier_eval_step, make_classifier_train_step
from ..utils.device import resolve_device
from .preemption import PreemptionGuard, resume_latest
from .utils import AsyncCheckpointManager, cosine_lr, step_seed

Device = Optional[Union[str, torch.device]]


class Trainer:
    """Trains an image classifier on one device.

    ``use_amp`` computes the train step in bf16 (fp32 grads and updates);
    evaluation is always fp32. ``augment`` is the CIFAR random crop and flip
    on the device; ``grad_clip`` clips the grads' global norm.
    """

    def __init__(self, model: nn.Module, device: Device = None, use_amp: bool = True,
                 mean=CIFAR10_MEAN, std=CIFAR10_STD, augment: bool = True,
                 grad_clip: Optional[float] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.compute_dtype = torch.bfloat16 if use_amp else None
        self.mean, self.std = mean, std
        self.augment = augment
        self.grad_clip = grad_clip
        self.generator = torch.Generator(device=self.device)
        self.optimizer: Optional[torch.optim.AdamW] = None
        self.schedule: Optional[Callable[[int], float]] = None
        self.count = 0  # updates so far: the schedule's step, as optax's count
        self._train_step = None
        # Eval always fp32: accuracy must not pick up bf16 argmax flips.
        self._eval_step = make_classifier_eval_step(model, mean, std, compute_dtype=None,
                                                    device=self.device)

    def init(self, generator: torch.Generator, sample_shape=(2, 3, 32, 32)) -> nn.Module:
        """Redraw the model's parameters from ``generator`` (a CPU generator:
        the draws are the same whatever the device) and check its logits on
        a zero batch of ``sample_shape``. Returns the model."""
        init_params(self.model.to("cpu"), generator)
        self.model.to(self.device)
        with torch.no_grad():
            was_training = self.model.training
            out = self.model.eval()(torch.zeros(sample_shape, device=self.device))
            self.model.train(was_training)
        if out.ndim != 2 or out.shape[0] != sample_shape[0]:
            raise ValueError(f"expected (batch, classes) logits, got {tuple(out.shape)}")
        return self.model

    def setup_optimizer(self, learning_rate: Union[float, Callable[[int], float]],
                        weight_decay: float = 1e-4) -> torch.optim.AdamW:
        """``torch.optim.AdamW`` over the model's parameters with
        ``optax.adamw``'s defaults (betas 0.9 / 0.999, eps 1e-8, weight decay
        1e-4, decoupled and scaled by the lr); ``learning_rate`` is a number
        or a ``step -> lr`` schedule (``cosine_lr``), applied as optax applies
        it: update ``count`` (0-based) uses ``schedule(count)``. Builds the
        train step and returns the optimizer."""
        self.schedule = learning_rate if callable(learning_rate) else None
        lr = self.schedule(0) if self.schedule else float(learning_rate)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=lr, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay)
        self._train_step = make_classifier_train_step(
            self.model, self.optimizer, self.mean, self.std, augment=self.augment,
            grad_clip=self.grad_clip, compute_dtype=self.compute_dtype, device=self.device)
        self.count = 0
        return self.optimizer

    def step(self, xb, yb, seed: int, step_i: int) -> Dict[str, torch.Tensor]:
        """One update on the batch (uint8 NCHW images, int labels): the
        schedule's lr at this update, the generator reseeded from (seed,
        step_i). Returns the step's ``{"loss", "acc"}`` on the device."""
        if self._train_step is None:
            raise RuntimeError("call setup_optimizer before training")
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.count)
        self.generator.manual_seed(step_seed(seed, step_i))
        m = self._train_step(torch.as_tensor(xb), torch.as_tensor(yb), self.generator)
        self.count += 1
        return m

    def train_epoch(self, train_batches: Iterable, seed: int, steps_per_epoch: int,
                    epoch: int = 1, total_epochs: int = 1, log_interval: int = 100
                    ) -> Dict[str, float]:
        """One epoch of ``steps_per_epoch`` batches; step ``i`` draws from
        (seed, epoch * 100_000 + i), as JAX folds ``epoch * 100_000 + i``
        into its key. Returns {"loss": mean loss, "accuracy": mean accuracy
        in percent}."""
        total_loss, total_acc, seen = 0.0, 0.0, 0
        it = iter(train_batches)
        for step_i in range(steps_per_epoch):
            xb, yb = next(it)
            m = self.step(xb, yb, seed, epoch * 100_000 + step_i)
            loss = float(m["loss"])
            total_loss += loss
            total_acc += float(m["acc"])
            seen += 1
            if log_interval and step_i % log_interval == 0:
                print(f"Epoch {epoch}/{total_epochs} step {step_i}/{steps_per_epoch} "
                      f"loss {loss:.6f}")
        return {"loss": total_loss / max(1, seen), "accuracy": 100.0 * total_acc / max(1, seen)}

    def evaluate(self, eval_batches: Iterable) -> Dict[str, float]:
        """Accuracy over ``(x, y, valid_mask)`` batches, padding masked out:
        {"accuracy" (percent), "correct", "total"}."""
        correct, total = 0.0, 0.0
        for xb, yb, mb in eval_batches:
            c, t = self._eval_step(torch.as_tensor(xb), torch.as_tensor(yb), torch.as_tensor(mb))
            correct += float(c)
            total += float(t)
        return {"accuracy": 100.0 * correct / max(1.0, total), "correct": correct,
                "total": total}


def train_model(
    model: nn.Module,
    train_iter,
    val_batches_fn,
    steps: int,
    batch_size: int = 128,
    lr: float = 3e-3,
    weight_decay: float = 0.05,
    warmup_frac: float = 0.05,
    eval_every: int = 0,
    seed: int = 0,
    device: Device = None,
    mean=CIFAR10_MEAN,
    std=CIFAR10_STD,
    augment: bool = True,
    grad_clip: Optional[float] = None,
    verbose: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
):
    """Step-based training run: the model's parameters redrawn from
    ``seed``, AdamW with ``cosine_lr`` (warmup ``max(1, steps *
    warmup_frac)``), ``steps`` batches from ``train_iter`` and a val
    accuracy every ``eval_every`` steps. Returns ``(model, history)``,
    history {"train_loss", "val_acc", "time_min"}. ``batch_size`` is the
    batches' size; the iterator sets it.

    With ``ckpt_dir``: background checkpoints every ``ckpt_every`` steps,
    and the run is preemption-safe: SIGTERM checkpoints at the next step
    boundary and exits with code 75, and a relaunch with ``resume=True``
    continues from the saved step, its batches given by ``train_iter`` from
    that step on. The resumed run equals the uninterrupted one bit for bit
    on the CPU; on the GPU only where the caller has turned on deterministic
    algorithms (``torch.backends.cudnn.deterministic = True`` and
    ``torch.use_deterministic_algorithms(True)``), else it is close but may
    differ in the last bits. The run is on ``device``, the GPU unless given.
    """
    trainer = Trainer(model, device=device, mean=mean, std=std, augment=augment,
                      grad_clip=grad_clip)
    trainer.init(torch.Generator().manual_seed(seed))
    warmup = max(1, int(steps * warmup_frac))
    opt = trainer.setup_optimizer(cosine_lr(lr, warmup, steps), weight_decay=weight_decay)

    start_step, mgr, guard = 0, None, None
    if ckpt_dir:
        mgr = AsyncCheckpointManager(ckpt_dir, keep=2)
        guard = PreemptionGuard(mgr).install()
        if resume:
            start_step, _, _ = resume_latest(mgr, trainer.model, opt)
            trainer.count = start_step
            if start_step and verbose:
                print(f"resumed from step {start_step}")

    history = {"train_loss": [], "val_acc": [], "time_min": []}
    best_acc, t0 = 0.0, time.time()
    try:
        for step_i in range(start_step, steps):
            xb, yb = next(train_iter)
            m = trainer.step(xb, yb, seed, step_i)
            loss = float(m["loss"])  # the host waits for the step here
            if verbose and step_i % 100 == 0:
                print(f"step {step_i}/{steps} loss {loss:.4f}")
            history["train_loss"].append(loss)
            if eval_every and (step_i + 1) % eval_every == 0:
                acc = trainer.evaluate(val_batches_fn())["accuracy"]
                history["val_acc"].append(acc)
                best_acc = max(best_acc, acc)
                if verbose:
                    print(f"  val acc {acc:.2f}% (best {best_acc:.2f}%)")
            if mgr is not None and ckpt_every and (step_i + 1) % ckpt_every == 0:
                mgr.save(step_i + 1, trainer.model, opt_state=opt)
            if guard is not None:
                guard.maybe_checkpoint_and_exit(step_i + 1, trainer.model, opt_state=opt)
    finally:
        if guard is not None:
            guard.uninstall()
        if mgr is not None:
            mgr.close()
    history["time_min"].append((time.time() - t0) / 60.0)
    return trainer.model, history
