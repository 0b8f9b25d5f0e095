"""Training utilities of the port: the counterpart of
``mop_tpu/training/utils.py``.

- ``cosine_lr`` (the JAX schedule, value for value), ``set_seed``,
  ``count_params``, ``print_model_info``, ``format_time``,
  ``AverageMeter``, ``EarlyStopping`` and ``ema_update``;
- checkpoints: ``save_checkpoint`` / ``load_checkpoint`` (one file,
  {step, state_dict, opt_state, loss, extra}), and the step-directory format
  of ``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` and
  ``AsyncCheckpointManager`` ({params[, opt_state][, extra]} under
  ``<dir>/<step>/``, written with ``torch.save``); a sharded model's (FSDP,
  ZeRO-1, tensor parallel, a pipeline stage) through
  ``torch.distributed.checkpoint`` instead, every process writing its shards
  (``parallel.checkpoint``), and ``restore_checkpoint_sharded`` /
  ``restore(..., shardings=)`` read either into another layout.
"""

from __future__ import annotations

import concurrent.futures
import copy
import ctypes
import ctypes.util
import os
import random
import shutil
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel import checkpoint as ckpt


def set_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators, and return a
    CPU ``torch.Generator`` seeded with ``seed`` (the port's draws come from
    explicit generators, as the JAX package's from the key it returns)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _cosf() -> Callable[[float], float]:
    """The C library's float32 cosine, ``cosf``: the one XLA's CPU backend
    calls for a float32 ``cos``. numpy's float32 ``cos`` (its own SIMD code)
    differs from it in the last place at about one argument in six."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cosine_lr(base_lr: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """Linear warmup from 0, then cosine decay to 0: ``step -> lr``. The
    JAX schedule's arithmetic in float32, in its order and with its
    ``cosf``, so that both give the same value at every step."""
    f32 = np.float32
    cosf = _cosf()
    warm_div = f32(max(1.0, warmup_steps))
    decay_div = f32(max(1.0, total_steps - warmup_steps))
    half_lr = f32(0.5 * base_lr)  # 0.5 * base_lr is a Python product in JAX too

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(base_lr) * step / warm_div)
        progress = np.clip((step - f32(warmup_steps)) / decay_div, f32(0.0), f32(1.0))
        return float(half_lr * (f32(1.0) + f32(cosf(f32(np.pi) * progress))))

    return schedule


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's generator, (seed, step) mixed into one integer:
    the port's counterpart of JAX's ``fold_in(key(seed), step)`` (other
    numbers, the same property: a step's draws depend on the seed and the
    step alone, so a resumed run draws what an uninterrupted one draws)."""
    return int(seed) * 1_000_003 + int(step)


def count_params(model: nn.Module) -> int:
    """Number of parameters of ``model`` (on any device, ``meta`` included)."""
    return sum(p.numel() for p in model.parameters())


def print_model_info(name: str, model: nn.Module) -> None:
    n = count_params(model)
    print(f"{name}: {n:,} trainable params ({n / 1e6:.2f}M)")


def format_time(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    if h:
        return f"{h}h {m}m {s}s"
    if m:
        return f"{m}m {s}s"
    return f"{s}s"


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], opt_state=None,
                    step: int = 0, loss: float = 0.0, extra=None) -> None:
    """Write {step, state_dict, opt_state, loss, extra} with ``torch.save``:
    the model's and the optimizer's state dicts (``opt_state``, may be
    None) and what the caller adds in ``extra``. The file is written under
    a temporary name and renamed, so a reader never sees half of it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"step": int(step), "state_dict": state_dict, "opt_state": opt_state,
               "loss": float(loss), "extra": extra}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, Any]:
    """Read a ``save_checkpoint`` payload. Only tensors and plain containers
    are unpickled (``weights_only``), so ``extra`` holds those."""
    return torch.load(path, map_location=map_location, weights_only=True)


@torch.no_grad()
def ema_update(ema: Iterable[torch.Tensor], params: Iterable[torch.Tensor], decay: float):
    """Shadow-parameter EMA step, in place on the shadow copy: each ``e``
    of ``ema`` becomes ``decay * e + (1 - decay) * p`` for its ``p`` of
    ``params`` (two sequences in one order, e.g. an EMA model's and the
    model's ``parameters()``). Returns ``ema``."""
    ema = list(ema)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, list(params), alpha=1.0 - decay)
    return ema


# ------------------------- step-directory checkpoints -------------------------

_PAYLOAD = "checkpoint.pt"


def _state(obj):
    """A module's or an optimizer's state dict; anything else as it is."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _to_host(tree):
    """A copy of ``tree`` whose tensors are new CPU tensors: a snapshot that
    later updates of the originals do not reach."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return copy.deepcopy(tree)


def _like(tree, like):
    """``tree`` on ``like``'s devices and dtypes, tensor by tensor."""
    if isinstance(tree, torch.Tensor) and isinstance(like, torch.Tensor):
        return tree.to(like.device, like.dtype)
    if isinstance(tree, dict) and isinstance(like, dict):
        return {k: _like(v, like[k]) if k in like else v for k, v in tree.items()}
    return tree


def _restore_into(payload: Dict[str, Any], like: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``payload`` read against ``like``: a module or an optimizer under a
    key of ``like`` loads its entry in place and stands in the result; a
    dict of tensors gets the entry on its tensors' devices and dtypes."""
    if like is None:
        return payload
    out = dict(payload)
    for key, target in like.items():
        if key not in payload or target is None:
            continue
        if hasattr(target, "load_state_dict"):
            target.load_state_dict(payload[key])
            out[key] = target
        else:
            out[key] = _like(payload[key], target)
    return out


def _write_step_dir(path: str, payload: Dict[str, Any]) -> None:
    """``payload`` into ``path/checkpoint.pt``, written under a temporary
    directory that is renamed when whole, so a reader never sees half of it.
    An existing ``path`` is replaced."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, _PAYLOAD))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _read_step_dir(path: str, like=None, shardings=None) -> Dict[str, Any]:
    """A step directory into ``like``: a sharded one (``parallel.checkpoint``)
    read into its targets' layouts, a ``torch.save`` one loaded, and placed
    into sharded targets when ``shardings`` names their layouts."""
    path = os.path.abspath(path)
    if ckpt.is_sharded_checkpoint(path):
        if like is None or like.get("params") is None:
            raise ValueError("a sharded checkpoint restores into targets: pass like={'params': "
                             "model[, 'opt_state': optimizer]}")
        return ckpt.restore_sharded(path, like, shardings)
    payload = torch.load(os.path.join(path, _PAYLOAD), map_location="cpu", weights_only=True)
    if like is not None and like.get("params") is not None and (
            shardings is not None or ckpt.is_sharded(like["params"])):
        return ckpt.place_whole(payload, like, shardings)
    return _restore_into(payload, like)


def save_checkpoint_orbax(path: str, params, opt_state=None, step: int = 0) -> None:
    """Write {step, params[, opt_state]} synchronously into the directory
    ``path``, in ``AsyncCheckpointManager``'s step-directory format.

    The name is the JAX package's, kept so that callers find it; no orbax is
    involved: the payload is written with ``torch.save``, or, for a sharded
    model or optimizer (FSDP, ZeRO-1, tensor parallel, a pipeline stage),
    with ``torch.distributed.checkpoint``, every process writing its shards
    with their place in the global tensor (every process calls it then).
    ``params`` and ``opt_state`` are modules, optimizers or their state
    dicts (a sharded model's tensors: a module or a dict of tensors)."""
    if ckpt.is_sharded(params, opt_state):
        ckpt.save_sharded(path, params, opt_state, step)
        return
    payload = {"step": int(step), "params": _to_host(_state(params))}
    if opt_state is not None:
        payload["opt_state"] = _to_host(_state(opt_state))
    _write_step_dir(path, payload)


def load_checkpoint_orbax(path: str, like=None) -> Dict[str, Any]:
    """Read a ``save_checkpoint_orbax`` directory (no orbax: ``torch.load``,
    or ``torch.distributed.checkpoint`` for a sharded one). ``like``, a dict
    over the payload's keys, loads a module or an optimizer in place and
    puts a state dict's tensors on its devices and dtypes; a sharded
    checkpoint reads into its targets' own layouts."""
    return _read_step_dir(path, like)


def restore_checkpoint_sharded(path: str, like: Dict[str, Any], shardings: Dict[str, Any]
                               ) -> Dict[str, Any]:
    """Restore a checkpoint directly into a distributed layout.

    ``like``: ``{"params": model (or a dict of tensors)[, "opt_state":
    optimizer]}``, the targets, already in the layout to restore into (a
    model through ``fsdp_shard_params`` or ``tp_shard_params``, or whole);
    ``shardings``: ``{"params": {name: Sharding}}`` (``fsdp_param_shardings``,
    ``tp_param_shardings``, ``replicated``), each target tensor's layout
    (default: its own ``sharding``). The layout need not be the one the
    checkpoint was saved under: save from FSDP, restore onto a
    tensor-parallel mesh of another shape, or whole; each process reads the
    parts of the saved shards that its tensors hold, and the optimizer's
    moments follow their parameters. Returns ``like`` with ``step``. Every
    process calls it."""
    return _read_step_dir(path, like, shardings)


class AsyncCheckpointManager:
    """Step-indexed checkpoints written in the background, with retention.

    ``save(step, params, opt_state=None, extra=None)`` copies the state to
    host memory and returns; a worker thread writes it with ``torch.save``
    into ``<directory>/<step>/`` while training goes on. A step directory
    appears only when whole (written under a temporary name, then renamed),
    and after each write only the ``keep`` newest steps stay.
    ``latest_step`` and ``all_steps`` list the whole checkpoints on disk;
    ``restore`` waits for the saves in flight first. ``params`` and
    ``opt_state`` are modules, optimizers or their state dicts.

    The counterpart of the JAX package's orbax manager. A sharded model's
    save (every process calls it) is written through
    ``torch.distributed.checkpoint`` when it is called, each process its
    shards, and only the retention runs behind; ``restore(...,
    shardings=...)`` reads into another layout (``restore_checkpoint_sharded``).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        _write_step_dir(os.path.join(self.directory, str(step)), payload)
        self._retain()

    def _retain(self) -> None:
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def save(self, step: int, params, opt_state=None, extra=None) -> None:
        if ckpt.is_sharded(params, opt_state):
            if extra is not None:
                raise ValueError("a sharded save takes no extra")
            self.wait_until_finished()
            ckpt.save_sharded(os.path.join(self.directory, str(int(step))), params, opt_state,
                              step)
            if not dist.is_initialized() or dist.get_rank() == 0:
                self._pending.append(self._pool.submit(self._retain))
            return
        payload = {"params": _to_host(_state(params))}
        if opt_state is not None:
            payload["opt_state"] = _to_host(_state(opt_state))
        if extra is not None:
            payload["extra"] = _to_host(extra)
        self._pending.append(self._pool.submit(self._write, int(step), payload))

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like=None, shardings=None) -> Dict[str, Any]:
        """The payload of ``step`` (default: the latest). ``like`` as in
        ``load_checkpoint_orbax``: e.g. ``{"params": model, "opt_state":
        optimizer}`` loads both in place; with ``shardings`` (or a sharded
        checkpoint) into the targets' layouts, as ``restore_checkpoint_sharded``."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints saved yet under {self.directory}")
        return _read_step_dir(os.path.join(self.directory, str(step)), like, shardings)

    def is_saving(self) -> bool:
        """True while a save is still being written."""
        return any(not f.done() for f in self._pending)

    def wait_until_finished(self) -> None:
        """Block until every save has been written; a failed write raises here."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait_until_finished()
        self._pool.shutdown()

    def __enter__(self) -> "AsyncCheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------ meters ------------------------------


class AverageMeter:
    """Running average tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)


class EarlyStopping:
    """Patience-based early stopping that keeps a copy of the best weights
    (``best_params``, a CPU copy of the state dict) when ``restore_best``."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0, restore_best: bool = True):
        self.patience = patience
        self.min_delta = min_delta
        self.restore_best = restore_best
        self.best: Optional[float] = None
        self.best_params = None
        self.counter = 0
        self.should_stop = False

    def step(self, metric: float, params) -> bool:
        """``params``: the model or its state dict."""
        if self.best is None or metric > self.best + self.min_delta:
            self.best = metric
            self.counter = 0
            if self.restore_best:
                self.best_params = _to_host(_state(params))
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
