"""NaN / Inf guards of the port, the counterpart of ``mop_tpu/utils/debug.py``.

``tree_isfinite`` checks tensors, nested containers, modules and optimizers
on the device; ``guard_nans`` and ``check_finite`` fail fast on the host;
``checkify_step`` runs a step under autograd's anomaly mode, the eager
counterpart of ``jax.experimental.checkify``: it raises naming the op whose
backward made a non-finite value.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def _float_tensors(tree) -> List[torch.Tensor]:
    if hasattr(tree, "state_dict"):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() or tree.is_complex() else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _float_tensors(v)]
    return []


def tree_isfinite(tree) -> torch.Tensor:
    """0-d bool tensor: every float tensor in ``tree`` (a tensor, a nested
    dict / list / tuple, a module's or an optimizer's state) is finite.
    Computed on the tensors' device; reading it waits for that device."""
    flags = [torch.isfinite(t).all() for t in _float_tensors(tree)]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


def guard_nans(step_fn: Callable, params=None) -> Callable:
    """Wrap a step so that it also returns a finite-flag over its outputs
    and, where given, ``params`` (the model or optimizer it updates in
    place: the port's steps return only their metrics, where the JAX steps
    return their params too). Callers pass the flag to ``check_finite``."""

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        return out, tree_isfinite([out] if params is None else [out, params])

    return wrapped


def check_finite(flag, context: str = "train step") -> None:
    """Host-side assertion on a ``guard_nans`` flag."""
    if not bool(flag):
        raise FloatingPointError(
            f"non-finite values detected in {context} outputs — "
            "stop and inspect (lr too high, bad data, or overflow in bf16)."
        )


def checkify_step(step_fn: Callable) -> Callable:
    """Run ``step_fn`` under ``torch.autograd.detect_anomaly(check_nan=True)``:
    a backward that makes NaN raises naming its op, with the forward's
    traceback. A debugging tool: anomaly mode slows every op."""

    def wrapped(*args, **kwargs):
        with torch.autograd.detect_anomaly(check_nan=True):
            return step_fn(*args, **kwargs)

    return wrapped
