"""Training utilities of the port: the part of ``mop_tpu/training/utils.py``
that the experiment harness uses (``set_seed``, ``count_params`` and the
checkpoint payload {step, state_dict, opt_state, loss, extra})."""

from __future__ import annotations

import os
import random
from typing import Any, Dict, Union

import numpy as np
import torch
from torch import nn


def set_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators, and return a
    CPU ``torch.Generator`` seeded with ``seed`` (the port's draws come from
    explicit generators, as the JAX package's from the key it returns)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def count_params(model: nn.Module) -> int:
    """Number of parameters of ``model`` (on any device, ``meta`` included)."""
    return sum(p.numel() for p in model.parameters())


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
