"""Device selection for the port's entry points."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def process_cuda_device() -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK`` under a process group
    (one process drives one card, and torchrun numbers them per node), else
    ``cuda``, the current card."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the given one, else this process's
    GPU (``process_cuda_device``). A bare ``"cuda"`` also names this
    process's card; an indexed one is taken as given.

    Raises when no device is given and no GPU is present; a run on the CPU
    is asked for with ``device="cpu"``.
    """
    if device is not None:
        device = torch.device(device)
        return process_cuda_device() if device.type == "cuda" and device.index is None \
            else device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return process_cuda_device()
