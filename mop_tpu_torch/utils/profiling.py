"""Profiling and throughput instrumentation of the port, the counterpart of
``mop_tpu/utils/profiling.py``: ``torch.profiler`` traces of the host and
the device, named spans, a throughput meter that synchronizes the device
before it reads the clock, and the card's peak bf16 rate for MFU."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

# Dense bf16 peak FLOP/s by ``torch.cuda.get_device_name()`` (NVIDIA's data
# sheet, without sparsity, at the card's full power limit).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM, 700 W
}


def chip_peak_bf16_flops() -> Optional[float]:
    """Peak bf16 FLOP/s of CUDA device 0; None with no card or an unknown one."""
    if not torch.cuda.is_available():
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(0))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler``, host (CPU) and device (CUDA,
    where there is a card) activities, and write the Chrome trace to
    ``<log_dir>/trace.json``. Yields the profiler (``key_averages()``,
    ``events()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span on the profiler's timeline."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Step and sample throughput, the first ``warmup_steps`` steps left out.

    ``step(n)`` after each step; the clock starts when the warmup's last
    step is recorded. Once the process has touched a card, the meter
    synchronizes it before each read of the clock: the host runs ahead of
    the card, and without the barrier the meter would time the launches.
    """

    def __init__(self, warmup_steps: int = 5):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self._steps = 0
        self._samples = 0
        self._t0: Optional[float] = None

    def _now(self) -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return time.perf_counter()

    def step(self, n_samples: int):
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._t0 = self._now()
            self._samples = 0
        elif self._steps > self.warmup_steps:
            self._samples += n_samples

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._steps <= self.warmup_steps:
            return 0.0
        dt = self._now() - self._t0
        return (self._steps - self.warmup_steps) / max(dt, 1e-9)

    @property
    def samples_per_sec(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = self._now() - self._t0
        return self._samples / max(dt, 1e-9)

    def per_chip(self, value: float) -> float:
        """``value`` over the visible CUDA devices (at least one)."""
        return value / max(1, torch.cuda.device_count())
