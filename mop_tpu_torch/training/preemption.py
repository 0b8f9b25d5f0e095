"""Preemption-safe training: a kill signal deferred to the next step boundary.

The port of ``PreemptionGuard`` from ``mop_tpu/training/preemption.py``.
Spot and maintenance shutdowns send SIGTERM with a grace window before the
hard kill; the guard turns the signal into a flag that the training loop
reads once a step (``preempted``), so the loop checkpoints at a step
boundary and exits with ``PREEMPTED_EXIT_CODE`` (75, EX_TEMPFAIL: "try again
later"), and the same command with ``--resume`` continues from there
(``experiments.common.lockstep_train``).
"""

from __future__ import annotations

import signal
import threading
from typing import Sequence

__all__ = ["PreemptionGuard", "PREEMPTED_EXIT_CODE"]

PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL


class PreemptionGuard:
    """Sets a flag on a kill signal, for the loop to act on at a step boundary.

    ``signals`` defaults to SIGTERM only: Ctrl-C stays an immediate
    KeyboardInterrupt unless SIGINT is added. Handlers installed before are
    chained (called after the flag is set) and restored by ``uninstall()``
    or on leaving the context.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False

    def _handler(self, signum, frame):
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        for s in self._signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def signal_now(self) -> None:
        """Set the flag without a signal (a cooperative shutdown, a watchdog
        thread or a test)."""
        self._event.set()
