"""Preemption-safe training: a kill signal deferred to the next step boundary.

The port of ``mop_tpu/training/preemption.py``. Spot and maintenance
shutdowns send SIGTERM with a grace window before the hard kill; the guard
turns the signal into a flag that the training loop reads once a step, so
the loop checkpoints at a step boundary and exits with
``PREEMPTED_EXIT_CODE`` (75, EX_TEMPFAIL: "try again later"), and the same
command resumes from there. With a manager (an ``AsyncCheckpointManager``)
the guard saves itself::

    mgr = AsyncCheckpointManager(ckpt_dir, keep=2)
    with PreemptionGuard(mgr) as guard:
        start, model, opt = resume_latest(mgr, model, opt)
        for step in range(start, total_steps):
            train_step(...)
            guard.maybe_checkpoint_and_exit(step + 1, model, opt)

Without one the loop reads ``preempted`` and saves as it likes
(``experiments.common.lockstep_train``).
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Optional, Sequence, Tuple

__all__ = ["PreemptionGuard", "resume_latest", "PREEMPTED_EXIT_CODE"]

PREEMPTED_EXIT_CODE = 75  # EX_TEMPFAIL


class PreemptionGuard:
    """Sets a flag on a kill signal; with a ``manager``, checkpoints at a
    step boundary and exits.

    ``manager`` is an ``AsyncCheckpointManager`` or anything with
    ``save(step, params, opt_state=..., extra=...)`` and
    ``wait_until_finished()``. ``signals`` defaults to SIGTERM only: Ctrl-C
    stays an immediate KeyboardInterrupt unless SIGINT is added. Handlers
    installed before are chained (called after the flag is set) and
    restored by ``uninstall()`` or on leaving the context.
    """

    def __init__(self, manager=None, signals: Sequence[int] = (signal.SIGTERM,),
                 exit_code: int = PREEMPTED_EXIT_CODE):
        self._manager = manager
        self._signals = tuple(signals)
        self._exit_code = exit_code
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

    def checkpoint_and_exit(self, step: int, params, opt_state=None, extra=None) -> None:
        """Save synchronously (the write lands before the exit: the grace
        window is for this) and exit with the preempted status. The save's
        copy to the host waits for the device's pending work."""
        if self._manager is not None:
            self._manager.save(step, params, opt_state=opt_state, extra=extra)
            self._manager.wait_until_finished()
        sys.exit(self._exit_code)

    def maybe_checkpoint_and_exit(self, step: int, params, opt_state=None, extra=None) -> None:
        """One branch per step: nothing until a signal has arrived."""
        if self._event.is_set():
            self.checkpoint_and_exit(step, params, opt_state=opt_state, extra=extra)


def resume_latest(manager, model_or_state, opt_state=None) -> Tuple[int, object, Optional[object]]:
    """Resume from ``manager``'s latest checkpoint, if one exists.

    Returns ``(start_step, model_or_state, opt_state)``. A module or an
    optimizer passed in loads the checkpoint in place and is returned; a
    state dict passed in is replaced by the saved one, on its tensors'
    devices and dtypes. With no checkpoint on disk the arguments come back
    unchanged at step 0.
    """
    step = manager.latest_step()
    if step is None:
        return 0, model_or_state, opt_state
    like = {"params": model_or_state}
    if opt_state is not None:
        like["opt_state"] = opt_state
    restored = manager.restore(step, like=like)
    return step, restored["params"], restored.get("opt_state", opt_state)
