"""Training utilities of the port: seeding, parameter counts, checkpoints,
the parameter EMA and the preemption guard."""

from .preemption import PREEMPTED_EXIT_CODE, PreemptionGuard
from .utils import count_params, ema_update, load_checkpoint, save_checkpoint, set_seed

__all__ = [
    "set_seed",
    "count_params",
    "save_checkpoint",
    "load_checkpoint",
    "ema_update",
    "PreemptionGuard",
    "PREEMPTED_EXIT_CODE",
]
