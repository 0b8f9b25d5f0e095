"""Training utilities of the port: seeding, parameter counts, checkpoints and
the preemption guard."""

from .preemption import PREEMPTED_EXIT_CODE, PreemptionGuard
from .utils import count_params, load_checkpoint, save_checkpoint, set_seed

__all__ = [
    "set_seed",
    "count_params",
    "save_checkpoint",
    "load_checkpoint",
    "PreemptionGuard",
    "PREEMPTED_EXIT_CODE",
]
