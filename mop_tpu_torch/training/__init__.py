"""Training utilities of the port: seeding, parameter counts, checkpoints,
the parameter EMA, the preemption guard and LoRA adapters."""

from .lora import (lora_init, lora_merge, lora_param_count, lora_parameters,
                   make_lora_lm_train_step, make_lora_train_step)
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
    "lora_init",
    "lora_merge",
    "lora_param_count",
    "lora_parameters",
    "make_lora_train_step",
    "make_lora_lm_train_step",
]
