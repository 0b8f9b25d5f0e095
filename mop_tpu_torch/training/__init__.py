"""Training utilities of the port (the counterpart of ``mop_tpu/training``):
``Trainer`` and ``train_model``, the schedule, seeding, parameter counts,
checkpoints (one file, step directories, the background manager), the
meters, the parameter EMA, the preemption guard and LoRA adapters. A
sharded model's checkpoints go through ``torch.distributed.checkpoint`` and
``restore_checkpoint_sharded`` reads them into another layout."""

from .lora import (lora_init, lora_merge, lora_param_count, lora_parameters,
                   make_lora_lm_train_step, make_lora_train_step)
from .preemption import PREEMPTED_EXIT_CODE, PreemptionGuard, resume_latest
from .trainer import Trainer, train_model
from .utils import (AsyncCheckpointManager, AverageMeter, EarlyStopping, cosine_lr, count_params,
                    ema_update, format_time, load_checkpoint, load_checkpoint_orbax,
                    print_model_info, restore_checkpoint_sharded, save_checkpoint,
                    save_checkpoint_orbax, set_seed, step_seed)

__all__ = [
    "Trainer",
    "train_model",
    "cosine_lr",
    "set_seed",
    "step_seed",
    "count_params",
    "AverageMeter",
    "EarlyStopping",
    "ema_update",
    "format_time",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_orbax",
    "load_checkpoint_orbax",
    "restore_checkpoint_sharded",
    "AsyncCheckpointManager",
    "print_model_info",
    "lora_init",
    "lora_merge",
    "lora_param_count",
    "lora_parameters",
    "make_lora_train_step",
    "make_lora_lm_train_step",
    "PreemptionGuard",
    "resume_latest",
    "PREEMPTED_EXIT_CODE",
]
