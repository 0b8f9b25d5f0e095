"""The port's train and eval steps and its scale-out layer over
``torch.distributed``: the device mesh, data parallelism through every step,
the process group and launch, FSDP / ZeRO-1, tensor parallelism (with
sequence parallelism for the GPT family), pipeline parallelism (GPipe, 1F1B
and the composed dp x tp x pp step) and multi-seed training. One process
drives one device (``parallel.mesh``)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, Sharding, batch_sharding, make_mesh,
                   make_mesh3, replicate, replicated, shard_batch)
from .fsdp import (DEFAULT_MIN_SIZE, fsdp_init_opt_state, fsdp_param_shardings,
                   fsdp_shard_params, fsdp_spec, make_fsdp_classifier_train_step,
                   make_fsdp_lm_train_step, zero1_init_opt_state)
from .multiseed import (make_multiseed_scanned_train_step, multiseed_init, multiseed_opt_init,
                        seed_shardings, unstack_seed)
from .multihost import (global_batch, init_distributed, make_multihost_mesh,
                        process_batch_slice, replicate_multihost)
from .pp import (make_pp_lm_train_step, make_pp_lm_train_step_1f1b, merge_gpt_params,
                 place_pp_params, pp_init_opt_state, split_gpt_params)
from .tp import (TP_RULES_DEFAULT, make_tp_classifier_train_step, make_tp_lm_train_step,
                 tp_init_opt_state, tp_param_shardings, tp_shard_params)
from .train_step import (cast_floats, make_classifier_eval_step, make_classifier_train_step,
                         make_imagenet_train_step, make_lm_train_step,
                         make_scanned_classifier_train_step)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "Mesh",
    "Sharding",
    "make_mesh",
    "make_mesh3",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "replicate",
    "cast_floats",
    "make_classifier_train_step",
    "make_classifier_eval_step",
    "make_imagenet_train_step",
    "make_scanned_classifier_train_step",
    "make_multiseed_scanned_train_step",
    "multiseed_init",
    "multiseed_opt_init",
    "seed_shardings",
    "unstack_seed",
    "make_lm_train_step",
    "init_distributed",
    "make_multihost_mesh",
    "process_batch_slice",
    "global_batch",
    "replicate_multihost",
    "DEFAULT_MIN_SIZE",
    "fsdp_spec",
    "fsdp_param_shardings",
    "fsdp_shard_params",
    "fsdp_init_opt_state",
    "zero1_init_opt_state",
    "make_fsdp_classifier_train_step",
    "make_fsdp_lm_train_step",
    "TP_RULES_DEFAULT",
    "tp_param_shardings",
    "tp_shard_params",
    "tp_init_opt_state",
    "make_tp_classifier_train_step",
    "make_tp_lm_train_step",
    "split_gpt_params",
    "merge_gpt_params",
    "place_pp_params",
    "pp_init_opt_state",
    "make_pp_lm_train_step",
    "make_pp_lm_train_step_1f1b",
]
