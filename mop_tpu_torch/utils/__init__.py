"""Utilities of the PyTorch port: device selection, JAX weight loading,
evaluation metrics, NaN guards and profiling (the counterparts of
``mop_tpu/utils``' ``metrics``, ``debug`` and ``profiling``).

Two modules of ``mop_tpu/utils`` have no counterpart here:

- ``init.py`` (``jitted_init``) jits ``model.init`` to collapse an eager
  init's dispatches; a port model is initialised when it is constructed
  (``init_params`` from a generator), so there is nothing to jit;
- ``hlo_inspect.py`` asserts on the XLA collectives of a compiled step. Its
  torch counterpart, a ``torch.profiler`` check of the NCCL calls, comes
  with the multi-GPU port.
"""

from .device import resolve_device
from .jax_weights import load_jax_params
from .metrics import cer, lm_nll, lm_perplexity, topk_accuracy, wer

__all__ = ["resolve_device", "load_jax_params", "lm_nll", "lm_perplexity", "wer", "cer",
           "topk_accuracy"]
