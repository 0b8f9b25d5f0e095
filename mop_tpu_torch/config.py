"""Kernel switches of the port: the fused-route flags of ``mop_tpu/config.py``.

Each flag is read from the environment once, at import, under the JAX
package's name and with its default (all on); a module reads it beside the
shape predicate of its fused op (``ops/fused.py``) and composes when it is
off. Turning a flag off is the user's choice of the composed route, not a
fallback:

- ``fused_attention`` (``MOP_TPU_FUSED_ATTENTION``): K1 in ``MSA`` and
  ``BaselineMSA``, and the edgewise kernels K2/K3 in ``EdgewiseMSA``;
- ``fused_multihop`` (``MOP_TPU_FUSED_MULTIHOP``): K4 in ``MultiHopMSA`` and
  ``DualPathMSA``;
- ``fused_quartet`` (``MOP_TPU_FUSED_QUARTET``): K5 in ``CausalSelfAttention``;
- ``fused_edgewise_train`` (``MOP_TPU_FUSED_EDGEWISE_TRAIN``): K2/K3 (and so
  K2b/K3b) in ``EdgewiseMSA`` in training.

Set a flag for a run with its environment variable (anything but ``1``,
``true``, ``yes`` or ``on`` turns it off), or in code with
``config.fused_multihop = False``: the modules read ``config`` at each call.
"""

from __future__ import annotations

import os

_TRUTHY = ("1", "true", "yes", "on")


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in _TRUTHY


class _Config:
    def __init__(self):
        self.fused_attention = _env_flag("MOP_TPU_FUSED_ATTENTION", True)
        self.fused_multihop = _env_flag("MOP_TPU_FUSED_MULTIHOP", True)
        self.fused_quartet = _env_flag("MOP_TPU_FUSED_QUARTET", True)
        self.fused_edgewise_train = _env_flag("MOP_TPU_FUSED_EDGEWISE_TRAIN", True)


config = _Config()

