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

Beside the flags stands one dispatch threshold, ``whisper_cached_min_ctx``
(``MOP_TPU_WHISPER_CACHED_MIN_CTX``, an int): ``whisper_transcribe_auto``
takes the KV-cached route from that many tokens on and the full-window route
below. Its default is the crossover measured on the H100 (``PERF.md``), not
the JAX package's TPU one.

Set a flag for a run with its environment variable (anything but ``1``,
``true``, ``yes`` or ``on`` turns it off), or in code with
``config.fused_multihop = False``: the modules read ``config`` at each call.
"""

from __future__ import annotations

import os

_TRUTHY = ("1", "true", "yes", "on")
# The text length from which the KV-cached Whisper decode takes over from the
# full window, from chip_smoke.py phase 11 at tools/bench_whisper_dispatch.py's
# config (384 wide, 4 + 4 layers, 256 frames, batch 8) on an NVIDIA H100 80GB
# HBM3 at 700 W: both routes level within their spread from 32 to 256 tokens,
# the cached route 1.09-1.43x faster at 512 in every run (PERF.md section 5).
WHISPER_CACHED_MIN_CTX = 256


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
        self.whisper_cached_min_ctx = int(os.environ.get(
            "MOP_TPU_WHISPER_CACHED_MIN_CTX", str(WHISPER_CACHED_MIN_CTX)))


config = _Config()

