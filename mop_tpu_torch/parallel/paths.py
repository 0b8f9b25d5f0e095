"""The JAX package's name and layout of each port parameter, for the
sharding rules that were written against the JAX parameter tree.

``jax_path(model, name)`` is the slash path the JAX model gives the leaf
(the inverse of ``utils.jax_weights.torch_name``): ``enc/blocks_0/attn/qkv/
kernel`` for ``enc.blocks.0.attn.qkv.weight``. ``jax_axes(model, name)`` is
the order of the torch tensor's dimensions in the JAX leaf's: a Linear's
weight (out, in) is the JAX kernel (in, out), a conv's OIHW the JAX HWIO.
"""

from __future__ import annotations

import re
from typing import Tuple

from torch import nn

# torch reference name -> JAX name: the inverse of jax_weights._RENAMES.
_TO_JAX = [
    (r"\bkerns\.k\.0\b", "kerns.conv1"),
    (r"\bkerns\.k\.2\b", "kerns.conv2"),
    (r"\bfuse\.fuse\.0\b", "fuse.fuse1"),
    (r"\bfuse\.fuse\.2\b", "fuse.fuse2"),
    (r"\baudio_proj\.", "audio_proj_lin."),
    (r"\bqkv_list\.(\d+)\b", r"qkv_\1"),
    (r"\bhead\.mlp\.0\b", "head.fc1"),
    (r"\bhead\.mlp\.2\b", "head.fc2"),
    (r"\bmlp\.0\b", "mlp_fc1"),
    (r"\bmlp\.2\b", "mlp_fc2"),
    (r"\b(blocks|encoder|decoder|q_lens|k_lens|lens_bank)\.(\d+)\b", r"\1_\2"),
]

_KERNEL_OWNERS = (nn.Linear, nn.Conv1d, nn.Conv2d)


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod_name, _, leaf = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), leaf


def jax_path(model: nn.Module, name: str) -> str:
    """The JAX tree's slash path of port parameter ``name``."""
    owner, leaf = _owner(model, name)
    head = name[: len(name) - len(leaf)]
    for pat, repl in _TO_JAX:
        head = re.sub(pat, repl, head)
    if leaf == "weight":
        if isinstance(owner, _KERNEL_OWNERS):
            leaf = "kernel"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif isinstance(owner, nn.LayerNorm) or type(owner).__name__ == "LayerNorm":
            leaf = "scale"
    path = head.replace(".", "/") + leaf
    m = re.match(r"^(.*edge_head)/(row_proj|col_proj)/(kernel|bias)$", path)
    if m:  # the lowrank gate head's 1x1 convs are flat leaves in JAX
        path = f"{m.group(1)}/{m.group(2)}_{m.group(3)}"
    return path


def jax_axes(model: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """For each dimension of the JAX leaf, the torch dimension it is."""
    owner, leaf = _owner(model, name)
    if leaf == "weight" and isinstance(owner, _KERNEL_OWNERS):
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)  # OIHW -> HWIO
        if ndim == 3:
            return (2, 1, 0)  # OIL -> LIO
    if leaf == "gate_kernel" and ndim == 2:  # the MoE gate, (E, D) here, (D, E) there
        return (1, 0)
    return tuple(range(ndim))
