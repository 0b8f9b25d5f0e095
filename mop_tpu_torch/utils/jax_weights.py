"""Load a ``mop_tpu`` (JAX/flax) parameter tree into a port model.

The reverse of ``mop_tpu/utils/torch_port.py``: the JAX tree comes in as
nested dicts of numpy arrays (``jax.device_get`` of the params, with or
without the top ``"params"`` key) and its leaves are renamed and re-laid-out
into the port's torch names:

- Linear  kernel (in, out)          -> weight (out, in)
- Conv2d  kernel (kh, kw, in, out)  -> weight (out, in, kh, kw)   [HWIO -> OIHW]
- lowrank gate kernel (C, 4r)       -> Conv1d weight (4r, C, 1)
- LayerNorm scale                   -> weight
- MoE gate_kernel (D, E)            -> gate_kernel (E, D), as every 2-D kernel;
  the MoE's stacked expert weights ``fc1`` (E, D, H) and ``fc2`` (E, H, D)
  are not kernels and keep their layout and names

The localizer's head and unified-block MLPs (``head.fc1``, ``mlp_fc1``) take
the reference's ``Sequential`` indices. Any leaf without a port parameter,
any port parameter without a leaf, and any shape mismatch raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# JAX name -> torch reference name: the inverse of torch_port._RENAMES, for
# the reference naming of the whole model zoo.
_RENAMES = [
    (r"^(\w+MSA)_(\d+)\.", r"blocks.\2.attn."),  # _VariantViT's per-block MSA
    (r"\bkerns\.conv1\b", "kerns.k.0"),
    (r"\bkerns\.conv2\b", "kerns.k.2"),
    (r"\bfuse\.fuse1\b", "fuse.fuse.0"),
    (r"\bfuse\.fuse2\b", "fuse.fuse.2"),
    (r"\baudio_proj_lin\.", "audio_proj."),
    (r"\bqkv_(\d+)\b", r"qkv_list.\1"),
    (r"\b(blocks|encoder|decoder|q_lens|k_lens|lens_bank)_(\d+)\b", r"\1.\2"),
    (r"\bedge_head\.(conv2|row_proj|col_proj)_(kernel|bias)$",
     lambda m: f"edge_head.{m.group(1)}.{'weight' if m.group(2) == 'kernel' else 'bias'}"),
    (r"\b(wte|wpe|audio_pos|text_pos)\.embedding$", r"\1.weight"),
    (r"\bhead\.fc1\b", "head.mlp.0"),
    (r"\bhead\.fc2\b", "head.mlp.2"),
    (r"\bmlp_fc1\b", "mlp.0"),
    (r"\bmlp_fc2\b", "mlp.2"),
    (r"\.(kernel|scale)$", ".weight"),
]

_GATE_KERNEL = re.compile(r"\bedge_head\.(row_proj|col_proj)_kernel$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def torch_name(jax_key: str) -> str:
    """The port's parameter name of one dotted JAX leaf path."""
    for pat, repl in _RENAMES:
        jax_key = re.sub(pat, repl, jax_key)
    return jax_key


def to_torch_layout(jax_key: str, w: np.ndarray) -> np.ndarray:
    """Re-lay-out one JAX leaf for its torch parameter, by leaf kind."""
    if _GATE_KERNEL.search(jax_key):
        return w.T[:, :, None]
    if jax_key.endswith("kernel"):
        if w.ndim == 2:
            return w.T
        if w.ndim == 4:
            return np.transpose(w, (3, 2, 0, 1))
        if w.ndim == 3:
            return np.transpose(w, (2, 1, 0))  # LIO -> OIL
    return w


def jax_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """The JAX tree as a flat torch-named state dict of numpy arrays."""
    tree = params["params"] if "params" in params else params
    return {torch_name(k): np.array(to_torch_layout(k, w), order="C")
            for k, w in _flatten(tree).items()}


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` in place and return it.

    Raises KeyError on a missing or extra parameter and ValueError on a shape
    mismatch, before anything is copied.
    """
    sd = jax_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"JAX params do not match the model: missing {missing}, "
                       f"extra {extra}")
    bad = [f"{k}: jax {sd[k].shape} vs torch {tuple(own[k].shape)}"
           for k in own if tuple(sd[k].shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    model.load_state_dict({k: torch.as_tensor(sd[k], dtype=own[k].dtype)
                           for k in own}, strict=True)
    return model


def load_jax_adapters(adapters: Mapping, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA adapter dict (``{path: {"a": (din, r), "b": (r, dout)}}``
    with numpy or JAX leaves, ``mop_tpu.training.lora``'s format) as the
    port's: the same slash paths, which name the same kernels of
    ``decode_params`` / ``whisper_decode_params``, and fp32 tensors on
    ``device`` (the CPU when None), copies that share no memory with the
    given arrays (training updates them in place)."""
    return {path: {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                   for k, v in fac.items()}
            for path, fac in adapters.items()}
