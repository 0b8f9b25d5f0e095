"""LoRA: low-rank adapters for the port's models, the counterpart of
``mop_tpu/training/lora.py``.

Adapters are a flat ``{path: {"a": (din, r), "b": (r, dout)}}`` dict over
the slash-joined paths of a JAX-layout parameter tree
(``models.generate.decode_params`` for the GPT family,
``whisper_decode_params`` for Whisper; e.g.
``params/blocks_0/attn/q_proj/kernel``), so that an adapter trained by the
JAX package loads as it is (``utils.jax_weights.load_jax_adapters``). ``b``
starts at zero: step 0 is exactly the base model.

Training runs through an explicit merge: each step computes
``W + scale * a @ b`` for every adapted kernel and runs the unchanged model
on the merged weights (``torch.func.functional_call``), so gradients reach
only the rank-r factors and the base weights are never updated. The
optimizer (``torch.optim.AdamW`` in the LM helper's examples) holds the
factors (``lora_parameters``). The serving engine applies a bank of such
adapters per batch row instead (``serving.engine``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ..models.generate import _decoding, _module_state

Tensor = torch.Tensor

__all__ = ["default_match", "lora_init", "lora_merge", "lora_param_count", "lora_parameters",
           "make_lora_train_step", "make_lora_lm_train_step"]


def _walk(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(slash path, leaf) pairs in sorted key order (the JAX flatten order)."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, path)
        else:
            yield path, v


def default_match(path: str, leaf) -> bool:
    """Adapt every 2-D ``kernel`` leaf (all linear weights; embedding tables,
    biases and scales are never matched)."""
    return path.endswith("kernel") and getattr(leaf, "ndim", 0) == 2


def lora_init(generator: torch.Generator, params: dict, rank: int,
              match: Optional[Callable[[str, Tensor], bool]] = None,
              a_std: float = 0.02) -> Dict[str, Dict[str, Tensor]]:
    """Zero-effect adapters for every matched kernel of ``params``: ``a`` ~
    N(0, a_std^2) drawn from ``generator`` in the tree's sorted path order,
    ``b`` = 0, on the kernel's device and in its dtype."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    match = default_match if match is None else match
    adapters = {}
    for path, leaf in _walk(params):
        if not match(path, leaf):
            continue
        din, dout = leaf.shape
        a = torch.randn((din, rank), generator=generator, device=generator.device) * a_std
        adapters[path] = {"a": a.to(leaf.device, leaf.dtype),
                          "b": torch.zeros((rank, dout), dtype=leaf.dtype, device=leaf.device)}
    if not adapters:
        raise ValueError("lora_init matched no kernels")
    return adapters


def lora_merge(params: dict, adapters: dict, scale: float = 1.0) -> dict:
    """The tree with ``W + scale * a @ b`` at every adapted path (the other
    leaves are the originals, not copies). ``scale`` is LoRA's
    ``alpha / rank``."""
    def fix(node: dict, prefix: str) -> dict:
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                out[k] = fix(v, path)
            elif path in adapters:
                ad = adapters[path]
                out[k] = v + scale * (ad["a"] @ ad["b"]).to(v.dtype)
            else:
                out[k] = v
        return out

    return fix(params, "")


def lora_param_count(adapters: dict) -> int:
    return sum(int(x.numel()) for ad in adapters.values() for x in ad.values())


def lora_parameters(adapters: dict) -> List[Tensor]:
    """The factors as trainable leaves, in sorted path order, for an
    optimizer: ``torch.optim.AdamW(lora_parameters(adapters), lr=...)``."""
    out = []
    for path in sorted(adapters):
        for key in ("a", "b"):
            out.append(adapters[path][key].requires_grad_(True))
    return out


def make_lora_train_step(loss_of_params: Callable, base_params: dict,
                         optimizer: torch.optim.Optimizer, scale: float = 1.0):
    """A generic adapter-only train step: ``step(adapters, *batch) -> loss``.

    ``loss_of_params(merged_params, *batch)`` is the task loss on the merged
    tree; ``optimizer`` holds ``lora_parameters(adapters)`` and updates the
    factors in place. ``base_params`` is read, never updated."""

    def step(adapters: dict, *batch) -> Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of_params(lora_merge(base_params, adapters, scale), *batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_lora_lm_train_step(model: nn.Module, base_params: dict,
                            optimizer: torch.optim.Optimizer, scale: float = 1.0):
    """The LM case: ``step(adapters, idx, targets) -> loss`` for a GPT-family
    model, its loss from ``model(idx, targets=...)`` in eval mode (no
    dropout, as the JAX step's ``train=False``) over the merged weights.
    ``base_params``: ``decode_params(model)``."""

    def loss_of_params(p, idx, targets):
        with _decoding(model, grad=True):
            return torch.func.functional_call(model, _module_state(p), (idx,),
                                              {"targets": targets})[1]

    return make_lora_train_step(loss_of_params, base_params, optimizer, scale)
