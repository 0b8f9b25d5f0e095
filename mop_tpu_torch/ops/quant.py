"""Weight-only int8 and int4 quantization for the decode path, in PyTorch:
the port of ``mop_tpu/ops/quant.py``.

int8: one symmetric scale per output channel, ``w ~= q * scale``, the weight
kept in JAX's (in, out) kernel layout so that its bytes and scales compare
with the JAX package's exactly. int4: group-wise scales along the input axis
(64 rows a group by default), two nibbles packed in each int8 byte (row 2i
in the low nibble, 2i + 1 in the high one, both sign-extended on unpack),
the scale of each group picked from 16 clip ratios by the least round-trip
squared error.

``quantize_params`` maps over the nested dict of ``generate.decode_params``
(the JAX tree's layout): every 2-D ``kernel`` leaf of at least ``min_size``
elements becomes a ``QTensor`` or ``Q4Tensor``; embeddings (and so the tied
head), LayerNorms, biases, convs and the Quartet scalars stay as they are.
The decode functions' ``_lin`` reads either kind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["QTensor", "Q4Tensor", "quantize", "qmatmul", "quantize4", "q4matmul",
           "quantize_params", "dequantize_params", "quantized_bytes"]


@dataclass
class QTensor:
    """Symmetric per-output-channel int8 weight: ``w ~= q * scale``.

    ``q``: int8, the weight's shape; ``scale``: fp32, broadcastable over
    ``q`` (one per output channel)."""

    q: Tensor
    scale: Tensor

    def dequant(self, dtype: torch.dtype = torch.float32) -> Tensor:
        return (self.q.float() * self.scale).to(dtype)


def quantize(w: Tensor, channel_axis: int = -1) -> QTensor:
    """int8 with one scale per ``channel_axis`` slice (for an (in, out)
    kernel, one per output feature): ``max(amax, 1e-12) / 127``, the values
    rounded half to even and clipped to [-127, 127]."""
    w32 = w.float()
    axis = channel_axis % w.ndim
    reduce = tuple(a for a in range(w.ndim) if a != axis)
    scale = w32.abs().amax(dim=reduce, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def qmatmul(x: Tensor, qt: QTensor) -> Tensor:
    """``x @ w`` with an int8 weight: the weight upcast to x's dtype, the
    product scaled per output column."""
    y = x @ qt.q.to(x.dtype)
    return y * qt.scale.reshape(qt.scale.shape[-1]).to(y.dtype)


@dataclass
class Q4Tensor:
    """Group-wise symmetric int4 weight, nibble-packed: ``w ~= q * scale``.

    ``q``: int8 (in / 2, out), row 2i in the low nibble and 2i + 1 in the
    high one; ``scale``: fp32 (n_groups, out), one per ``group`` input rows
    of a column."""

    q: Tensor
    scale: Tensor
    group: int = 64

    def unpack(self) -> Tensor:
        """(in, out) int8 in [-8, 7]: the interleaved sign-extended nibbles
        (arithmetic shifts on int8)."""
        lo = (self.q << 4) >> 4
        hi = self.q >> 4
        return torch.stack([lo, hi], dim=1).reshape(-1, self.q.shape[-1])

    def dequant(self, dtype: torch.dtype = torch.float32) -> Tensor:
        qi = self.unpack()
        n_in, n_out = qi.shape
        w = qi.float().reshape(-1, self.group, n_out)
        return (w * self.scale[:, None, :]).reshape(n_in, n_out).to(dtype)


# The clip ratios of ``jnp.linspace(0.65, 1.0, 16)`` in float32, as the JAX
# package computes them: XLA's fused interpolation differs from
# ``torch.linspace`` in the last place at four of the sixteen, which can move
# the argmin of the round-trip error and so the stored scale.
_CLIP_RATIOS_16 = (0.6499999761581421, 0.6733333468437195, 0.6966666579246521,
                   0.7199999094009399, 0.7433333396911621, 0.7666666507720947,
                   0.7899999618530273, 0.8133333325386047, 0.8366667032241821,
                   0.8600000143051147, 0.8833333253860474, 0.9066666960716248,
                   0.9300000071525574, 0.95333331823349, 0.9766666889190674, 1.0)


def _clip_ratios(n: int, device) -> Tensor:
    if n == len(_CLIP_RATIOS_16):
        return torch.tensor(_CLIP_RATIOS_16, dtype=torch.float32, device=device)
    return torch.linspace(0.65, 1.0, n, dtype=torch.float32, device=device)


def quantize4(w: Tensor, group: int = 64, clip_search: int = 16) -> Q4Tensor:
    """A 2-D (in, out) kernel as group-wise int4 in [-7, 7].

    ``group`` input rows share one fp32 scale per output column (the whole
    column when the input dim is not a multiple). With ``clip_search`` > 0
    each group's max-abs scale is multiplied by the one of that many ratios
    in [0.65, 1.0] whose grid has the least round-trip squared error (the
    first on a tie)."""
    n_in, n_out = w.shape
    if n_in % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {n_in}")
    if n_in % group:
        group = n_in
    if group % 2:
        raise ValueError(f"group must be even (nibble pairs share a packed row), got {group}")
    w32 = w.float().reshape(n_in // group, group, n_out)
    scale = w32.abs().amax(dim=1).clamp_min(1e-12) / 7.0  # (n_groups, out)
    if clip_search:
        cand = scale[None] * _clip_ratios(clip_search, w.device)[:, None, None]  # (C, G, out)
        q = torch.clamp(torch.round(w32[None] / cand[:, :, None, :]), -7, 7)
        mse = ((q * cand[:, :, None, :] - w32[None]) ** 2).sum(dim=2)
        scale = cand.gather(0, mse.argmin(dim=0)[None])[0]
    q = torch.clamp(torch.round(w32 / scale[:, None, :]), -7, 7)
    q = q.to(torch.int8).reshape(n_in, n_out)
    packed = ((q[1::2] << 4) | (q[0::2] & 0x0F)).to(torch.int8)
    return Q4Tensor(q=packed, scale=scale, group=group)


def q4matmul(x: Tensor, qt: Q4Tensor) -> Tensor:
    """``x @ w`` with a packed int4 weight, de-interleaved:
    ``x[..., 0::2] @ w_lo + x[..., 1::2] @ w_hi``, each nibble scaled by its
    group's scale (both nibbles of packed row i are in group
    ``i // (group // 2)``), so the (in, out) weight is never rebuilt."""
    q, scale = qt.q, qt.scale
    n_half, n_out = q.shape
    g2 = qt.group // 2

    def w_from(nib):
        w = nib.float().reshape(-1, g2, n_out)
        return (w * scale[:, None, :]).reshape(n_half, n_out).to(x.dtype)

    return x[..., 0::2] @ w_from((q << 4) >> 4) + x[..., 1::2] @ w_from(q >> 4)


def _map_leaves(tree: Any, fn: Callable[[tuple, Any], Any], path: tuple = ()) -> Any:
    """The nested dict ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _is_quantizable(path: tuple, leaf: Any, min_size: int) -> bool:
    return (isinstance(leaf, Tensor) and bool(path) and path[-1] == "kernel"
            and leaf.ndim == 2 and leaf.numel() >= min_size)


def quantize_params(params: Any, min_size: int = 4096, bits: int = 8, group: int = 64) -> Any:
    """The tree with every 2-D ``kernel`` leaf of at least ``min_size``
    elements as a ``QTensor`` (``bits=8``) or ``Q4Tensor`` (``bits=4``; a
    kernel with an odd input dim stays int8), the rest as it was."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant_one(path, leaf):
        if not _is_quantizable(path, leaf, min_size):
            return leaf
        if bits == 4 and leaf.shape[0] % 2 == 0:
            return quantize4(leaf, group=group)
        return quantize(leaf)

    return _map_leaves(params, quant_one)


def dequantize_params(params: Any, dtype: torch.dtype = torch.float32) -> Any:
    """The inverse of ``quantize_params`` (up to the grid's rounding)."""
    return _map_leaves(params, lambda _, leaf: leaf.dequant(dtype)
                       if isinstance(leaf, (QTensor, Q4Tensor)) else leaf)


def quantized_bytes(params: Any) -> Tuple[int, int]:
    """(bytes as stored, bytes if every leaf were fp32)."""
    stored = fp32 = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            stored += leaf.q.numel() + leaf.scale.numel() * 4
            fp32 += leaf.q.numel() * 4
        elif isinstance(leaf, Q4Tensor):
            stored += leaf.q.numel() + leaf.scale.numel() * 4
            fp32 += leaf.q.numel() * 2 * 4
        else:
            stored += leaf.numel() * leaf.element_size()
            fp32 += leaf.numel() * 4
    return stored, fp32
