"""Hand-written Hopper attention kernels and their plain PyTorch versions.

The port of ``mop_tpu/ops/fused.py``. Each public function takes the JAX
function's arguments and layout:

- ``flash_attention``: K1, single-view scaled-dot-product attention with an
  online softmax (``csrc/flash_fwd.cu``).
- ``fused_edgewise_lowrank_attention``: K2, the full E-mode lowrank pipeline
  in one program per batch*head (``csrc/edgewise_lowrank_fwd.cu``).

The kernel is chosen by the tensors' device alone: a CUDA tensor launches the
kernel or raises, a CPU tensor runs the ``*_plain`` version, which is also
what the tests and ``chip_smoke.py`` hold the kernel against. Each wrapper
counts its launches in its ``launches`` attribute. Only forward kernels
exist so far: a CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Union

import torch

from . import _build

# Shared memory one block may take on the H100 (227 KB).
MAX_SMEM_BYTES = 232448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _fn(lib_name: str, sym: str, argtypes, restype=ctypes.c_int):
    f = getattr(_build.load(lib_name), sym)
    f.argtypes = argtypes
    f.restype = restype
    return f


def _check_inference(name: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward-only; run under torch.no_grad() "
            "or torch.inference_mode()")


def _check_cuda_inputs(name: str, *ts: torch.Tensor) -> None:
    ref = ts[0]
    if ref.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported (float32 or bfloat16)")
    for t in ts:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: inputs must share one CUDA device and dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the feature axis must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


# ------------------------------- K1: flash -------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """``softmax(q k^T / sqrt(dk) [causal]) v`` over (..., N, dk), as the kernel
    computes it: fp32 scores and statistics, the unnormalised probabilities
    cast to v's dtype before the value product, rows with no live key give 0."""
    dk = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    if causal:
        n, m = s.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return o.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise fused attention over (B, H, N, dk) or (BH, N, dk) inputs.

    K/V may have another length than Q. The causal mask is ``row >= col``,
    as in the JAX kernel. On CUDA the output is a (B, H, N, dk) view of a
    (B, N, H, dk) buffer, so merging the heads afterwards copies nothing.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    if not q.is_cuda:
        out = flash_attention_plain(q, k, v, causal)
        return out[0] if squeeze else out
    _check_inference("flash_attention", q, k, v)
    _check_cuda_inputs("flash_attention", q, k, v)
    b, h, n, dk = q.shape
    n_kv = k.shape[2]
    if k.shape != (b, h, n_kv, dk) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}, {v.shape}")
    if dk > 128:
        raise ValueError(f"flash_attention: dk={dk} > 128 is not supported")
    out = torch.empty(b, n, h, dk, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _fn("flash_fwd", "mop_flash_fwd",
             [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _P])
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, h, n, n_kv, dk, strides, int(causal),
                1.0 / math.sqrt(dk), _stream(q.device))
    _raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    return out[0] if squeeze else out


flash_attention.launches = 0


# ------------------------ K2: edgewise lowrank ---------------------------


def fused_edgewise_lowrank_attention_plain(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """The E-mode lowrank pipeline of ``_edgewise_math`` + ``_edgewise_output``
    over (B, H, V, N, dk) inputs, step for step: products in fp32 on operands
    cast to the input dtype where the JAX kernel casts them, softmaxes, gate
    head and logit algebra in fp32. Returns (B, H, N, dk) in the input dtype."""
    cdt = qs.dtype
    f32 = torch.float32
    nv, dk = qs.shape[2], qs.shape[-1]
    r = wrow.shape[1] // 4

    def c(x):  # the compute-dtype cast before a product
        return x.to(cdt).to(f32)

    q = (qs * torch.tensor(1.0 / math.sqrt(dk), dtype=cdt)).to(f32)
    k, v = ks.to(f32), vs.to(f32)
    s_list = [q[:, :, i] @ k[:, :, i].transpose(-1, -2) for i in range(nv)]
    a_list = [torch.softmax(s, -1) for s in s_list]
    ac = [c(a) for a in a_list]
    if nv == 1:
        c_fwd = c_bwd = a_list[0]
    else:
        c_fwd = ac[0] @ ac[1]
        for i in range(2, nv):
            c_fwd = c(c_fwd) @ ac[i]
        c_bwd = ac[-1] @ ac[-2]
        for i in range(nv - 3, -1, -1):
            c_bwd = c(c_bwd) @ ac[i]
    log_cf = torch.log(c_fwd + 1e-6)
    log_cb = torch.log(c_bwd + 1e-6)

    # Channel order [S_1..S_V, S_1^T..S_V^T, logC_fwd, logC_bwd]; the row mean
    # of S^T is the column mean of S.
    rows = [s.mean(-1) for s in s_list]
    cols = [s.mean(-2) for s in s_list]
    row_feat = torch.stack(rows + cols + [log_cf.mean(-1), log_cb.mean(-1)], -1)
    col_feat = torch.stack(cols + rows + [log_cf.mean(-2), log_cb.mean(-2)], -1)
    a_fac = row_feat @ wrow.to(f32) + brow.to(f32)
    b_fac = col_feat @ wcol.to(f32) + bcol.to(f32)
    g = [torch.sigmoid(a_fac[..., j * r:(j + 1) * r]
                       @ b_fac[..., j * r:(j + 1) * r].transpose(-1, -2))
         for j in range(4)]

    s1 = s_list[0]
    s_sum = s1
    for s in s_list[1:]:
        s_sum = s_sum + s
    m = s_list[0]
    for s in s_list[1:]:
        m = torch.maximum(m, s)
    lse = m + torch.log(sum(torch.exp(s - m) for s in s_list))
    mean_others = (s_sum - s1) / max(1, nv - 1)
    smix = s1 + g[0] * (s_sum - s1)
    smix = smix + g[1] * (lse - s1)
    smix = smix - g[2] * (beta_not * mean_others)
    smix = smix + g[3] * log_cf
    att = torch.softmax(smix, -1)

    transport = v[:, :, nv - 1]
    for i in range(nv - 1, 0, -1):
        transport = ac[i] @ c(transport)
    w = torch.as_tensor(chain_w, dtype=f32, device=qs.device)
    y = c(att) @ v[:, :, 0] + w * (ac[0] @ c(transport))
    return y.to(cdt)


def edgewise_lowrank_smem_bytes(n_views: int, n: int, dk: int, rank: int) -> int:
    """Shared memory one K2 program needs (the kernel's own count)."""
    fn = _fn("edgewise_lowrank_fwd", "mop_edgewise_lowrank_smem_bytes",
             [_I, _I, _I, _I], ctypes.c_longlong)
    return int(fn(n_views, n, dk, rank))


def fused_edgewise_lowrank_attention(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """Fully fused E-mode lowrank attention, forward.

    qs/ks/vs: (B, H, V, N, dk) per-view tensors (any strides with a contiguous
    feature axis); wrow/wcol: (2V+2, 4r) gate-head kernels; brow/bcol: (4r,);
    chain_w: the sigmoid'd chain-value weight. Returns (B, H, N, dk). On CUDA
    it supports 2 <= V, N <= 64, dk <= 128 within the card's shared memory
    and raises outside them; the output is a view of a (B, N, H, dk) buffer.
    """
    if not qs.is_cuda:
        return fused_edgewise_lowrank_attention_plain(
            qs, ks, vs, wrow, brow, wcol, bcol, beta_not, chain_w)
    name = "fused_edgewise_lowrank_attention"
    w_t = torch.as_tensor(chain_w, dtype=torch.float32, device=qs.device).reshape(1)
    _check_inference(name, qs, ks, vs, wrow, brow, wcol, bcol, w_t)
    _check_cuda_inputs(name, qs, ks, vs)
    b, h, nv, n, dk = qs.shape
    if ks.shape != qs.shape or vs.shape != qs.shape:
        raise ValueError(f"{name}: shapes {qs.shape}, {ks.shape}, {vs.shape}")
    c4 = wrow.shape[1]
    if (wrow.shape != (2 * nv + 2, c4) or wcol.shape != wrow.shape or c4 % 4
            or brow.shape != (c4,) or bcol.shape != (c4,)):
        raise ValueError(f"{name}: gate-head shapes {wrow.shape}, {brow.shape}, "
                         f"{wcol.shape}, {bcol.shape} for {nv} views")
    rank = c4 // 4
    if nv < 2 or n > 64 or dk > 128 or rank < 1:
        raise ValueError(f"{name}: V={nv}, N={n}, dk={dk}, r={rank} outside the "
                         "kernel's shapes (2 <= V, N <= 64, dk <= 128, r >= 1)")
    smem = edgewise_lowrank_smem_bytes(nv, n, dk, rank)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: V={nv}, N={n}, dk={dk}, r={rank} needs {smem} "
                         f"bytes of shared memory, more than {MAX_SMEM_BYTES}")
    ws = [t.detach().to(device=qs.device, dtype=torch.float32).contiguous()
          for t in (wrow, brow, wcol, bcol)]
    out = torch.empty(b, n, h, dk, dtype=qs.dtype, device=qs.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 15)(
        *qs.stride()[:4], *ks.stride()[:4], *vs.stride()[:4], *out.stride()[:3])
    fn = _fn("edgewise_lowrank_fwd", "mop_edgewise_lowrank_fwd",
             [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _P, _F, _F, _P])
    with torch.cuda.device(qs.device):
        rc = fn(_DTYPE_CODE[qs.dtype], qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                out.data_ptr(), *(t.data_ptr() for t in ws), w_t.data_ptr(),
                b, h, nv, n, dk, rank, strides, float(beta_not),
                1.0 / math.sqrt(dk), _stream(qs.device))
    _raise_on(rc, name)
    fused_edgewise_lowrank_attention.launches += 1
    return out


fused_edgewise_lowrank_attention.launches = 0

KERNELS = (flash_attention, fused_edgewise_lowrank_attention)


def reset_launch_counts() -> None:
    for f in KERNELS:
        f.launches = 0
