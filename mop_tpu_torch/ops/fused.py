"""Hand-written Hopper attention kernels and their plain PyTorch versions.

The port of ``mop_tpu/ops/fused.py``. Each public function takes the JAX
function's arguments and layout:

- ``flash_attention``: K1, single-view scaled-dot-product attention with an
  online softmax (``csrc/flash_fwd.cu``). Its backward recomputes the scores
  with plain PyTorch ops, as the JAX package's ``_flash_bwd_rule`` does
  through XLA.
- ``fused_edgewise_lowrank_attention``: K2, the full E-mode lowrank pipeline
  in one program per batch*head (``csrc/edgewise_lowrank_fwd.cu``), and its
  backward K2b, which recomputes the forward and applies the hand-derived
  VJP (``csrc/edgewise_bwd.cu``), for N <= 64; above that, up to the JAX
  kernels' N <= 256, K2w and K2bw (``edgewise_lowrank_wide_fwd`` and
  ``_bwd``, ``csrc/edgewise_wide.cu``), the same forward and VJP as stages
  over a per-program workspace in device memory.
- ``fused_edgewise_dense_attention``: K3, the E-mode pipeline with the dense
  per-edge gate head (``csrc/edgewise_dense_fwd.cu``), and its backward K3b,
  the same backward kernel templated on the dense head.
- ``fused_multihop_attention``: K4, the D-mode / two-hop dual-path pipeline
  (both score maps and softmaxes, the chain A1 A2^(hops-1), the gated mix,
  the final softmax and both value products) in one program per batch*head
  (``csrc/multihop_fwd.cu``). Its backward recomputes through the composed
  reference with plain ops, as the JAX op's.
- ``fused_quartet_attention``: K5, the Quartet LM's causal attention with
  both score maps standardized per row over every column
  (``csrc/quartet_fwd.cu``); backward as K4's.

The kernel is chosen by the tensors' device alone: a CUDA tensor launches the
kernel or raises, a CPU tensor runs the ``*_plain`` version, which is also
what the tests and ``chip_smoke.py`` hold the kernel against. Beside each
kernel's envelope stands a predicate on shapes alone (``flash_fits``,
``edgewise_lowrank_fits``, ``edgewise_dense_fits``, ``multihop_fits``,
``quartet_fits``): the modules call their fused op only where it says the
kernels take the shape, on the CPU as on the card, and compose otherwise, as
the JAX modules do outside their kernels' envelopes. Each wrapper
counts its launches in its ``launches`` attribute. The ops are
differentiable through ``torch.autograd.Function``s that save only their
inputs, as the JAX ``custom_vjp`` rules do; both edgewise ops share one
(``EdgewiseFunction``) over a flat weight list, as the JAX package's
``_edgewise_custom_op``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from . import _build
from . import attention as A

# Shared memory one block may take on the H100 (227 KB).
MAX_SMEM_BYTES = 232448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


_FNS = {}


def _fn(lib_name: str, sym: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``sym`` of a kernel library, typed once and kept."""
    f = _FNS.get((lib_name, sym))
    if f is None:
        f = getattr(_build.load(lib_name), sym)
        f.argtypes = argtypes
        f.restype = restype
        _FNS[(lib_name, sym)] = f
    return f


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


FLASH_MAX_DK = 128


def flash_fits(dk: int) -> bool:
    """Whether K1 takes heads of width ``dk``."""
    return dk <= FLASH_MAX_DK


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


def copy_width(tensors, row_elems: int) -> int:
    """The widest asynchronous copy, in bytes, that a kernel may use to bring
    rows of ``row_elems`` elements of each tensor into shared memory: 16, 8
    or 4 where that divides every address, every stride but the (unit)
    feature one and the row's bytes, else the element size (plain loads).
    B's strided q/k/v views at dk = 54 allow only 8 bytes in fp32 and 4 in
    bf16."""
    esize = tensors[0].element_size()
    for w in (16, 8, 4):
        if w >= esize and (row_elems * esize) % w == 0 and all(
                t.data_ptr() % w == 0 and all(st * esize % w == 0 for st in t.stride()[:-1])
                for t in tensors):
            return w
    return esize


def _mma_ld(cols: int) -> int:
    """Row stride (elements) of a bf16 tensor-core operand in shared memory:
    ``mma_ld`` of ``csrc/common.cuh``."""
    return ((cols + 15) & ~15) + 8


def flash_smem_bytes(dtype: torch.dtype, dk: int) -> int:
    """Shared memory one K1 block takes: two stages of Q, K and V (bf16 rows
    padded for ``ldmatrix``, fp32 rows for float4 reads), plus fp32's P tile.
    The kernel's own count, ``mop_flash_smem_bytes``."""
    if dtype == torch.bfloat16:
        return 6 * 64 * _mma_ld(dk) * 2
    return 6 * 64 * (((dk + 7) & ~7) + 4) * 4 + 4 * 64 * 65


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """Launch K1 on (B, H, N, dk) CUDA inputs; the output is a (B, H, N, dk)
    view of a (B, N, H, dk) buffer."""
    _check_cuda_inputs("flash_attention", q, k, v)
    b, h, n, dk = q.shape
    n_kv = k.shape[2]
    if k.shape != (b, h, n_kv, dk) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape}, {k.shape}, {v.shape}")
    if not flash_fits(dk):
        raise ValueError(f"flash_attention: dk={dk} > {FLASH_MAX_DK} is not supported")
    out = torch.empty(b, n, h, dk, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    fn = _fn("flash_fwd", "mop_flash_fwd",
             [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _I, _P])
    with torch.cuda.device(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, h, n, n_kv, dk, strides, int(causal),
                1.0 / math.sqrt(dk), copy_width((q, k, v), dk), _stream(q.device))
    _raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def _flash_bwd_recompute(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, causal: bool):
    """K1's backward, as the JAX package's ``_flash_bwd_rule``: rebuild the
    fp32 scores and softmax with plain ops and apply their VJP. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    dk = q.shape[-1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(dk)
    if causal:
        n, m = s.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    a = torch.softmax(s, -1)
    dv = torch.matmul(a.transpose(-1, -2), dof)
    da = torch.matmul(dof, vf.transpose(-1, -2))
    ds = a * (da - (da * a).sum(-1, keepdim=True)) / math.sqrt(dk)
    dq = torch.matmul(ds, kf)
    dkey = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dkey.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """K1 forward (``fwd``: the kernel or its plain version) with the
    recompute backward; saves only q, k and v."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (None, *_flash_bwd_recompute(q, k, v, do, ctx.causal), None)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise fused attention over (B, H, N, dk) or (BH, N, dk) inputs.

    K/V may have another length than Q. The causal mask is ``row >= col``,
    as in the JAX kernel. On CUDA the output is a (B, H, N, dk) view of a
    (B, N, H, dk) buffer, so merging the heads afterwards copies nothing.
    Differentiable: the backward recomputes the scores (``_flash_bwd_recompute``).
    """
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    fwd = _flash_fwd_cuda if q.is_cuda else flash_attention_plain
    if _needs_grad(q, k, v):
        out = _FlashAttention.apply(fwd, q, k, v, causal)
    else:
        out = fwd(q, k, v, causal)
    return out[0] if squeeze else out


flash_attention.launches = 0


# ------------------ K2, K3: edgewise lowrank and dense -------------------


def _edgewise_maps(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor):
    """The score algebra both gate heads share, over (B, H, V, N, dk) inputs:
    the fp32 score maps S_i, the softmaxes cast to the compute dtype Ac_i,
    log(c_fwd + 1e-6), log(c_bwd + 1e-6) and v in fp32. Products in fp32 on
    operands cast to the input dtype where the JAX kernel casts them."""
    cdt = qs.dtype
    f32 = torch.float32
    nv, dk = qs.shape[2], qs.shape[-1]

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
    return s_list, ac, torch.log(c_fwd + 1e-6), torch.log(c_bwd + 1e-6), v


def _edgewise_output_plain(s_list, ac, g, log_cf, v, beta_not, chain_w, cdt):
    """``_edgewise_output``: the gated logit mix with the four gate maps g,
    the final softmax, and y = c(att) v_0 + w Ac_0 (Ac_1 (... v_{V-1}))."""
    f32 = torch.float32
    nv = len(s_list)

    def c(x):
        return x.to(cdt).to(f32)

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
    w = torch.as_tensor(chain_w, dtype=f32, device=v.device)
    y = c(att) @ v[:, :, 0] + w * (ac[0] @ c(transport))
    return y.to(cdt)


def fused_edgewise_lowrank_attention_plain(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """The E-mode lowrank pipeline of ``_edgewise_math`` + ``_edgewise_output``
    over (B, H, V, N, dk) inputs, step for step: products in fp32 on operands
    cast to the input dtype where the JAX kernel casts them, softmaxes, gate
    head and logit algebra in fp32. Returns (B, H, N, dk) in the input dtype.

    The weights and chain_w may also carry per-program leading (B, H) axes
    (biases as (B, H, 1, 4r), chain_w as (B, H, 1, 1)), which the plain
    backward uses to get per-program weight grads."""
    f32 = torch.float32
    r = wrow.shape[-1] // 4
    s_list, ac, log_cf, log_cb, v = _edgewise_maps(qs, ks, vs)

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
    return _edgewise_output_plain(s_list, ac, g, log_cf, v, beta_not, chain_w, qs.dtype)


def fused_edgewise_dense_attention_plain(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """The E-mode dense-gate pipeline of ``_edgewise_dense_math`` +
    ``_edgewise_output`` over (B, H, V, N, dk) inputs: the per-edge feature
    stack [S_1..S_V, S_1^T..S_V^T, logC_fwd, logC_bwd] in fp32, the 1x1 head
    w1 (C, 16) -> tanh GELU -> w2 (16, 4) -> sigmoid in fp32, then the gated
    mix and the value transport as the lowrank version. Returns (B, H, N, dk)
    in the input dtype.

    The weights may also carry per-program leading (B, H, 1) axes (w1 as
    (B, H, 1, C, 16), b1 as (B, H, 1, 1, 16)), and chain_w (B, H, 1, 1),
    which the plain backward uses to get per-program weight grads."""
    f32 = torch.float32
    s_list, ac, log_cf, log_cb, v = _edgewise_maps(qs, ks, vs)
    feat = torch.stack(s_list + [s.transpose(-1, -2) for s in s_list] + [log_cf, log_cb], -1)
    hid = torch.nn.functional.gelu(feat @ w1.to(f32) + b1.to(f32), approximate="tanh")
    g = torch.sigmoid(hid @ w2.to(f32) + b2.to(f32)).unbind(-1)
    return _edgewise_output_plain(s_list, ac, g, log_cf, v, beta_not, chain_w, qs.dtype)


def _edgewise_bwd_plain(fwd_plain, lead: int, qs, ks, vs, weights, beta_not, chain_w, dy):
    """A plain backward kernel's version: the VJP of ``fwd_plain`` by
    ``torch.autograd.grad``, in the layout the kernels write.

    Returns (dq, dk, dv) as (B, H, V, N, dk) in the input dtype, then the fp32
    per-program grad of each weight, (BH, *shape) for a matrix and (BH, 1, n)
    for a bias, and dchain (BH,). The weights enter in fp32, as the kernels
    read them; each program gets its own copy (with ``lead`` singleton axes
    after (B, H)) so its grads stay apart."""
    b, h = qs.shape[:2]
    f32 = torch.float32

    def shape_of(w):
        return tuple(w.shape) if w.dim() == 2 else (1, w.shape[0])

    def per_program(t, shape):
        t = t.detach().to(f32).reshape(1, 1, *shape)
        return t.expand(b, h, *shape).clone().requires_grad_()

    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (qs, ks, vs))
        ws = [per_program(w, (1,) * lead + shape_of(w)) for w in weights]
        cw = per_program(_scalar_tensor(chain_w, qs.device), (1, 1))
        y = fwd_plain(q, k, v, *ws, beta_not, cw)
        grads = torch.autograd.grad(y, (q, k, v, *ws, cw), dy)
    dq, dk, dv = (g.contiguous() for g in grads[:3])
    dws = [g.reshape(b * h, *shape_of(w)) for g, w in zip(grads[3:-1], weights)]
    return (dq, dk, dv, *dws, grads[-1].reshape(b * h))


def _pad8_plus4(x: int) -> int:
    """Row stride, in floats, of an fp32 operand read with float4 loads:
    ``ld4`` of ``csrc/common.cuh``."""
    return ((x + 7) & ~7) + 4


def edgewise_lowrank_smem_bytes(dtype: torch.dtype, n_views: int, n: int, dk: int,
                                rank: int) -> int:
    """Shared memory one K2 program takes; the kernel's own count,
    ``mop_edgewise_lowrank_smem_bytes``.

    bf16: the V maps Ac_i and four operand buffers of 64 rows in bf16 (the
    view statistics S_0, the other views' sum and the running log-sum-exp
    stay in registers), then the pooled features, the rank factors and the
    cross-warp row and column sums (640 floats) in fp32. fp32 (two groups of 256
    threads): the V maps A_i, each group's staging area (q and k^T, then its
    chain's running product, then the transport or att and v_0, at least the
    three statistic maps the groups merge through), the features and factors
    and each warp's column sums."""
    c = 2 * n_views + 2
    if dtype == torch.bfloat16:
        bf = n_views * 64 * _mma_ld(n) + 4 * 64 * _mma_ld(max(n, dk))
        return 2 * bf + 4 * (2 * n * c + 8 * n * rank + 10 * 64)
    ldn, ldd = _pad8_plus4(n), _pad8_plus4(dk)
    area = max(n * ldd + dk * ldn, n * ldn + n * ldd)
    groups = max(2 * area, 3 * n * ldn)
    return 4 * (n_views * n * ldn + groups + 2 * n * c + 8 * n * rank + 16 * n)


DENSE_HIDDEN = 16  # the dense gate head's hidden width, fixed in the kernels
_EDGE_TILE = 16 * 17  # floats of one 16 x 16 edge tile (row stride 17) of the dense stages


def _dense_gate_floats(n_views: int) -> int:
    """The dense head's weights in shared memory: w1, b1, w2, b2."""
    return (2 * n_views + 2) * DENSE_HIDDEN + DENSE_HIDDEN + 4 * DENSE_HIDDEN + 4


def _dense_scratch_floats(n_views: int) -> int:
    """The dense backward's edge walk (``dense_gate_backward``): the features
    of a pair of 16 x 16 edge blocks (V score tiles, c_fwd and c_bwd each),
    their dS tiles, and 256 edges' staging rows (dpre, hid, dz and the
    features: 55 floats)."""
    return (4 * n_views + 4) * _EDGE_TILE + 256 * 55


def _round4(n: int) -> int:
    """Floats rounded up to a multiple of four: the dense head's weights are
    read four at a time from 16-byte-aligned shared memory."""
    return (n + 3) & ~3


def edgewise_dense_smem_bytes(dtype: torch.dtype, n_views: int, n: int, dk: int) -> int:
    """Shared memory one K3 program takes; the kernel's own count,
    ``mop_edgewise_dense_smem_bytes``. K3 runs K2's kernels with the dense
    head (``csrc/edgewise_fwd.cuh``), whose weights (16-byte aligned) take
    the place of the lowrank features and factors.

    bf16: the V maps Ac_i and four operand buffers of 64 rows in bf16, then
    the head's weights and the cross-warp row and column sums (640 floats).
    fp32: the V maps A_i (in the workspace instead where they would not fit:
    many views with wide heads) and the two thread groups' staging areas,
    then the head's weights and the log c_bwd map of the backward chain's
    group."""
    gate = _round4(_dense_gate_floats(n_views))
    if dtype == torch.bfloat16:
        bf = n_views * 64 * _mma_ld(n) + 4 * 64 * _mma_ld(max(n, dk))
        return 2 * bf + 4 * (gate + 10 * 64)
    rest, a_maps = _dense_f32_smem(n_views, n, dk)
    return rest if rest + a_maps > MAX_SMEM_BYTES else rest + a_maps


def _dense_f32_smem(n_views: int, n: int, dk: int):
    """K3's fp32 shared memory without its V maps A_i, and the maps' bytes."""
    ldn, ldd = _pad8_plus4(n), _pad8_plus4(dk)
    msz = n * ldn
    area = max(n * ldd + dk * ldn, msz + n * ldd)
    return 4 * (2 * area + msz + _round4(_dense_gate_floats(n_views))), 4 * n_views * msz


def _dense_a_in_ws(dtype: torch.dtype, n_views: int, n: int, dk: int) -> bool:
    """Whether K3's fp32 kernel keeps its V maps A_i in its workspace: where
    they do not fit in shared memory beside the rest (at N = 64: V = 5 with
    dk > 100, V >= 6 with dk >= 100, V = 8 with dk >= 80)."""
    return dtype == torch.float32 and sum(_dense_f32_smem(n_views, n, dk)) > MAX_SMEM_BYTES


def edgewise_dense_ws_bytes(dtype: torch.dtype, n_views: int, n: int, dk: int) -> int:
    """Bytes of one K3 program's device-memory workspace; the kernel's own
    count, ``mop_edgewise_dense_ws_bytes``: the V fp32 score maps, which the
    dense head reads at (i, j) and at (j, i), rows padded to a multiple of
    four floats (80 KB at V = 5, N = 64), in both dtypes; and in fp32 the V
    maps A_i where they do not fit on chip."""
    a_maps = _dense_f32_smem(n_views, n, dk)[1] if _dense_a_in_ws(dtype, n_views, n, dk) else 0
    return 4 * n_views * n * _round4(n) + a_maps


def edgewise_bwd_smem_bytes(dtype: torch.dtype, n_views: int, n: int, dk: int,
                            rank: int = 1, dense: bool = False) -> int:
    """Shared memory one K2b (lowrank, ``rank``) or K3b (``dense``) program
    takes; the kernels' own count, ``mop_edgewise_bwd_smem_bytes``.

    fp32: three fp32 staging buffers and d smix, then the four gate-logit
    cotangents (lowrank) or the dense edge walk's tiles and staging. bf16:
    seven bf16 operand buffers of 64 rows, which the gate cotangents or the
    dense edge walk reuse once the products before them are done, and d
    smix. Then the gate head's arrays: the lowrank factors and features, or
    the dense head's weights (16-byte aligned); and one float per warp."""
    ldm, c = n | 1, 2 * n_views + 2
    if dtype == torch.bfloat16:
        gate_maps = 4 * _dense_scratch_floats(n_views) if dense else 16 * n * ldm
        region = max(7 * 64 * _mma_ld(max(n, dk)) * 2, gate_maps)
        if dense:
            return region + 4 * (_round4(n * ldm) + _dense_gate_floats(n_views) + 8)
        return region + 4 * n * ldm + 4 * (4 * n * c + 16 * n * rank + 8)
    common = 3 * max(n * ldm, n * (dk | 1), dk * ldm) + n * ldm
    if dense:
        return 4 * (_round4(common + _dense_scratch_floats(n_views))
                    + _dense_gate_floats(n_views) + 8)
    return 4 * (common + 4 * n * ldm + 4 * n * c + 16 * n * rank + 8)


def edgewise_bwd_ws_bytes(dtype: torch.dtype, n_views: int, n: int, dk: int) -> int:
    """Bytes of one K2b / K3b program's device-memory workspace; the kernels'
    own count, ``mop_edgewise_bwd_ws_bytes``.

    fp32: 5V - 1 maps of N x N and V - 1 transports of N x dk, all fp32.
    bf16: the maps read in fp32 (S_i, A_i, F_{V-1}, B_{V-1}, att, dAc_i: 3V + 3
    of N x N), then in bf16 the maps only read rounded (Ac_i, F_1..F_{V-2},
    B_1..B_{V-2}: 3V - 4, rows padded to 8) and the transports P_i (V - 1 of
    N x dk, rows padded to 8)."""
    if dtype == torch.bfloat16:
        nw, dw = (n + 7) & ~7, (dk + 7) & ~7
        wf = ((3 * n_views + 3) * n * n + 3) & ~3
        return 4 * wf + 2 * ((3 * n_views - 4) * n * nw + (n_views - 1) * n * dw)
    return 4 * ((5 * n_views - 1) * n * n + (n_views - 1) * n * dk)


EDGEWISE_MAX_N, EDGEWISE_MAX_DK, EDGEWISE_MAX_VIEWS = 64, 128, 8
# K2w / K2bw take the rest of the JAX kernels' envelope (N <= 256).
WIDE_MAX_N = 256


def _edgewise_envelope(nv: int, n: int, dk: int, max_views: int = EDGEWISE_MAX_VIEWS,
                       max_n: int = EDGEWISE_MAX_N) -> bool:
    return 2 <= nv <= max_views and n <= max_n and dk <= EDGEWISE_MAX_DK


def _lowrank_one_program(dtype: torch.dtype, n_views: int, n: int, dk: int, rank: int) -> bool:
    """Whether K2 and K2b (one program a batch*head, every map on chip) take
    (V, N, dk, r) in ``dtype``."""
    return (rank >= 1 and _edgewise_envelope(n_views, n, dk)
            and edgewise_lowrank_smem_bytes(dtype, n_views, n, dk, rank) <= MAX_SMEM_BYTES
            and edgewise_bwd_smem_bytes(dtype, n_views, n, dk, rank) <= MAX_SMEM_BYTES)


def _lowrank_wide(n_views: int, n: int, dk: int, rank: int) -> bool:
    """Whether K2w and K2bw take (V, N, dk, r): above K2's N, up to 256."""
    return (rank >= 1 and n > EDGEWISE_MAX_N
            and _edgewise_envelope(n_views, n, dk, max_n=WIDE_MAX_N))


def edgewise_lowrank_fits(dtype: torch.dtype, n_views: int, n: int, dk: int,
                          rank: int) -> bool:
    """Whether the fused lowrank op's kernels take (V, N, dk, r) in
    ``dtype``: K2 for the forward and K2b for its gradient up to N = 64, each
    within its shape limits and the card's shared memory; K2w and K2bw for
    64 < N <= 256."""
    return (_lowrank_one_program(dtype, n_views, n, dk, rank)
            or _lowrank_wide(n_views, n, dk, rank))


def edgewise_wide_ws_bytes(n_views: int, n: int, dk: int, rank: int, bwd: bool) -> int:
    """Bytes of one K2w (``bwd`` False) or K2bw program's fp32 workspace; the
    kernels' own count, ``mop_edgewise_wide_ws_bytes``. Each buffer is padded
    to a multiple of four floats; N x N maps have rows of round4(N) floats,
    N x dk ones of round4(dk), the pooled features of round4(2V + 2), and
    the column factors (4r rows) and the features' cotangents (2V + 2 rows)
    are stored transposed, rows of round4(N). The forward keeps the V score
    maps S_v and softmaxes A_v, both chains' 2(V-1) maps, the means (row
    means of the V + 2 maps and their column sums by 64-row block), the
    features and factors, att, the V-1 transports and one N x dk product;
    the backward adds datt, dA_v, dS_v, the four gate-logit cotangents, d
    c_fwd and d c_bwd, two transport cotangents and the factors' and
    features' cotangents: 5.0 MB a program backward at V = 4, N = 196, dk =
    64, r = 4."""
    def r4(x):
        return (x + 3) & ~3

    nn, nd, c, r4k = n * r4(n), n * r4(dk), r4(2 * n_views + 2), 4 * rank
    nrb = (n + 63) // 64  # the products' 64-row blocks
    fwd = [n_views * nn, n_views * nn, 2 * (n_views - 1) * nn, (n_views + 2) * n,
           (n_views + 2) * nrb * n, n * c, n * c, n * r4k, r4k * r4(n), nn, (n_views - 1) * nd,
           nd]
    cn = (2 * n_views + 2) * r4(n)  # the features' cotangents, channel-major
    extra = [nn, n_views * nn, n_views * nn, 4 * nn, 2 * nn, 2 * nd, n * r4k, n * r4k, cn, cn]
    return 4 * sum(r4(x) for x in fwd + (extra if bwd else []))


def edgewise_dense_fits(dtype: torch.dtype, n_views: int, n: int, dk: int) -> bool:
    """Whether the fused dense op's kernels take (V, N, dk) in ``dtype``: K3
    for the forward and K3b for its gradient."""
    return (_edgewise_envelope(n_views, n, dk)
            and edgewise_dense_smem_bytes(dtype, n_views, n, dk) <= MAX_SMEM_BYTES
            and edgewise_bwd_smem_bytes(dtype, n_views, n, dk, dense=True) <= MAX_SMEM_BYTES)


def _check_smem(name, smem, nv, n, dk):
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: V={nv}, N={n}, dk={dk} needs {smem} bytes of shared "
                         f"memory, more than {MAX_SMEM_BYTES}")


def _edgewise_shapes(name, qs, ks, vs, wrow, brow, wcol, bcol, max_views, smem_fn,
                     max_n=EDGEWISE_MAX_N):
    """(B, H, V, N, dk, r) of a K2 / K2b (or, with ``max_n``, K2w / K2bw)
    call; raises outside the kernel's shapes."""
    b, h, nv, n, dk = qs.shape
    if ks.shape != qs.shape or vs.shape != qs.shape:
        raise ValueError(f"{name}: shapes {qs.shape}, {ks.shape}, {vs.shape}")
    c4 = wrow.shape[1]
    if (wrow.shape != (2 * nv + 2, c4) or wcol.shape != wrow.shape or c4 % 4
            or brow.shape != (c4,) or bcol.shape != (c4,)):
        raise ValueError(f"{name}: gate-head shapes {wrow.shape}, {brow.shape}, "
                         f"{wcol.shape}, {bcol.shape} for {nv} views")
    rank = c4 // 4
    if rank < 1 or not _edgewise_envelope(nv, n, dk, max_views, max_n):
        raise ValueError(f"{name}: V={nv}, N={n}, dk={dk}, r={rank} outside the "
                         f"kernel's shapes (2 <= V <= {max_views}, N <= {max_n}, "
                         f"dk <= {EDGEWISE_MAX_DK}, r >= 1)")
    _check_smem(f"{name} (r={rank})", smem_fn(nv, n, dk, rank), nv, n, dk)
    return b, h, nv, n, dk, rank


def _dense_shapes(name, qs, ks, vs, w1, b1, w2, b2, smem_fn):
    """(B, H, V, N, dk) of a K3 / K3b call; raises outside the kernels' shapes."""
    b, h, nv, n, dk = qs.shape
    if ks.shape != qs.shape or vs.shape != qs.shape:
        raise ValueError(f"{name}: shapes {qs.shape}, {ks.shape}, {vs.shape}")
    hd = DENSE_HIDDEN
    if (w1.shape != (2 * nv + 2, hd) or b1.shape != (hd,) or w2.shape != (hd, 4)
            or b2.shape != (4,)):
        raise ValueError(f"{name}: gate-head shapes {w1.shape}, {b1.shape}, {w2.shape}, "
                         f"{b2.shape} for {nv} views (the kernels take a 2V+2 -> {hd} -> 4 "
                         "head)")
    if not _edgewise_envelope(nv, n, dk):
        raise ValueError(f"{name}: V={nv}, N={n}, dk={dk} outside the kernel's shapes "
                         f"(2 <= V <= {EDGEWISE_MAX_VIEWS}, N <= {EDGEWISE_MAX_N}, "
                         f"dk <= {EDGEWISE_MAX_DK})")
    _check_smem(name, smem_fn(nv, n, dk), nv, n, dk)
    return b, h, nv, n, dk


def _fp32_weights(device, *ts):
    return [t.detach().to(device=device, dtype=torch.float32).contiguous() for t in ts]


def _scalar_tensor(x, device) -> torch.Tensor:
    """A scalar argument (chain_w, the quartet mix) as a tensor: a tensor as
    it is, a number as an fp32 0-dim tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _in_strides(qs, ks, vs, last):
    """The 15 element strides the edgewise kernels take: (b, h, view, row) of
    qs, ks and vs, then (b, h, row) of ``last`` (the output or dy)."""
    return (ctypes.c_longlong * 15)(
        *qs.stride()[:4], *ks.stride()[:4], *vs.stride()[:4], *last.stride()[:3])


def _edgewise_fwd_cuda(qs, ks, vs, wrow, brow, wcol, bcol, beta_not, chain_w):
    """Launch K2 on CUDA inputs; the output is a view of a (B, N, H, dk) buffer."""
    name = "fused_edgewise_lowrank_attention"
    _check_cuda_inputs(name, qs, ks, vs)
    b, h, nv, n, dk, rank = _edgewise_shapes(
        name, qs, ks, vs, wrow, brow, wcol, bcol, 1 << 30,
        lambda *shape: edgewise_lowrank_smem_bytes(qs.dtype, *shape))
    ws = _fp32_weights(qs.device, wrow, brow, wcol, bcol, chain_w.reshape(1))
    out = torch.empty(b, n, h, dk, dtype=qs.dtype, device=qs.device).transpose(1, 2)
    fn = _fn("edgewise_lowrank_fwd", "mop_edgewise_lowrank_fwd",
             [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _P, _F, _F, _I, _P])
    with torch.cuda.device(qs.device):
        rc = fn(_DTYPE_CODE[qs.dtype], qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                out.data_ptr(), *(t.data_ptr() for t in ws),
                b, h, nv, n, dk, rank, _in_strides(qs, ks, vs, out), float(beta_not),
                1.0 / math.sqrt(dk), copy_width((qs, ks, vs), dk), _stream(qs.device))
    _raise_on(rc, name)
    fused_edgewise_lowrank_attention.launches += 1
    return out


def _dense_fwd_cuda(qs, ks, vs, w1, b1, w2, b2, beta_not, chain_w):
    """Launch K3 on CUDA inputs; the output is a view of a (B, N, H, dk) buffer.
    The kernel writes its V score maps to a per-program fp32 workspace in
    device memory (80 KB a program at V = 5, N = 64), allocated here."""
    name = "fused_edgewise_dense_attention"
    _check_cuda_inputs(name, qs, ks, vs)
    b, h, nv, n, dk = _dense_shapes(name, qs, ks, vs, w1, b1, w2, b2,
                                    lambda *shape: edgewise_dense_smem_bytes(qs.dtype, *shape))
    dev = qs.device
    ws = _fp32_weights(dev, w1, b1, w2, b2, chain_w.reshape(1))
    out = torch.empty(b, n, h, dk, dtype=qs.dtype, device=dev).transpose(1, 2)
    workspace = torch.empty(b * h * edgewise_dense_ws_bytes(qs.dtype, nv, n, dk),
                            dtype=torch.uint8, device=dev)
    fn = _fn("edgewise_dense_fwd", "mop_edgewise_dense_fwd",
             [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _P, _F, _F, _I, _P])
    with torch.cuda.device(dev):
        rc = fn(_DTYPE_CODE[qs.dtype], qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                out.data_ptr(), *(t.data_ptr() for t in ws), workspace.data_ptr(),
                b, h, nv, n, dk, _in_strides(qs, ks, vs, out), float(beta_not),
                1.0 / math.sqrt(dk), copy_width((qs, ks, vs), dk), _stream(dev))
    _raise_on(rc, name)
    fused_edgewise_dense_attention.launches += 1
    return out


def _edgewise_bwd_cuda(name, sym, qs, ks, vs, weights, beta_not, chain_w, dy, dims):
    """Launch the backward kernel ``sym`` of ``csrc/edgewise_bwd.cu`` (K2b or
    K3b) on CUDA inputs whose shapes the caller has checked; ``dims`` are the
    kernel's int arguments after the pointers. Returns (dq, dk, dv) and the
    fp32 per-program grads of each weight and of chain_w."""
    b, h, nv, n, dk = qs.shape
    dev, bh, f32 = qs.device, b * h, torch.float32
    ws = _fp32_weights(dev, *weights, _scalar_tensor(chain_w, dev).reshape(1))
    dq, dkey, dv = (torch.empty(b, h, nv, n, dk, dtype=qs.dtype, device=dev)
                    for _ in range(3))
    dws = [torch.empty(bh, *(w.shape if w.dim() == 2 else (1, w.shape[0])), dtype=f32,
                       device=dev) for w in weights]
    dws.append(torch.empty(bh, dtype=f32, device=dev))
    workspace = torch.empty(bh * edgewise_bwd_ws_bytes(qs.dtype, nv, n, dk), dtype=torch.uint8,
                            device=dev)
    fn = _fn("edgewise_bwd", sym, [_I] + [_P] * 18 + [_I] * len(dims) + [_P, _F, _F, _I, _P])
    with torch.cuda.device(dev):
        rc = fn(_DTYPE_CODE[qs.dtype], qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                dy.data_ptr(), dq.data_ptr(), dkey.data_ptr(), dv.data_ptr(),
                *(t.data_ptr() for t in ws), *(t.data_ptr() for t in dws),
                workspace.data_ptr(), *dims, _in_strides(qs, ks, vs, dy), float(beta_not),
                1.0 / math.sqrt(dk), copy_width((qs, ks, vs, dy), dk), _stream(dev))
    _raise_on(rc, name)
    return (dq, dkey, dv, *dws)


def edgewise_lowrank_wide_fwd(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """K2w: the forward of ``fused_edgewise_lowrank_attention`` as stages over
    a per-program fp32 workspace in device memory (``edgewise_wide_ws_bytes``),
    for 2 <= V <= 8, N <= 256, dk <= 128; it raises outside them. On a CPU
    tensor it is the plain version. The output is a view of a (B, N, H, dk)
    buffer."""
    if not qs.is_cuda:
        return fused_edgewise_lowrank_attention_plain(qs, ks, vs, wrow, brow, wcol, bcol,
                                                      beta_not, chain_w)
    name = "edgewise_lowrank_wide_fwd"
    _check_cuda_inputs(name, qs, ks, vs)
    b, h, nv, n, dk, rank = _edgewise_shapes(name, qs, ks, vs, wrow, brow, wcol, bcol,
                                             EDGEWISE_MAX_VIEWS, lambda *shape: 0, WIDE_MAX_N)
    dev = qs.device
    ws = _fp32_weights(dev, wrow, brow, wcol, bcol,
                       _scalar_tensor(chain_w, dev).reshape(1))
    out = torch.empty(b, n, h, dk, dtype=qs.dtype, device=dev).transpose(1, 2)
    nbytes = b * h * edgewise_wide_ws_bytes(nv, n, dk, rank, False)
    workspace = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    fn = _fn("edgewise_wide", "mop_edgewise_wide_fwd",
             [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
              _I, _I, _I, _I, _I, _I, _P, _F, _F, _P])
    with torch.cuda.device(dev):
        rc = fn(_DTYPE_CODE[qs.dtype], qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                out.data_ptr(), *(t.data_ptr() for t in ws), workspace.data_ptr(), nbytes,
                b, h, nv, n, dk, rank, _in_strides(qs, ks, vs, out), float(beta_not),
                1.0 / math.sqrt(dk), _stream(dev))
    _raise_on(rc, name)
    edgewise_lowrank_wide_fwd.launches += 1
    return out


edgewise_lowrank_wide_fwd.launches = 0


def edgewise_lowrank_wide_bwd(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float], dy: torch.Tensor,
):
    """K2bw: the backward of ``fused_edgewise_lowrank_attention`` for the
    cotangent ``dy`` (B, H, N, dk), as stages (the forward's, then the
    hand-derived VJP) over a per-program workspace, with the outputs of
    ``fused_edgewise_lowrank_attention_bwd_plain``: dq, dk, dv contiguous in
    the input dtype and the fp32 per-program weight and chain grads. Shapes
    as K2w's; on a CPU tensor it is the plain version."""
    if not qs.is_cuda:
        return fused_edgewise_lowrank_attention_bwd_plain(
            qs, ks, vs, wrow, brow, wcol, bcol, beta_not, chain_w, dy)
    name = "edgewise_lowrank_wide_bwd"
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    _check_cuda_inputs(name, qs, ks, vs, dy)
    b, h, nv, n, dk, rank = _edgewise_shapes(name, qs, ks, vs, wrow, brow, wcol, bcol,
                                             EDGEWISE_MAX_VIEWS, lambda *shape: 0, WIDE_MAX_N)
    if dy.shape != (b, h, n, dk):
        raise ValueError(f"{name}: dy shape {dy.shape}, expected {(b, h, n, dk)}")
    dev, bh, f32 = qs.device, b * h, torch.float32
    ws = _fp32_weights(dev, wrow, brow, wcol, bcol,
                       _scalar_tensor(chain_w, dev).reshape(1))
    dq, dkey = (torch.empty(b, h, nv, n, dk, dtype=qs.dtype, device=dev) for _ in range(2))
    dv = torch.zeros(b, h, nv, n, dk, dtype=qs.dtype, device=dev)  # views 1..V-2 get none
    c, r4 = 2 * nv + 2, 4 * rank
    dws = [torch.empty(bh, c, r4, dtype=f32, device=dev), torch.empty(bh, 1, r4, dtype=f32,
                                                                      device=dev),
           torch.empty(bh, c, r4, dtype=f32, device=dev), torch.empty(bh, 1, r4, dtype=f32,
                                                                      device=dev),
           torch.empty(bh, dtype=f32, device=dev)]
    nbytes = bh * edgewise_wide_ws_bytes(nv, n, dk, rank, True)
    workspace = torch.empty(nbytes // 4, dtype=f32, device=dev)
    fn = _fn("edgewise_wide", "mop_edgewise_wide_bwd",
             [_I] + [_P] * 18 + [ctypes.c_longlong] + [_I] * 6 + [_P, _F, _F, _P])
    with torch.cuda.device(dev):
        rc = fn(_DTYPE_CODE[qs.dtype], qs.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                dy.data_ptr(), dq.data_ptr(), dkey.data_ptr(), dv.data_ptr(),
                *(t.data_ptr() for t in ws), *(t.data_ptr() for t in dws),
                workspace.data_ptr(), nbytes, b, h, nv, n, dk, rank,
                _in_strides(qs, ks, vs, dy), float(beta_not), 1.0 / math.sqrt(dk), _stream(dev))
    _raise_on(rc, name)
    edgewise_lowrank_wide_bwd.launches += 1
    return (dq, dkey, dv, *dws)


edgewise_lowrank_wide_bwd.launches = 0


def fused_edgewise_lowrank_attention_bwd_plain(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float], dy: torch.Tensor,
):
    """K2b's plain version: the VJP of ``fused_edgewise_lowrank_attention_plain``
    by ``torch.autograd.grad``, in the layout the kernel writes.

    Returns (dq, dk, dv) as (B, H, V, N, dk) in the input dtype, then the
    fp32 per-program grads dwrow (BH, C, 4r), dbrow (BH, 1, 4r), dwcol,
    dbcol and dchain (BH,).
    """
    return _edgewise_bwd_plain(fused_edgewise_lowrank_attention_plain, 0, qs, ks, vs,
                               (wrow, brow, wcol, bcol), beta_not, chain_w, dy)


def fused_edgewise_lowrank_attention_bwd(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float], dy: torch.Tensor,
):
    """K2b: the backward of ``fused_edgewise_lowrank_attention`` for the
    cotangent ``dy`` (B, H, N, dk), with the per-program outputs of
    ``fused_edgewise_lowrank_attention_bwd_plain``.

    On CUDA it supports 2 <= V <= 8, N <= 64, dk <= 128 within the card's
    shared memory and raises outside them. q/k/v and dy may have any strides
    with a contiguous feature axis; dq/dk/dv come back contiguous. The kernel
    works in a per-program workspace in device memory
    (``edgewise_bwd_ws_bytes``: 450,560 bytes per program in fp32 and 413,696
    in bf16 at V = 5, N = 64, dk = 56), allocated here for each call. In bf16
    its products run on the tensor cores and round their cotangents where
    the plain backward does (``csrc/edgewise_bwd.cu``).
    """
    if not qs.is_cuda:
        return fused_edgewise_lowrank_attention_bwd_plain(
            qs, ks, vs, wrow, brow, wcol, bcol, beta_not, chain_w, dy)
    name = "fused_edgewise_lowrank_attention_bwd"
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    _check_cuda_inputs(name, qs, ks, vs, dy)
    b, h, nv, n, dk, rank = _edgewise_shapes(
        name, qs, ks, vs, wrow, brow, wcol, bcol, 8,
        lambda *shape: edgewise_bwd_smem_bytes(qs.dtype, *shape))
    if dy.shape != (b, h, n, dk):
        raise ValueError(f"{name}: dy shape {dy.shape}, expected {(b, h, n, dk)}")
    out = _edgewise_bwd_cuda(name, "mop_edgewise_lowrank_bwd", qs, ks, vs,
                             (wrow, brow, wcol, bcol), beta_not, chain_w, dy,
                             (b, h, nv, n, dk, rank))
    fused_edgewise_lowrank_attention_bwd.launches += 1
    return out


fused_edgewise_lowrank_attention_bwd.launches = 0


def fused_edgewise_dense_attention_bwd_plain(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float], dy: torch.Tensor,
):
    """K3b's plain version: the VJP of ``fused_edgewise_dense_attention_plain``
    by ``torch.autograd.grad``, in the layout the kernel writes.

    Returns (dq, dk, dv) as (B, H, V, N, dk) in the input dtype, then the
    fp32 per-program grads dw1 (BH, C, 16), db1 (BH, 1, 16), dw2 (BH, 16, 4),
    db2 (BH, 1, 4) and dchain (BH,).
    """
    return _edgewise_bwd_plain(fused_edgewise_dense_attention_plain, 1, qs, ks, vs,
                               (w1, b1, w2, b2), beta_not, chain_w, dy)


def fused_edgewise_dense_attention_bwd(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float], dy: torch.Tensor,
):
    """K3b: the backward of ``fused_edgewise_dense_attention`` for the
    cotangent ``dy`` (B, H, N, dk), with the per-program outputs of
    ``fused_edgewise_dense_attention_bwd_plain``.

    On CUDA it supports 2 <= V <= 8, N <= 64, dk <= 128 and a 2V+2 -> 16 -> 4
    head, and raises outside them; strides and workspace as K2b's.
    """
    if not qs.is_cuda:
        return fused_edgewise_dense_attention_bwd_plain(
            qs, ks, vs, w1, b1, w2, b2, beta_not, chain_w, dy)
    name = "fused_edgewise_dense_attention_bwd"
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    _check_cuda_inputs(name, qs, ks, vs, dy)
    b, h, nv, n, dk = _dense_shapes(
        name, qs, ks, vs, w1, b1, w2, b2,
        lambda *shape: edgewise_bwd_smem_bytes(qs.dtype, *shape, dense=True))
    if dy.shape != (b, h, n, dk):
        raise ValueError(f"{name}: dy shape {dy.shape}, expected {(b, h, n, dk)}")
    out = _edgewise_bwd_cuda(name, "mop_edgewise_dense_bwd", qs, ks, vs, (w1, b1, w2, b2),
                             beta_not, chain_w, dy, (b, h, nv, n, dk))
    fused_edgewise_dense_attention_bwd.launches += 1
    return out


fused_edgewise_dense_attention_bwd.launches = 0


class EdgewiseFunction(torch.autograd.Function):
    """An edgewise forward with its backward over a flat weight list, as the
    JAX package's ``_edgewise_custom_op``: K2 with K2b, or K3 with K3b.

    ``fwd`` and ``bwd`` are the launchers (the kernels on the card, or their
    plain versions), called as ``fwd(qs, ks, vs, *weights, beta_not,
    chain_w)``. Only the inputs are saved; the backward recomputes the rest.
    The per-program weight and chain-weight grads are summed here with
    ``torch.sum`` (deterministic, no atomics), and every grad comes back in
    its input's dtype.
    """

    @staticmethod
    def forward(ctx, fwd, bwd, beta_not, qs, ks, vs, chain_w, *weights):
        ctx.save_for_backward(qs, ks, vs, chain_w, *weights)
        ctx.bwd, ctx.beta_not = bwd, beta_not
        return fwd(qs, ks, vs, *weights, beta_not, chain_w)

    @staticmethod
    def backward(ctx, dy):
        qs, ks, vs, chain_w, *weights = ctx.saved_tensors
        dq, dk, dv, *dws, dch = ctx.bwd(qs, ks, vs, *weights, ctx.beta_not, chain_w, dy)
        sums = [torch.sum(g, 0 if w.dim() > 1 else (0, 1)).to(w.dtype)
                for w, g in zip(weights, dws)]
        return (None, None, None, dq, dk, dv,
                torch.sum(dch).to(chain_w.dtype).reshape(chain_w.shape), *sums)


def _edgewise_op(fwd, bwd, qs, ks, vs, weights, beta_not, chain_w):
    chain_w = _scalar_tensor(chain_w, qs.device)
    if _needs_grad(qs, ks, vs, chain_w, *weights):
        return EdgewiseFunction.apply(fwd, bwd, beta_not, qs, ks, vs, chain_w, *weights)
    return fwd(qs, ks, vs, *weights, beta_not, chain_w)


def fused_edgewise_lowrank_attention(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    wrow: torch.Tensor, brow: torch.Tensor, wcol: torch.Tensor, bcol: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """Fully fused E-mode lowrank attention, differentiable end to end.

    qs/ks/vs: (B, H, V, N, dk) per-view tensors (any strides with a contiguous
    feature axis); wrow/wcol: (2V+2, 4r) gate-head kernels; brow/bcol: (4r,);
    chain_w: the sigmoid'd chain-value weight. Returns (B, H, N, dk). On CUDA
    the forward is K2 and the backward K2b where they take the shape
    (2 <= V <= 8, N <= 64, dk <= 128 within the card's shared memory), else
    K2w and K2bw (N <= 256); it raises outside them. The output is a view of
    a (B, N, H, dk) buffer.
    """
    b, h, nv, n, dk = qs.shape
    if qs.is_cuda and not _lowrank_one_program(qs.dtype, nv, n, dk, wrow.shape[-1] // 4):
        fwd, bwd = edgewise_lowrank_wide_fwd, edgewise_lowrank_wide_bwd
    elif qs.is_cuda:
        fwd, bwd = _edgewise_fwd_cuda, fused_edgewise_lowrank_attention_bwd
    else:
        fwd, bwd = (fused_edgewise_lowrank_attention_plain,
                    fused_edgewise_lowrank_attention_bwd_plain)
    return _edgewise_op(fwd, bwd, qs, ks, vs, (wrow, brow, wcol, bcol), beta_not, chain_w)


fused_edgewise_lowrank_attention.launches = 0


def fused_edgewise_dense_attention(
    qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    beta_not: float, chain_w: Union[torch.Tensor, float],
    wk3: Optional[torch.Tensor] = None, bk3: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fully fused E-mode dense-gate attention, differentiable end to end.

    qs/ks/vs: (B, H, V, N, dk) per-view tensors (any strides with a contiguous
    feature axis); w1/b1: the 1x1 input conv as a (2V+2, 16) matmul and its
    bias; w2/b2: the 1x1 output head (16, 4) and its bias; chain_w: the
    sigmoid'd chain-value weight. Returns (B, H, N, dk). On CUDA the forward
    is K3 and the backward K3b, for 2 <= V <= 8, N <= 64, dk <= 128 (they
    raise outside them); the output is a view of a (B, N, H, dk) buffer.

    The 3x3 mid conv of ``use_k3`` (wk3/bk3) has no fused form, as in the JAX
    package, whose op returns None for it so that the caller composes; here
    the caller composes without calling the op, which raises if given wk3.
    """
    if wk3 is not None or bk3 is not None:
        raise ValueError("fused_edgewise_dense_attention: the use_k3 mid conv has no fused "
                         "kernel; EdgewiseMSA composes that head")
    if qs.is_cuda:
        fwd, bwd = _dense_fwd_cuda, fused_edgewise_dense_attention_bwd
    else:
        fwd, bwd = fused_edgewise_dense_attention_plain, fused_edgewise_dense_attention_bwd_plain
    return _edgewise_op(fwd, bwd, qs, ks, vs, (w1, b1, w2, b2), beta_not, chain_w)


fused_edgewise_dense_attention.launches = 0


# ----------------------- K4: multi-hop (dual-path) -----------------------

MULTIHOP_MAX_N, MULTIHOP_MAX_DK = 64, 128


def multihop_fits(n: int, dk: int, hops: int) -> bool:
    """Whether K4 takes N tokens of heads of width ``dk`` at ``hops``."""
    return n <= MULTIHOP_MAX_N and dk <= MULTIHOP_MAX_DK and hops >= 2


def multihop_smem_bytes(dtype: torch.dtype, n: int, dk: int) -> int:
    """Shared memory one K4 block takes at (N, dk); the kernel's own count,
    ``mop_multihop_smem_bytes``. fp32 (``F32Layout``): [att | C] (N rows of
    2 np + 4 floats, np = N rounded up to 4), A1 (N rows of np + 4), A2 (np
    rows of np + 4) after both groups' q and k where those reach further,
    then the stacked [v1 ; v2] (2 np rows of ``ld4(dk)``) in a space of its
    own. bf16: four N x N fp32 maps and two N x dk staging buffers at an odd
    row stride."""
    if dtype == torch.bfloat16:
        return 4 * (4 * n * (n | 1) + 2 * n * (dk | 1))
    np4, lq = _round4(n), _pad8_plus4(dk)
    lm, lp = np4 + 4, 2 * np4 + 4
    att, qk = n * lp, 2 * n * lq  # qk: one group's q and k
    a2 = max(att + n * lm, qk)
    v = max(a2 + np4 * lm, max(qk, att) + qk)
    return 4 * (v + 2 * np4 * lq)


def _gate_values(gates: dict):
    """(base, and, or, not, chain) as the JAX kernel reads them: ``.get``
    with its defaults."""
    return (float(gates.get("base", 1.0)), float(gates.get("and_", 1.0)),
            float(gates.get("or_", 0.0)), float(gates.get("not_", 0.0)),
            float(gates.get("chain", 0.0)))


def fused_multihop_attention_plain(
    q1: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
    q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
    gates: dict, beta_not: float, hops: int, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """``_multihop_kernel`` over (..., N, dk) inputs, step for step: q * scale
    rounded to the compute dtype, fp32 scores, the softmaxes cast to the
    compute dtype (A1c, A2c), C = A1c A2c with the chain recast before each
    further hop, the gated mix in fp32 (``base`` scales S1), the final
    softmax, the transport from v2 recast at each hop, and
    y = c(att) v1 + w A1c c(transport) in fp32, cast once."""
    cdt, f32 = q1.dtype, torch.float32

    def c(x):  # the compute-dtype cast before a product
        return x.to(cdt).to(f32)

    sc = torch.tensor(1.0 / math.sqrt(q1.shape[-1]), dtype=cdt)
    s1 = (q1 * sc).to(f32) @ k1.to(f32).transpose(-1, -2)
    s2 = (q2 * sc).to(f32) @ k2.to(f32).transpose(-1, -2)
    a1c, a2c = c(torch.softmax(s1, -1)), c(torch.softmax(s2, -1))
    c_fwd = a1c @ a2c
    for _ in range(max(0, hops - 2)):
        c_fwd = c(c_fwd) @ a2c
    base, g_and, g_or, g_not, g_chain = _gate_values(gates)
    smix = base * s1
    smix = smix + g_and * s2
    smix = smix + g_or * (torch.logaddexp(s1, s2) - s1)
    smix = smix - g_not * (beta_not * s2)
    smix = smix + g_chain * torch.log(c_fwd + 1e-6)
    att = torch.softmax(smix, -1)
    transport = v2.to(f32)
    for _ in range(max(0, hops - 1)):
        transport = a2c @ c(transport)
    w = torch.as_tensor(chain_w, dtype=f32, device=q1.device)
    y = c(att) @ v1.to(f32) + w * (a1c @ c(transport))
    return y.to(cdt)


def _multihop_reference(q1, k1, v1, q2, k2, v2, chain_w, gates, beta_not, hops):
    """The JAX op's composed ``reference`` (what its backward differentiates):
    fp32 scores and softmaxes, the chain in fp32, ``multihop_logit_mix`` plus
    (base - 1) S1, and the value products."""
    s1, s2 = A.scaled_scores(q1, k1), A.scaled_scores(q2, k2)
    a1, a2 = torch.softmax(s1, -1), torch.softmax(s2, -1)
    c_fwd = A.chain_product([a1] + [a2] * (hops - 1))
    smix = A.multihop_logit_mix(s1, s2, c_fwd, gates, beta_not)
    base = gates.get("base", 1.0)
    if base != 1.0:
        smix = smix + (base - 1.0) * s1
    a = torch.softmax(smix, -1)
    transport = v2.float()
    for _ in range(max(0, hops - 1)):
        transport = a2 @ transport
    y_chain = a1 @ transport
    out = (a.to(v1.dtype) @ v1).float() + chain_w * y_chain
    return out.to(q1.dtype)


def _multihop_fwd_cuda(q1, k1, v1, q2, k2, v2, gates, beta_not, hops, chain_w):
    """Launch K4 on (B, H, N, dk) CUDA inputs; the output is a (B, H, N, dk)
    view of a (B, N, H, dk) buffer."""
    name = "fused_multihop_attention"
    ins = (q1, k1, v1, q2, k2, v2)
    _check_cuda_inputs(name, *ins)
    b, h, n, dk = q1.shape
    if any(t.shape != q1.shape for t in ins):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ins]}")
    if not multihop_fits(n, dk, hops):
        raise ValueError(f"{name}: N={n}, dk={dk}, hops={hops} outside the kernel's shapes "
                         f"(N <= {MULTIHOP_MAX_N}, dk <= {MULTIHOP_MAX_DK}, hops >= 2)")
    dev = q1.device
    w = _fp32_weights(dev, _scalar_tensor(chain_w, dev).reshape(1))[0]
    out = torch.empty(b, n, h, dk, dtype=q1.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 21)(*(s for t in (*ins, out) for s in t.stride()[:3]))
    fn = _fn("multihop_fwd", "mop_multihop_fwd",
             [_I] + [_P] * 8 + [_I] * 5 + [_P] + [_F] * 7 + [_I, _P])
    with torch.cuda.device(dev):
        rc = fn(_DTYPE_CODE[q1.dtype], *(t.data_ptr() for t in ins), out.data_ptr(),
                w.data_ptr(), b, h, n, dk, int(hops), strides, *_gate_values(gates),
                float(beta_not), 1.0 / math.sqrt(dk), copy_width(ins, dk), _stream(dev))
    _raise_on(rc, name)
    fused_multihop_attention.launches += 1
    return out


class _RecomputeFunction(torch.autograd.Function):
    """A fused forward ``fwd(*ins)`` (the kernel or its plain version) whose
    backward is autograd through the composed reference ``ref(*ins)``, as
    the JAX ops' recompute ``bwd_rule``s (K4, K5). Saves only its inputs."""

    @staticmethod
    def forward(ctx, fwd, ref, *ins):
        ctx.save_for_backward(*ins)
        ctx.ref = ref
        return fwd(*ins)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = torch.autograd.grad(ctx.ref(*ins), ins, dy)
        return (None, None, *grads)


def fused_multihop_attention(
    q1: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor,
    q2: torch.Tensor, k2: torch.Tensor, v2: torch.Tensor,
    gates: dict, beta_not: float, hops: int, chain_w: Union[torch.Tensor, float],
) -> torch.Tensor:
    """Fully fused D-mode attention over (B, H, N, dk) inputs:
    ``softmax(mix(S1, S2, log C)) v1 + w A1 A2^(hops-1) v2`` with
    C = A1 A2^(hops-1) and ``gates`` read with ``.get`` defaults (base 1,
    and 1, or 0, not 0, chain 0); ``chain_w`` is the sigmoid'd chain-value
    weight.

    On CUDA the forward is K4 (``csrc/multihop_fwd.cu``) for N <= 64,
    dk <= 128 and any hops >= 2 (it raises outside them); the inputs may have
    any strides with a contiguous feature axis, and the output is a view of
    a (B, N, H, dk) buffer. Differentiable: the backward recomputes through
    the composed reference (``_multihop_reference``), as the JAX op's.
    """
    chain_w = _scalar_tensor(chain_w, q1.device)
    gates = dict(gates)
    fwd = _multihop_fwd_cuda if q1.is_cuda else fused_multihop_attention_plain
    ins = (q1, k1, v1, q2, k2, v2, chain_w)
    if _needs_grad(*ins):
        return _RecomputeFunction.apply(
            lambda *t: fwd(*t[:6], gates, beta_not, hops, t[6]),
            lambda *t: _multihop_reference(*t, gates, beta_not, hops), *ins)
    return fwd(q1, k1, v1, q2, k2, v2, gates, beta_not, hops, chain_w)


fused_multihop_attention.launches = 0


# ---------------------------- K5: quartet ----------------------------

QUARTET_MAX_DK = 128


def quartet_fits(dk: int) -> bool:
    """Whether K5 takes heads of width ``dk`` (it takes any N)."""
    return dk <= QUARTET_MAX_DK


def _quartet_rows_bytes(dtype: torch.dtype, n: int, dk: int) -> int:
    """Shared memory of K5's kept-rows kernels: q and q2, then in fp32 (64
    query rows) one block of 64 keys of k and of k2 (two of v in pass 2),
    fp32 rows read as float4, in bf16 (32 query rows) two stages of 32 keys
    of both, bf16 rows for ``ldmatrix``; then the kept S1 and S2 rows in
    fp32 over every block of 64 keys (row stride 8 floats past it)."""
    lr = -(-n // 64) * 64 + 8
    if dtype == torch.bfloat16:
        return (2 * 32 + 4 * 32) * 2 * _mma_ld(dk) + 4 * 2 * 32 * lr
    return (2 * 64 + 2 * 64) * 4 * _pad8_plus4(dk) + 4 * 2 * 64 * lr


def quartet_keeps_rows(dtype: torch.dtype, n: int, dk: int) -> bool:
    """Whether K5 keeps each query block's raw score rows on chip (every
    score tile computed once) at (N, dk) in ``dtype``; above, it streams the
    keys twice and recomputes the causal tiles. The kernel's own rule,
    ``mop_quartet_keeps_rows``: at dk = 80, fp32 up to N = 256 and bf16 up
    to N = 768."""
    return _quartet_rows_bytes(dtype, n, dk) <= MAX_SMEM_BYTES


def quartet_smem_bytes(dtype: torch.dtype, n: int, dk: int) -> int:
    """Shared memory one K5 block takes at (N, dk); the kernel's own count,
    ``mop_quartet_smem_bytes``: the kept-rows kernel's where its rows fit,
    else the streaming kernel's (q, q2, k and k2 blocks of 64 rows at an
    odd row stride in fp32, and a 64 x 65 probability tile)."""
    if quartet_keeps_rows(dtype, n, dk):
        return _quartet_rows_bytes(dtype, n, dk)
    return 4 * (4 * 64 * (dk | 1) + 64 * 65)


def fused_quartet_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q2: torch.Tensor, k2: torch.Tensor,
    mixture: Union[torch.Tensor, float], quartet_scale: Union[torch.Tensor, float],
    eps: float = 1e-5,
) -> torch.Tensor:
    """``_quartet_kernel`` over (..., N, dk) inputs: q * scale rounded to the
    compute dtype, fp32 scores, each map standardized per row over every
    column (unbiased variance, eps after the sqrt) before the causal mask,
    ``(1 - m) S1n + m (S1n * S2n) qscale``, the causal mask, the softmax, and
    the probabilities cast to the compute dtype before the value product."""
    cdt, f32 = q.dtype, torch.float32
    n, dk = q.shape[-2:]

    def standardize(s):
        mu = s.mean(-1, keepdim=True)
        var = (s - mu).square().sum(-1, keepdim=True) / max(1, n - 1)
        return (s - mu) / (torch.sqrt(var) + eps)

    sc = torch.tensor(1.0 / math.sqrt(dk), dtype=cdt)
    s1 = standardize((q * sc).to(f32) @ k.to(f32).transpose(-1, -2))
    s2 = standardize((q2 * sc).to(f32) @ k2.to(f32).transpose(-1, -2))
    m = torch.as_tensor(mixture, dtype=f32, device=q.device)
    qs = torch.as_tensor(quartet_scale, dtype=f32, device=q.device)
    scores = (1.0 - m) * s1 + m * (s1 * s2) * qs
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    att = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1)
    return (att.to(cdt).to(f32) @ v.to(f32)).to(cdt)


def _quartet_reference(q, k, v, q2, k2, mixture, quartet_scale, eps):
    """The JAX ``_quartet_reference`` (what its backward differentiates)."""
    n = q.shape[-2]
    s1 = A.standardize_scores(A.scaled_scores(q, k), eps)
    s2 = A.standardize_scores(A.scaled_scores(q2, k2), eps)
    scores = (1.0 - mixture) * s1 + mixture * (s1 * s2) * quartet_scale
    scores = A.apply_mask(scores, A.causal_mask(n, device=q.device))
    a = torch.softmax(scores, -1)
    return a.to(v.dtype) @ v


def _quartet_fwd_cuda(q, k, v, q2, k2, mixture, quartet_scale, eps):
    """Launch K5 on (B, H, N, dk) CUDA inputs; the output is a (B, H, N, dk)
    view of a (B, N, H, dk) buffer."""
    name = "fused_quartet_attention"
    ins = (q, k, v, q2, k2)
    _check_cuda_inputs(name, *ins)
    b, h, n, dk = q.shape
    if any(t.shape != q.shape for t in ins):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ins]}")
    if not quartet_fits(dk):
        raise ValueError(f"{name}: dk={dk} outside the kernel's shapes (dk <= {QUARTET_MAX_DK})")
    dev = q.device
    mix = torch.stack(_fp32_weights(dev, *(_scalar_tensor(x, dev).reshape(())
                                           for x in (mixture, quartet_scale))))
    out = torch.empty(b, n, h, dk, dtype=q.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 18)(*(s for t in (*ins, out) for s in t.stride()[:3]))
    fn = _fn("quartet_fwd", "mop_quartet_fwd", [_I] + [_P] * 7 + [_I] * 4 + [_P, _F, _F, _I, _P])
    with torch.cuda.device(dev):
        rc = fn(_DTYPE_CODE[q.dtype], *(t.data_ptr() for t in ins), out.data_ptr(),
                mix.data_ptr(), b, h, n, dk, strides, float(eps), 1.0 / math.sqrt(dk),
                copy_width(ins, dk), _stream(dev))
    _raise_on(rc, name)
    fused_quartet_attention.launches += 1
    return out


def fused_quartet_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q2: torch.Tensor, k2: torch.Tensor,
    mixture: Union[torch.Tensor, float], quartet_scale: Union[torch.Tensor, float],
    eps: float = 1e-5,
) -> torch.Tensor:
    """Fused causal Quartet attention over (B, H, N, dk) inputs.

    ``mixture`` is the sigmoid'd scalar gate m and ``quartet_scale`` the
    learned scale, both read in fp32. On CUDA the forward is K5
    (``csrc/quartet_fwd.cu``) for any N and dk <= 128 (it raises above);
    the inputs may have any strides with a contiguous feature axis, and the
    output is a view of a (B, N, H, dk) buffer. Differentiable: the backward
    recomputes through the composed reference (``_quartet_reference``), as
    the JAX op's.
    """
    mixture, quartet_scale = (_scalar_tensor(x, q.device).reshape(())
                              for x in (mixture, quartet_scale))
    fwd = _quartet_fwd_cuda if q.is_cuda else fused_quartet_attention_plain
    ins = (q, k, v, q2, k2, mixture, quartet_scale)
    if _needs_grad(*ins):
        return _RecomputeFunction.apply(lambda *t: fwd(*t, eps),
                                        lambda *t: _quartet_reference(*t, eps), *ins)
    return fwd(*ins, eps)


fused_quartet_attention.launches = 0

KERNELS = (flash_attention, fused_edgewise_lowrank_attention,
           fused_edgewise_lowrank_attention_bwd, edgewise_lowrank_wide_fwd,
           edgewise_lowrank_wide_bwd, fused_edgewise_dense_attention,
           fused_edgewise_dense_attention_bwd, fused_multihop_attention,
           fused_quartet_attention)


def reset_launch_counts() -> None:
    for f in KERNELS:
        f.launches = 0
