"""The bf16 rounding points that the redesigned K1 and K2b keep, rehearsed on
the CPU.

- K1: ``flash_attention_plain`` in bf16 (what the kernel is held to on the
  card: fp32 scores and statistics, the unnormalised probabilities rounded to
  bf16 before P V) against the JAX kernel in TPU interpret mode, on strided
  q/k/v views of one fused qkv tensor at B's dk 54 and A's dk 56, causal and
  with ragged keys.
- K2b: ``lowrank_vjp_schedule`` below applies the hand-derived lowrank VJP of
  ``csrc/edgewise_bwd.cu`` with the bf16 kernel's rounding schedule: both
  operands of every product bf16 (fp32 accumulation), a cotangent rounded
  where it passes back through a cast of the forward (d att, dP_i, dF_j and
  dB_j below the chains' tops, the total dAc_i once), and the two cotangents
  that no cast rounds (the chains' tops and dS_i) entering their products as
  a two-term bf16 split. It is held against the plain backward (autograd
  through the casts) and against ``jax.grad`` of the JAX kernel in bf16
  interpret mode. The other ways to treat those two cotangents (round them
  to bf16, or keep the products in fp32 on CUDA cores) are checked too.
- K2: its plain version in bf16 (what the tensor-core K2 is held to on the
  card) against the JAX kernel in bf16 interpret mode.
- The Python counts the wrappers launch with: K1's copy width at the A, B
  and B_bench layouts, and the shared-memory and workspace bytes of K1, K2,
  K2b / K3b, K3 and K5 at the main shape and the envelope's edges (K5 on
  both sides of where it keeps its score rows), and the dense op's envelope.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mop_tpu.ops.fused as JF
import mop_tpu_torch.ops.fused as TF

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frac(got, want):
    """Max-abs error of got against want, as a fraction of want's largest magnitude."""
    got, want = (torch.from_numpy(np.array(x, np.float32)) for x in (got, want))
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# ------------------------------- K1 in bf16 -------------------------------


def _qkv_views(rng, b, n, h, dk):
    """q, k, v as (B, H, N, dk) strided views of one fused (B, N, 3, H, dk)
    projection, as ``MSA`` forms them."""
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, dk)).astype(np.float32)).to(BF16)
    return qkv.permute(2, 0, 3, 1, 4)


# bf16 against the JAX kernel: both round the unnormalised p to bf16 before
# P V and divide by the fp32 row sum, so they differ only in the fp32
# summation order, where a rounding of p or of the output may flip: an
# output's bf16 step is up to 2^-8 of its magnitude, so within 2^-7 of the
# output's largest magnitude.
K1_BF16_FRAC = 2 ** -7


@pytest.mark.parametrize("dk,causal", [(54, False), (56, False), (54, True), (56, True)])
def test_flash_bf16_strided_views_match_jax_kernel(dk, causal):
    rng = np.random.default_rng(dk + 10 * causal)
    q, k, v = _qkv_views(rng, 2, 24, 3, dk)
    assert q.stride(-1) == 1 and not q.is_contiguous()
    got = TF.flash_attention(q, k, v, causal=causal)
    assert got.dtype == BF16
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                    for t in (q, k, v)), causal=causal, force=True)
    assert _frac(got.float().numpy(), np.asarray(want, np.float32)) <= K1_BF16_FRAC


@pytest.mark.parametrize("dk", [54, 56])
def test_flash_bf16_ragged_kv_matches_jax_kernel(dk):
    rng = np.random.default_rng(dk)
    q = torch.from_numpy(rng.standard_normal((1, 2, 24, dk)).astype(np.float32)).to(BF16)
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, dk)).astype(np.float32)).to(BF16)
            for _ in range(2))
    got = TF.flash_attention(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                    for t in (q, k, v)), force=True)
    assert _frac(got.float().numpy(), np.asarray(want, np.float32)) <= K1_BF16_FRAC


def test_flash_bf16_rounds_the_unnormalised_probabilities():
    """Where p is rounded shows: rounding the normalised softmax instead
    moves the output by more than the fp32 reordering between the two
    implementations does."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv_views(rng, 1, 32, 2, 56)
    got = TF.flash_attention_plain(q, k, v).float()
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(56)
    normalised_first = (torch.softmax(s, -1).to(BF16).float() @ v.float()).to(BF16).float()
    assert (got - normalised_first).abs().max().item() > 0


@pytest.mark.parametrize("layout,dtype,width", [
    ("A", torch.float32, 16), ("A", BF16, 16),            # 224 / 4 heads: dk 56
    ("B_bench", torch.float32, 16), ("B_bench", BF16, 16),
    ("B", torch.float32, 8), ("B", BF16, 4),             # 216 / 4 heads: dk 54
])
def test_flash_copy_width_from_alignment(layout, dtype, width):
    """The K1 wrapper picks the asynchronous copy width from the q/k/v views'
    addresses and strides: B's dk-54 heads start every 216 (fp32) or 108
    (bf16) bytes, so 16-byte copies would be misaligned there."""
    dim = {"A": 224, "B_bench": 224, "B": 216}[layout]
    dk = dim // 4
    qkv = torch.zeros(2, 64, 3, 4, dk, dtype=dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert TF.copy_width((q, k, v), dk) == width


def test_copy_width_falls_to_the_element_size():
    x = torch.zeros(3, 7, dtype=BF16)
    assert TF.copy_width((x[:, 1:],), 6) == 2    # a 2-byte offset
    assert TF.copy_width((x,), 7) == 2           # 14-byte rows
    y = torch.zeros(4, 6)
    assert TF.copy_width((y,), 6) == 8 and TF.copy_width((y[:, 1:],), 5) == 4


@pytest.mark.parametrize("dtype,dk,want", [
    (torch.float32, 54, 6 * 64 * 60 * 4 + 4 * 64 * 65),
    (torch.float32, 56, 108800),     # two blocks an SM
    (torch.float32, 128, 219392),
    (BF16, 56, 55296),               # four blocks an SM
    (BF16, 54, 55296),
    (BF16, 128, 104448),
])
def test_flash_smem_bytes(dtype, dk, want):
    assert TF.flash_smem_bytes(dtype, dk) == want
    assert want <= TF.MAX_SMEM_BYTES


# ------------------------- K2b: the bf16 schedule -------------------------


def _r(x):
    """The cast to bf16 and back."""
    return x.to(BF16).float()


def _product(x, y, how):
    """x y for an fp32 cotangent x that no cast rounds: as a two-term bf16
    split ("split", the kernel's choice), rounded to bf16 ("round", what the
    TPU's DEFAULT precision does to a mixed product) or in fp32 ("fp32", a
    CUDA-core product)."""
    if how == "split":
        hi = _r(x)
        return hi @ y + _r(x - hi) @ y
    if how == "round":
        return _r(x) @ y
    return x @ y


def _gate_mix(s_list, log_cf, log_cb, wrow, brow, wcol, bcol, beta_not):
    """The fp32 part of the forward between the score maps and the final
    softmax: pooled features, the lowrank gates and the gated logit mix."""
    nv = len(s_list)
    r = wrow.shape[-1] // 4
    rows = [s.mean(-1) for s in s_list]
    cols = [s.mean(-2) for s in s_list]
    row_feat = torch.stack(rows + cols + [log_cf.mean(-1), log_cb.mean(-1)], -1)
    col_feat = torch.stack(cols + rows + [log_cf.mean(-2), log_cb.mean(-2)], -1)
    a_fac = row_feat @ wrow + brow
    b_fac = col_feat @ wcol + bcol
    g = [torch.sigmoid(a_fac[..., j * r:(j + 1) * r] @ b_fac[..., j * r:(j + 1) * r]
                       .transpose(-1, -2)) for j in range(4)]
    s1 = s_list[0]
    s_sum = sum(s_list[1:], s1)
    m = s_list[0]
    for s in s_list[1:]:
        m = torch.maximum(m, s)
    lse = m + torch.log(sum(torch.exp(s - m) for s in s_list))
    mean_others = (s_sum - s1) / max(1, nv - 1)
    smix = s1 + g[0] * (s_sum - s1)
    smix = smix + g[1] * (lse - s1)
    smix = smix - g[2] * (beta_not * mean_others)
    return smix + g[3] * log_cf


def lowrank_vjp_schedule(qs, ks, vs, wrow, brow, wcol, bcol, beta_not, chain_w, dy,
                         top="split"):
    """K2b's bf16 backward as the kernel runs it, in plain torch.

    Takes bf16 (B, H, V, N, dk) inputs and dy (B, H, N, dk); returns dq, dk,
    dv in bf16 and the fp32 per-program weight grads in the plain backward's
    layout. Every product takes bf16-valued operands (fp32 accumulation),
    except those with the fp32 cotangents d c_fwd, d c_bwd and dS_i, which
    go through ``_product(..., top)``. The mix, gates and softmax VJPs are
    fp32, as in the kernel; their VJP here is autograd's."""
    b, h, nv, n, dk = qs.shape
    f32 = torch.float32
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    sc = _r(torch.tensor(1.0 / math.sqrt(dk)))
    q = _r(qs.float() * sc)
    k, v = ks.float(), vs.float()
    s_list = [q[:, :, i] @ tr(k[:, :, i]) for i in range(nv)]
    a_list = [torch.softmax(s, -1) for s in s_list]
    ac = [_r(a) for a in a_list]
    fch, bch = [None, ac[0] @ ac[1]], [None, ac[-1] @ ac[-2]]
    for j in range(2, nv):
        fch.append(_r(fch[-1]) @ ac[j])
        bch.append(_r(bch[-1]) @ ac[nv - 1 - j])
    # The fp32 middle of the forward, differentiated by autograd.
    leaves = [t.detach().requires_grad_() for t in (*s_list, fch[-1], bch[-1])]
    ws = [w.detach().float().reshape(1, 1, *w.shape).expand(b, h, *w.shape).clone()
          .requires_grad_() for w in (wrow, brow, wcol, bcol)]
    with torch.enable_grad():
        smix = _gate_mix(leaves[:nv], torch.log(leaves[nv] + 1e-6),
                         torch.log(leaves[nv + 1] + 1e-6), ws[0], ws[1].unsqueeze(-2), ws[2],
                         ws[3].unsqueeze(-2), beta_not)
    att = torch.softmax(smix.detach(), -1)
    pt = {nv: v[:, :, nv - 1]}
    for i in range(nv - 1, 0, -1):
        pt[i] = _r(ac[i] @ pt[i + 1])
    w = torch.as_tensor(chain_w, dtype=f32)

    dyf = dy.float()
    dchain = (dyf * (ac[0] @ pt[1])).sum((-1, -2)).reshape(b * h)
    dv = torch.zeros(b, h, nv, n, dk)
    dv[:, :, 0] = tr(_r(att)) @ dyf
    datt = _r(dyf @ tr(v[:, :, 0]))
    da = [None] * nv
    da[0] = w * (dyf @ tr(pt[1]))
    dp = _r(w * (tr(ac[0]) @ dyf))
    for i in range(1, nv):
        da[i] = dp @ tr(pt[i + 1])
        nxt = tr(ac[i]) @ dp
        if i + 1 == nv:
            dv[:, :, nv - 1] = nxt
        else:
            dp = _r(nxt)
    dsmix = att * (datt - (datt * att).sum(-1, keepdim=True))
    grads = torch.autograd.grad(smix, leaves + ws, dsmix)
    ds = list(grads[:nv])
    dtop = [grads[nv], grads[nv + 1]]
    # Both chains: view(j) and the left factor of step j.
    for chain in (0, 1):
        view = (lambda j: j) if chain == 0 else (lambda j: nv - 1 - j)
        left = fch if chain == 0 else bch
        d = dtop[chain]
        split = True
        for j in range(nv - 1, 1, -1):
            how = top if split else "fp32"
            da[view(j)] = da[view(j)] + tr(_product(tr(d), _r(left[j - 1]), how))
            d = _r(_product(d, tr(ac[view(j)]), how))
            split = False
        how = top if split else "fp32"
        da[view(0)] = da[view(0)] + _product(d, tr(ac[view(1)]), how)
        da[view(1)] = da[view(1)] + tr(_product(tr(d), ac[view(0)], how))
    dq, dkey = torch.empty(b, h, nv, n, dk), torch.empty(b, h, nv, n, dk)
    for i in range(nv):
        dai = _r(da[i])
        dsi = ds[i] + a_list[i] * (dai - (dai * a_list[i]).sum(-1, keepdim=True))
        dq[:, :, i] = _r(_r(_product(dsi, k[:, :, i], top)) * sc)
        dkey[:, :, i] = _product(tr(dsi), q[:, :, i], top)
    dws = [g.reshape(b * h, *(w_.shape if w_.dim() == 2 else (1, w_.shape[0])))
           for g, w_ in zip(grads[nv + 2:], (wrow, brow, wcol, bcol))]
    return (dq.to(BF16), dkey.to(BF16), dv.to(BF16), *dws, dchain)


K2B_NAMES = ("dq", "dk", "dv", "dwrow", "dbrow", "dwcol", "dbcol", "dchain")


def _k2b_inputs(v_, n, dk, r, seed):
    rng = np.random.default_rng(seed)
    qs, ks, vs = (torch.from_numpy(rng.standard_normal((2, 2, v_, n, dk)).astype(np.float32))
                  .to(BF16) for _ in range(3))
    c = 2 * v_ + 2
    wrow = torch.from_numpy((rng.standard_normal((c, 4 * r)) * 0.3).astype(np.float32))
    wcol = torch.from_numpy((rng.standard_normal((c, 4 * r)) * 0.3).astype(np.float32))
    brow = torch.linspace(-0.5, 0.5, 4 * r)
    bcol = torch.linspace(0.5, -0.5, 4 * r)
    dy = torch.from_numpy(rng.standard_normal((2, 2, n, dk)).astype(np.float32)).to(BF16)
    return (qs, ks, vs, wrow, brow, wcol, bcol, 0.7, torch.tensor(0.4)), dy


# Against the plain backward, per choice for the unrounded cotangents, each
# grad within this fraction of its largest magnitude. The schedule rounds
# where the plain backward's casts do, so the two differ by fp32 summation
# order and by the choice: the split and fp32 products agree with fp32
# matmuls to about 2^-17, which can flip a bf16 rounding of an output (one
# step is up to 2^-8 of it), so 2^-7; rounding d c_fwd, d c_bwd and dS_i to
# bf16 moves dq and dk by a few bf16 steps (about 5e-3 here), so 2e-2.
K2B_PLAIN_FRAC = {"split": 2 ** -7, "fp32": 2 ** -7, "round": 2e-2}


@pytest.mark.parametrize("top", ["split", "round", "fp32"])
@pytest.mark.parametrize("v_,n,dk,r", [(3, 16, 8, 2), (5, 16, 8, 4), (2, 16, 8, 1)])
def test_k2b_bf16_schedule_matches_plain_backward(top, v_, n, dk, r):
    args, dy = _k2b_inputs(v_, n, dk, r, seed=v_ + n + dk + r)
    got = lowrank_vjp_schedule(*args, dy, top=top)
    want = TF.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    for name, g, w in zip(K2B_NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _frac(g.float(), w.float()) <= K2B_PLAIN_FRAC[top], (name, _frac(g.float(),
                                                                              w.float()))


def test_k2b_split_is_closer_to_the_plain_backward_than_rounding():
    """The split keeps the unrounded cotangents' products at fp32 accuracy:
    summed over the grads, its error against the plain backward is below
    rounding's."""
    args, dy = _k2b_inputs(5, 16, 8, 4, seed=3)
    want = TF.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    err = {top: sum(_frac(g.float(), w.float()) for g, w in
                    zip(lowrank_vjp_schedule(*args, dy, top=top), want))
           for top in ("split", "round")}
    assert err["split"] < err["round"]


# Against jax.grad of the JAX kernel in bf16 interpret mode: JAX rounds each
# cast's cotangent too, but rounds the transport's and the chains' dAc_i
# apart (two casts of A_i in its math) and forms its mixed fp32 x bf16
# products in fp32; each grad within 2e-2 of its largest magnitude, the
# limit chip_smoke.py holds the kernel to against the plain backward.
K2B_JAX_FRAC = 2e-2


@pytest.mark.parametrize("v_,n,dk,r", [(3, 16, 8, 2), (5, 16, 8, 4)])
def test_k2b_bf16_schedule_matches_jax_kernel(v_, n, dk, r):
    args, dy = _k2b_inputs(v_, n, dk, r, seed=40 + v_)
    got = lowrank_vjp_schedule(*args, dy)
    b, h = 2, 2
    sums = (got[0], got[1], got[2], got[3].sum(0), got[4].sum((0, 1)), got[5].sum(0),
            got[6].sum((0, 1)), got[7].sum())

    def loss(q, k, v, wr, br, wc, bc, cw):
        with pltpu.force_tpu_interpret_mode():
            y = JF.fused_edgewise_lowrank_attention(q, k, v, wr, br, wc, bc, beta_not=args[7],
                                                    chain_w=cw, force=True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy.float().numpy()))

    ins = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in args[:3]]
    ins += [jnp.asarray(t.numpy()) for t in args[3:7]] + [jnp.float32(0.4)]
    want = jax.grad(loss, argnums=tuple(range(8)))(*ins)
    assert got[0].shape == (b, h, v_, n, dk)
    for name, g, w in zip(K2B_NAMES, sums, want):
        assert _frac(g.float(), np.asarray(w, np.float32)) <= K2B_JAX_FRAC, name


# ------------------------------- K2 in bf16 -------------------------------

# The port's bf16 K2 plain version (what the tensor-core K2 is held to on
# the card) against the JAX kernel in bf16 interpret mode. Both round at the
# same points (q * scale, each A_i, each partial chain product, the
# transports and att before their products) and keep the statistics, the
# gate head and the mix in fp32, so they differ only where an fp32 sum in
# another order flips a bf16 rounding of an intermediate or of the output:
# each output is held to one bf16 step (2^-8) of the largest, and at most 1%
# of them may differ at all (at these shapes none does).
K2_JAX_FRAC = 2 ** -8


@pytest.mark.parametrize("v_,n,dk,r", [(3, 16, 8, 2), (5, 16, 8, 4), (2, 12, 24, 1)])
def test_k2_bf16_plain_matches_jax_kernel(v_, n, dk, r):
    args, _ = _k2b_inputs(v_, n, dk, r, seed=70 + v_)
    got = TF.fused_edgewise_lowrank_attention_plain(*args)
    assert got.dtype == BF16
    with pltpu.force_tpu_interpret_mode():
        want = JF.fused_edgewise_lowrank_attention(
            *[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in args[:3]],
            *[jnp.asarray(t.numpy()) for t in args[3:7]], beta_not=args[7],
            chain_w=jnp.float32(0.4), force=True)
    want = np.asarray(want, np.float32)
    assert _frac(got.float(), want) <= K2_JAX_FRAC
    assert (got.float().numpy() != want).mean() <= 0.01


# ------------------------- K2b / K3b byte counts -------------------------


@pytest.mark.parametrize("dtype,shape,dense,smem,ws", [
    # The main shape (V, N, dk, r) = (5, 64, 56, 4): bf16 fits two programs an SM.
    (BF16, (5, 64, 56, 4), False, 111904, 413696),
    (torch.float32, (5, 64, 56, 4), False, 161824, 450560),
    (BF16, (5, 64, 56), True, 100208, 413696),
    (torch.float32, (5, 64, 56), True, 150128, 450560),
    # The envelope's edges: eight views, N 64, dk 128; two views at N 1, dk 1.
    (BF16, (8, 64, 128, 4), False, 173344, 720896),
    (torch.float32, (8, 64, 128, 4), False, 217888, 868352),
    (BF16, (2, 1, 1, 1), False, 21700, 96),
    (torch.float32, (2, 1, 1, 1), False, 224, 40),
])
def test_edgewise_bwd_byte_counts(dtype, shape, dense, smem, ws):
    assert TF.edgewise_bwd_smem_bytes(dtype, *shape, dense=dense) == smem
    assert TF.edgewise_bwd_ws_bytes(dtype, *shape[:3]) == ws
    # The bf16 kernel's copies need each program's workspace 16-byte aligned.
    assert smem <= TF.MAX_SMEM_BYTES and ws % (16 if dtype == BF16 else 4) == 0
    if dtype == BF16 and shape[1:3] == (64, 56) and not dense:
        assert 2 * (smem + 1024) <= 233472  # two programs in an SM's 228 KB


@pytest.mark.parametrize("dtype,shape,smem,fits", [
    # The main shape: bf16 (the V maps Ac_i in bf16, four operand buffers)
    # fits two programs an SM; fp32 (the V fp32 maps, two groups' staging)
    # one.
    (BF16, (5, 64, 56, 4), 99840, True),
    (torch.float32, (5, 64, 56, 4), 171008, True),
    # Eight views at N 64: bf16 fits at dk 128, fp32 only up to dk 64.
    (BF16, (8, 64, 128, 4), 163328, True),
    (torch.float32, (8, 64, 64, 4), 230400, True),
    (torch.float32, (8, 64, 128, 4), 297984, False),
    (BF16, (2, 1, 1, 1), 21072, True),
    (torch.float32, (2, 1, 1, 1), 432, True),
])
def test_k2_byte_counts(dtype, shape, smem, fits):
    """K2's shared memory per dtype (``edgewise_lowrank_smem_bytes``, which
    chip_smoke.py phase 2 holds to the kernel's own count), and the shape
    predicate the modules route by."""
    assert TF.edgewise_lowrank_smem_bytes(dtype, *shape) == smem
    assert TF.edgewise_lowrank_fits(dtype, *shape) == fits
    if dtype == BF16 and shape[1:3] == (64, 56):
        assert 2 * (smem + 1024) <= 233472  # two programs in an SM's 228 KB


def test_k2b_wrapper_checks_shared_memory_per_dtype():
    """The K2b wrapper sizes its shape check by the input dtype: the bf16
    kernel's count, not the fp32 one's."""
    many = torch.zeros(1, 1, 8, 64, 128, dtype=BF16)
    w = torch.zeros(18, 16)
    counted = []
    TF._edgewise_shapes("k", many, many, many, w, w[0], w, w[0], 8,
                        lambda *s: counted.append(TF.edgewise_bwd_smem_bytes(BF16, *s)) or 0)
    assert counted == [173344]


# -------------------------- K3 and K5 byte counts --------------------------


@pytest.mark.parametrize("dtype,shape,smem,ws", [
    # The main shape (V, N, dk) = (5, 64, 56): bf16 fits two programs an SM;
    # the workspace holds the V fp32 score maps (80 KB) in both dtypes.
    (BF16, (5, 64, 56), 86608, 81920),
    (torch.float32, (5, 64, 56), 171088, 81920),
    # Off shapes: two and eight views, N 33, N 1.
    (BF16, (2, 16, 8), 21712, 2048),
    (torch.float32, (2, 16, 8), 8656, 2048),
    (BF16, (8, 33, 54), 98256, 38016),
    (torch.float32, (8, 33, 54), 88608, 38016),
    (BF16, (2, 1, 1), 21712, 32),
    (torch.float32, (2, 1, 1), 1056, 32),
    # Wide heads: the fp32 maps A_i move to the workspace where they would
    # not fit on chip.
    (BF16, (8, 64, 128), 147408, 131072),
    (torch.float32, (8, 64, 128), 156112, 270336),
    (torch.float32, (5, 64, 128), 155728, 168960),
    (torch.float32, (8, 64, 80), 105424, 270336),
])
def test_k3_byte_counts(dtype, shape, smem, ws):
    """K3 runs K2's kernels with the dense head: its shared memory per dtype
    (``edgewise_dense_smem_bytes``) and its workspace
    (``edgewise_dense_ws_bytes``), which chip_smoke.py phase 2 holds to the
    kernel's own counts, and the shape predicate the modules route by."""
    assert TF.edgewise_dense_smem_bytes(dtype, *shape) == smem
    assert TF.edgewise_dense_ws_bytes(dtype, *shape) == ws
    assert TF.edgewise_dense_fits(dtype, *shape)
    assert smem <= TF.MAX_SMEM_BYTES and ws % 16 == 0
    if dtype == BF16 and shape == (5, 64, 56):
        assert 2 * (smem + 1024) <= 233472  # two programs in an SM's 228 KB


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k3_envelope_is_kept(dtype):
    """The dense op's kernels take every V in [2, 8], N <= 64, dk <= 128 in
    both dtypes, as before K3 kept its maps on chip."""
    for v_ in range(2, 9):
        for n in (1, 16, 33, 40, 63, 64):
            for dk in (1, 8, 54, 56, 80, 100, 127, 128):
                assert TF.edgewise_dense_fits(dtype, v_, n, dk), (v_, n, dk)
    assert not TF.edgewise_dense_fits(dtype, 9, 64, 56)
    assert not TF.edgewise_dense_fits(dtype, 5, 65, 56)
    assert not TF.edgewise_dense_fits(dtype, 5, 64, 129)


@pytest.mark.parametrize("dtype,n,dk,smem,keeps", [
    # The LM's shape (N, dk) = (256, 80): both dtypes keep the raw rows; bf16
    # fits two CTAs an SM.
    (BF16, 256, 80, 101376, True),
    (torch.float32, 256, 80, 221184, True),
    (BF16, 1, 80, 52224, True),
    (torch.float32, 1, 80, 122880, True),
    (BF16, 100, 80, 68608, True),
    (torch.float32, 100, 80, 155648, True),
    # The thresholds: fp32 keeps rows up to N 256 at dk 80 and 128 at dk 128,
    # bf16 up to 768 at dk 80; above, the streaming kernel's bytes.
    (torch.float32, 257, 80, 99584, False),
    (torch.float32, 128, 128, 204800, True),
    (torch.float32, 129, 128, 148736, False),
    (BF16, 512, 80, 166912, True),
    (BF16, 768, 80, 232448, True),
    (BF16, 769, 80, 99584, False),
    (BF16, 2048, 80, 99584, False),
    (torch.float32, 2048, 80, 99584, False),
])
def test_k5_byte_counts(dtype, n, dk, smem, keeps):
    """K5's shared memory per dtype (``quartet_smem_bytes``) and where it
    keeps the raw score rows (``quartet_keeps_rows``), which chip_smoke.py
    phase 2 holds to the kernel's own counts."""
    assert TF.quartet_smem_bytes(dtype, n, dk) == smem
    assert TF.quartet_keeps_rows(dtype, n, dk) == keeps
    assert smem <= TF.MAX_SMEM_BYTES and TF.quartet_fits(dk)
    if dtype == BF16 and (n, dk) == (256, 80):
        assert 2 * (smem + 1024) <= 233472  # two CTAs in an SM's 228 KB
