"""K2w and K2bw, the staged lowrank E kernels for 64 < N <= 256
(``csrc/edgewise_wide.cu``), on the CPU.

- ``wide_stages`` below runs the kernels' stages in plain torch, in their
  order and with their rounding points: the forward's stages, then the
  hand-derived VJP (the transport's, the logit mix's with its softmax, the
  rank-r factors' and the head's, the channel means', both chains' and the
  score softmaxes'). It equals the plain forward and its autograd backward
  in fp32 and in bf16.
- Above N = 64 the port's op (its plain version on the CPU) and its grads
  equal the JAX kernel's forward and in-kernel VJP in TPU interpret mode,
  which the JAX package runs up to N = 256.
- ``EdgewiseMSA`` with VOC E's lowrank head calls the op at N = 196 (224 /
  16 images), in eval and in training, and matches the JAX module; the wrappers on CPU tensors are the plain versions and count no
  launch; the workspace count."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mop_tpu.ops.fused as JF
import mop_tpu_torch.ops.fused as TF
from mop_tpu.models import EdgewiseMSA as JEdgewiseMSA
from mop_tpu_torch.models import EdgewiseMSA
from mop_tpu_torch.utils.jax_weights import load_jax_params

BF16 = torch.bfloat16
NAMES = ("dq", "dk", "dv", "dwrow", "dbrow", "dwcol", "dbcol", "dchain")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, dk, v_, r, seed, dtype=torch.float32, bh=(2, 2)):
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    qs, ks, vs = (rn(*bh, v_, n, dk).to(dtype) for _ in range(3))
    c = 2 * v_ + 2
    wrow, wcol = rn(c, 4 * r, scale=0.3), rn(c, 4 * r, scale=0.3)
    brow, bcol = torch.linspace(-0.5, 0.5, 4 * r), torch.linspace(0.5, -0.5, 4 * r)
    dy = rn(*bh, n, dk).to(dtype)
    return (qs, ks, vs, wrow, brow, wcol, bcol, 0.7, torch.tensor(0.4)), dy


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, on the int32 view (the low 13 mantissa bits dropped)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernels' tensor cores take it in fp32: each operand split
    into a TF32 high part and a TF32 residual, hi hi + hi lo + lo hi with
    fp32 sums (the lo lo term dropped)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def wide_stages(qs, ks, vs, wrow, brow, wcol, bcol, beta, chain_w, dy, mm=torch.matmul):
    """K2w's output and K2bw's grads as the kernels compute them, stage by
    stage and in their order: fp32 maps, operands rounded to bf16 where the
    kernels round them on load (in bf16), the VJP written out by hand, and
    every product the kernels run on the tensor cores through ``mm``. The
    scores come with their softmaxes and means; both chains advance a step
    at a time, the last step with the log maps' means; the chains' backward
    runs both chains a step at a time; the means' share of the score
    cotangents joins the score softmaxes' VJP."""
    bf = qs.dtype == BF16
    rd = (lambda x: x.to(BF16).float()) if bf else (lambda x: x)  # noqa: E731
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    b, h, nv, n, dk = qs.shape
    r = wrow.shape[1] // 4
    sc = rd(torch.tensor(1.0 / math.sqrt(dk))).item()
    qsc = rd(qs.float() * sc)
    k, v = ks.float(), vs.float()
    s = [mm(qsc[:, :, i], tr(k[:, :, i])) for i in range(nv)]
    a = [torch.softmax(x, -1) for x in s]
    rm, cm = [x.mean(-1) for x in s], [x.mean(-2) for x in s]
    ac = [rd(x) for x in a]
    view = (lambda c, j: j if c == 0 else nv - 1 - j)  # noqa: E731
    ch = [[None, mm(ac[0], ac[1])], [None, mm(ac[-1], ac[-2])]]
    for j in range(2, nv):
        for c in (0, 1):
            ch[c].append(mm(rd(ch[c][j - 1]), ac[view(c, j)]))
    fch, bch = ch
    fl, bl = fch[-1], bch[-1]
    for x in (torch.log(fl + 1e-6), torch.log(bl + 1e-6)):
        rm.append(x.mean(-1))
        cm.append(x.mean(-2))
    rf = torch.stack(rm[:nv] + cm[:nv] + rm[nv:], -1)
    cf = torch.stack(cm[:nv] + rm[:nv] + cm[nv:], -1)
    af, bfac = rf @ wrow + brow, cf @ wcol + bcol
    g = [torch.sigmoid(af[..., q * r:(q + 1) * r] @ tr(bfac[..., q * r:(q + 1) * r]))
         for q in range(4)]
    s_sum = sum(s[1:], s[0])
    mx = torch.stack(s).amax(0)
    sumexp = sum(torch.exp(x - mx) for x in s)
    lse = mx + torch.log(sumexp)
    others = s_sum - s[0]
    lcf = torch.log(fl + 1e-6)
    smix = s[0] + g[0] * others + g[1] * (lse - s[0]) - g[2] * (beta * (others / (nv - 1)))
    att = torch.softmax(smix + g[3] * lcf, -1)
    pt = {nv - 1: mm(ac[nv - 1], v[:, :, nv - 1])}
    for i in range(nv - 2, 0, -1):
        pt[i] = mm(ac[i], rd(pt[i + 1]))
    w = chain_w.float()
    y = (w * mm(ac[0], rd(pt[1])) + mm(rd(att), v[:, :, 0])).to(qs.dtype)

    dyf = dy.float()
    dchain = (dyf * mm(ac[0], rd(pt[1]))).sum((-1, -2)).reshape(b * h)
    dv = torch.zeros(b, h, nv, n, dk)
    dv[:, :, 0] = mm(tr(rd(att)), dyf)
    datt = mm(dyf, tr(v[:, :, 0]))
    dac = [None] * nv
    dac[0] = w * mm(dyf, tr(rd(pt[1])))
    dp = w * mm(tr(ac[0]), dyf)
    for i in range(1, nv):
        nxt_pt = v[:, :, nv - 1] if i + 1 == nv else rd(pt[i + 1])
        dac[i] = mm(rd(dp), tr(nxt_pt))
        dp = mm(tr(ac[i]), rd(dp))
    dv[:, :, nv - 1] = dp
    # The mix and its softmax.
    da = rd(datt)
    dsmix = att * (da - (da * att).sum(-1, keepdim=True))
    dg = [dsmix * others, dsmix * (lse - s[0]), -dsmix * (beta * (others / (nv - 1))),
          dsmix * lcf]
    dz = [dg[q] * g[q] * (1 - g[q]) for q in range(4)]
    dlse = dsmix * g[1]
    d_others = dsmix * (g[0] - g[2] * (beta / (nv - 1)))
    p = [torch.exp(x - mx) / sumexp for x in s]
    ds = [dsmix * (1 - g[1]) + dlse * p[0]] + [d_others + dlse * p[i] for i in range(1, nv)]
    dl = dsmix * g[3]
    # The factors and the head.
    daf = torch.cat([mm(dz[q], bfac[..., q * r:(q + 1) * r]) for q in range(4)], -1)
    dbf = torch.cat([mm(tr(dz[q]), af[..., q * r:(q + 1) * r]) for q in range(4)], -1)
    drf, dcf = mm(daf, tr(wrow)), mm(dbf, tr(wcol))
    dwrow, dwcol = mm(tr(rf), daf), mm(tr(cf), dbf)
    dbrow, dbcol = daf.sum(-2, keepdim=True), dbf.sum(-2, keepdim=True)
    # The log maps' means.
    col = lambda x: x.unsqueeze(-1)  # noqa: E731
    row = lambda x: x.unsqueeze(-2)  # noqa: E731
    dl = (dl + col(drf[..., 2 * nv]) / n + row(dcf[..., 2 * nv]) / n) / (fl + 1e-6)
    dlb = (col(drf[..., 2 * nv + 1]) / n + row(dcf[..., 2 * nv + 1]) / n) / (bl + 1e-6)
    # Both chains a step at a time, each from its own cotangent.
    d = [dl, dlb]
    for j in range(nv - 1, 1, -1):
        for c in (0, 1):
            dac[view(c, j)] = dac[view(c, j)] + mm(tr(rd(ch[c][j - 1])), d[c])
        d = [rd(mm(d[c], tr(ac[view(c, j)]))) for c in (0, 1)]
    for c in (0, 1):
        dac[view(c, 0)] = dac[view(c, 0)] + mm(d[c], tr(ac[view(c, 1)]))
    for c in (0, 1):
        dac[view(c, 1)] = dac[view(c, 1)] + mm(tr(ac[view(c, 0)]), d[c])
    # The score softmaxes with the means' share, then dq and dk.
    dq, dkey = torch.empty(b, h, nv, n, dk), torch.empty(b, h, nv, n, dk)
    for i in range(nv):
        dai = rd(dac[i])
        means = col(drf[..., i] + dcf[..., nv + i]) / n + row(drf[..., nv + i] + dcf[..., i]) / n
        dsi = (ds[i] + means) + a[i] * (dai - (dai * a[i]).sum(-1, keepdim=True))
        dq[:, :, i] = rd(rd(mm(dsi, k[:, :, i])) * sc)
        dkey[:, :, i] = mm(tr(dsi), qsc[:, :, i])
    per = lambda x: x.reshape(b * h, *x.shape[2:])  # noqa: E731
    grads = (dq.to(qs.dtype), dkey.to(qs.dtype), dv.to(qs.dtype), per(dwrow), per(dbrow),
             per(dwcol), per(dbcol), dchain)
    return y, grads


def _frac(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# The stages against the plain version, each output and grad within this
# fraction of its largest magnitude: in fp32 they differ by summation order
# alone; in bf16 the stages round where the plain backward's casts do, and
# fp32 order can flip a bf16 rounding of an output (one step is 2^-8 of it).
STAGE_FRAC = {torch.float32: 2e-5, BF16: 2 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("v_,n,dk,r", [(4, 80, 16, 4), (2, 72, 8, 1), (5, 66, 8, 2)])
def test_stages_match_the_plain_forward_and_backward(dtype, v_, n, dk, r):
    args, dy = _inputs(n, dk, v_, r, seed=v_ + n + dk + r, dtype=dtype)
    y, got = wide_stages(*args, dy)
    want_y = TF.fused_edgewise_lowrank_attention_plain(*args)
    assert y.dtype == want_y.dtype
    assert _frac(y.float(), want_y.float()) <= STAGE_FRAC[dtype]
    want = TF.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _frac(g.float(), w.float()) <= STAGE_FRAC[dtype], (name, _frac(g.float(),
                                                                              w.float()))


def test_tf32_split_rounds_to_nearest_away():
    """``tf32`` keeps 10 mantissa bits, rounding half away from zero as
    cvt.rna does, and the split's two parts sum back to x within 2^-22 of
    it."""
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0])
    assert tf32(x).tolist() == [1 + 2 ** -10, 1 + 4 * 2 ** -11, -(1 + 2 ** -10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    hi = tf32(y)
    assert ((hi + tf32(y - hi) - y).abs() <= y.abs() * 2 ** -22).all()


# VOC E's lowrank head (V, N, dk, r) at two programs.
VOC_E = (4, 196, 64, 4)


def test_tf32x3_stages_at_voc_e_shape():
    """Every product as the 3xTF32 tensor-core product: at VOC E's shape the
    stages hold the plain fp32 forward within chip_smoke's phase-12 fp32
    tolerances (atol 2e-5, rtol 2e-4) and its grads within 2e-4 / 2e-3."""
    nv, n, dk, r = VOC_E
    args, dy = _inputs(n, dk, nv, r, seed=14, bh=(1, 2))
    y, got = wide_stages(*args, dy, mm=mm_3xtf32)
    torch.testing.assert_close(y, TF.fused_edgewise_lowrank_attention_plain(*args), atol=2e-5,
                               rtol=2e-4)
    want = TF.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-3, msg=name)


def _mm_tf32(a, b):
    """Single-pass TF32: both operands rounded to TF32, fp32 sums."""
    return tf32(a) @ tf32(b)


def _mm_no_a_lo(a, b):
    """3xTF32 with A's low term dropped (as if A's values were TF32)."""
    a_hi, b_hi = tf32(a), tf32(b)
    return a_hi @ tf32(b - b_hi) + a_hi @ b_hi


def _mm_no_b_lo(a, b):
    """3xTF32 with B's low term dropped."""
    a_hi, b_hi = tf32(a), tf32(b)
    return tf32(a - a_hi) @ b_hi + a_hi @ b_hi


def _worst(got, want, atol, rtol):
    """The largest |got - want| / (atol + rtol |want|): above 1, the
    tolerance rejects."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("mm", [_mm_tf32, _mm_no_a_lo, _mm_no_b_lo],
                         ids=["tf32", "no_a_lo", "no_b_lo"])
def test_phase12_tolerances_reject_tf32_and_a_dropped_low_term(mm):
    """The controls for the tolerances the 3xTF32 products pass: at VOC E's
    shape, single-pass TF32 or a product with one operand's low term dropped
    falls outside chip_smoke's phase-12 fp32 tolerances, in the forward
    (atol 2e-5, rtol 2e-4) and in the grads (2e-4, 2e-3; the phase fails
    on any one grad)."""
    nv, n, dk, r = VOC_E
    args, dy = _inputs(n, dk, nv, r, seed=14, bh=(1, 2))
    y, got = wide_stages(*args, dy, mm=mm)
    assert _worst(y, TF.fused_edgewise_lowrank_attention_plain(*args), 2e-5, 2e-4) > 2
    want = TF.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    worst = {name: _worst(g, w, 2e-4, 2e-3) for name, g, w in zip(NAMES, got, want)}
    assert max(worst.values()) > 2, worst


def _jax_fwd_and_grads(args, dy):
    key = (tuple(args[0].shape), args[0].sum().item(), dy.sum().item())
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run_jax(args, dy)
    return _JAX_RUNS[key]


_JAX_RUNS = {}


def _run_jax(args, dy):
    arrays = [jnp.asarray(t.numpy()) for t in args[:7]] + [jnp.float32(args[8].item())]
    dyj = jnp.asarray(dy.numpy())

    def fwd(*a):
        with pltpu.force_tpu_interpret_mode():
            return JF.fused_edgewise_lowrank_attention(*a[:7], beta_not=args[7], chain_w=a[7],
                                                       force=True)

    y = fwd(*arrays)
    grads = jax.grad(lambda *a: jnp.sum(fwd(*a) * dyj), argnums=tuple(range(8)))(*arrays)
    return np.asarray(y), grads


def test_op_above_n64_matches_the_jax_kernel():
    """N = 80 (above K2's 64, in the JAX kernel's 256): the port's op and
    its grads against the JAX kernel's forward and in-kernel VJP."""
    args, dy = _inputs(80, 8, 3, 2, seed=5)
    want_y, want = _jax_fwd_and_grads(args, dy)
    ts = [t.clone().requires_grad_() for t in args[:7]] + [args[8].clone().requires_grad_()]
    counts = [f.launches for f in TF.KERNELS]
    y = TF.fused_edgewise_lowrank_attention(*ts[:7], beta_not=args[7], chain_w=ts[7])
    got = torch.autograd.grad(y, ts, dy)
    assert [f.launches for f in TF.KERNELS] == counts  # CPU tensors launch no kernel
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=2e-4, atol=2e-5)
    for name, g, w in zip(("qs", "ks", "vs", "wrow", "brow", "wcol", "bcol", "chain_w"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-4,
                                   err_msg=name)


def test_tf32x3_stages_above_n64_match_the_jax_kernel():
    """N = 80: the stages with every product as 3xTF32 against the JAX
    kernel's forward and in-kernel VJP (per-program weight grads summed)."""
    args, dy = _inputs(80, 8, 3, 2, seed=5)
    want_y, want = _jax_fwd_and_grads(args, dy)
    y, got = wide_stages(*args, dy, mm=mm_3xtf32)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=2e-4, atol=2e-5)
    dq, dk, dv, dwrow, dbrow, dwcol, dbcol, dchain = got
    summed = (dq, dk, dv, dwrow.sum(0), dbrow.sum((0, 1)), dwcol.sum(0), dbcol.sum((0, 1)),
              dchain.sum())
    for name, g, w in zip(("qs", "ks", "vs", "wrow", "brow", "wcol", "bcol", "chain_w"),
                          summed, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-4,
                                   err_msg=name)


def test_wrappers_on_cpu_are_the_plain_versions():
    args, dy = _inputs(70, 8, 3, 1, seed=9)
    before = (TF.edgewise_lowrank_wide_fwd.launches, TF.edgewise_lowrank_wide_bwd.launches)
    torch.testing.assert_close(TF.edgewise_lowrank_wide_fwd(*args),
                               TF.fused_edgewise_lowrank_attention_plain(*args), rtol=0, atol=0)
    for g, w in zip(TF.edgewise_lowrank_wide_bwd(*args, dy),
                    TF.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (TF.edgewise_lowrank_wide_fwd.launches,
            TF.edgewise_lowrank_wide_bwd.launches) == before


def test_envelope_and_workspace():
    """The lowrank op's kernels take N <= 256 (K2 / K2b to 64, K2w / K2bw
    above), dk <= 128 and 2 <= V <= 8, as the JAX kernel's envelope; the
    workspace holds 643,272 fp32 values a program in the forward and
    1,254,792 in the backward at VOC E's (V, N, dk, r) = (4, 196, 64, 4)
    (the kernels' own layout; chip_smoke.py holds the two counts equal)."""
    for dtype in (torch.float32, BF16):
        assert TF.edgewise_lowrank_fits(dtype, 4, 196, 64, 4)
        assert TF.edgewise_lowrank_fits(dtype, 8, 256, 128, 1)
        assert not TF.edgewise_lowrank_fits(dtype, 4, 257, 64, 4)
        assert not TF.edgewise_lowrank_fits(dtype, 9, 196, 64, 4)
        assert not TF.edgewise_lowrank_fits(dtype, 4, 196, 129, 4)
    assert TF.edgewise_wide_ws_bytes(4, 196, 64, 4, False) == 4 * 643_272
    assert TF.edgewise_wide_ws_bytes(4, 196, 64, 4, True) == 4 * 1_254_792
    big = torch.zeros(1, 1, 4, 257, 8)
    w = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="N <= 256"):
        TF._edgewise_shapes("k", big, big, big, w, w[0], w, w[0], 8, lambda *s: 0,
                             TF.WIDE_MAX_N)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lowrank_module_fuses_at_n196(train, monkeypatch):
    """VOC E's head (lowrank, 4 views, rank 4) at N = 196, narrowed to dim 32:
    the module calls the fused op, in eval and in training, and matches the
    JAX module (which composes on the CPU)."""
    x = np.random.default_rng(7).standard_normal((1, 196, 32)).astype(np.float32)
    kw = dict(n_views=4, gate_mode="lowrank", gate_rank=4, gate_init="neutral")
    jm = JEdgewiseMSA(dim=32, heads=2, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(7), jnp.asarray(x)))
    tm = load_jax_params(EdgewiseMSA(dim=32, heads=2, **kw), params)
    calls = []
    orig = TF.fused_edgewise_lowrank_attention
    monkeypatch.setattr(TF, "fused_edgewise_lowrank_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        y = tm.train(train)(torch.from_numpy(x))
    assert len(calls) == 1
    np.testing.assert_allclose(y.numpy(), np.asarray(jm.apply(params, jnp.asarray(x))),
                               rtol=2e-4, atol=2e-5)
