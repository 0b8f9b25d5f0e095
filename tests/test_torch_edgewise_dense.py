"""K3 / K3b and the rest of ``EdgewiseMSA``: the port's dense-gate op (its
plain forward and backward, which CPU tensors run) against the JAX Pallas
kernel and its in-kernel VJP in TPU interpret mode; the hand-derived VJP that
K3b implements, written out in fp64 against autograd; ``EdgewiseMSA`` with
the dense head, ``use_k3``, ``share_qkv`` and both lens banks against the JAX
module, in eval and train mode; the torch-reference goldens; and the
full ``ViTEdgewise`` dense model through the eval and train steps."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mop_tpu.models as J
import mop_tpu.ops.fused as JF
import mop_tpu.ops.preprocess as jpp
import mop_tpu_torch as P
import mop_tpu_torch.ops.fused as TF
from mop_tpu.models import EdgewiseMSA as JEdgewiseMSA
from mop_tpu.parallel import make_classifier_eval_step as jax_eval_step
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_mesh
from mop_tpu.utils.torch_port import load_golden
from mop_tpu_torch.models import EdgewiseMSA
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params
from tools.trajectory_parity import LR, MSA_CONFIG, MSA_KWARGS, WD, make_msa_batches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL, ATOL = 2e-4, 2e-5  # forward (tests/test_golden_numerics.py)
G_ATOL, G_RTOL = 1e-4, 1e-3  # grads (tests/test_ops.py's fused-backward tolerance)
NAMES = ("qs", "ks", "vs", "w1", "b1", "w2", "b2", "chain_w")


def _inputs(n, dk, v_, seed):
    rng = np.random.default_rng(seed)
    qs, ks, vs = (rng.standard_normal((2, 2, v_, n, dk)).astype(np.float32)
                  for _ in range(3))
    c = 2 * v_ + 2
    w1 = (rng.standard_normal((c, 16)) * 0.3).astype(np.float32)
    b1 = np.linspace(-0.5, 0.5, 16).astype(np.float32)
    w2 = (rng.standard_normal((16, 4)) * 0.5).astype(np.float32)
    b2 = np.array([-1.0, 0.5, -0.5, 1.0], np.float32)
    dy = rng.standard_normal((2, 2, n, dk)).astype(np.float32)
    return (qs, ks, vs, w1, b1, w2, b2, np.float32(0.4)), dy


def _jax_dense(arrays, beta_not, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        return JF.fused_edgewise_dense_attention(
            *[jnp.asarray(a, dtype) for a in arrays[:3]], *[jnp.asarray(a) for a in arrays[3:7]],
            beta_not=beta_not, chain_w=jnp.asarray(arrays[7]), force=True)


def _port_dense(arrays, beta_not, dtype=torch.float32, grad=False):
    ts = [torch.tensor(a, dtype=dtype if i < 3 else torch.float32, requires_grad=grad)
          for i, a in enumerate(arrays)]
    return ts, TF.fused_edgewise_dense_attention(*ts[:7], beta_not=beta_not, chain_w=ts[7])


# ------------------------------ (a) the op ------------------------------


@pytest.mark.parametrize("v_", [2, 3, 5])
def test_dense_op_matches_jax_kernel(v_):
    arrays, _ = _inputs(16, 8, v_, seed=30 + v_)
    want = _jax_dense(arrays, 0.7)
    before = [f.launches for f in TF.KERNELS]
    _, got = _port_dense(arrays, 0.7)
    assert [f.launches for f in TF.KERNELS] == before  # CPU tensors launch no kernel
    assert got.shape == (2, 2, 16, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("v_", [2, 5, 8])
@pytest.mark.parametrize("n", [16, 33, 64])
@pytest.mark.parametrize("dk", [8, 54, 100])
def test_dense_op_bf16_matches_jax_kernel(v_, n, dk):
    """The bf16 plain version (what the tensor-core K3 is held to on the
    card) against the JAX kernel in bf16 interpret mode, over the views, the
    sequence lengths (one and several 16-edge blocks, a ragged one) and the
    head widths K3 takes. Both round at the same points; at most 1% of the
    outputs may differ at all, where an fp32 sum in another order flips a
    bf16 rounding."""
    arrays, _ = _inputs(n, dk, v_, seed=40 + v_ + n + dk)
    want = np.asarray(_jax_dense(arrays, 0.5, jnp.bfloat16), np.float32)
    _, got = _port_dense(arrays, 0.5, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=5e-2)
    assert (got.float().numpy() != want).mean() <= 0.01


def test_dense_strided_views_match_contiguous():
    arrays, _ = _inputs(16, 8, 3, seed=41)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays]
    strided = [t.permute(0, 3, 2, 1, 4).contiguous().permute(0, 3, 2, 1, 4) for t in ts[:3]]
    assert not strided[0].is_contiguous()
    want = TF.fused_edgewise_dense_attention(*ts[:7], beta_not=0.5, chain_w=0.3)
    got = TF.fused_edgewise_dense_attention(*strided, *ts[3:7], beta_not=0.5, chain_w=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dense_op_refuses_use_k3_and_foreign_shapes():
    arrays, _ = _inputs(16, 8, 3, seed=42)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays]
    with pytest.raises(ValueError, match="use_k3"):
        TF.fused_edgewise_dense_attention(*ts[:7], 0.5, 0.3, wk3=torch.zeros(3, 3, 16, 16))
    with pytest.raises(ValueError, match="gate-head shapes"):
        TF._dense_shapes("k", *ts[:3], ts[3][:, :8], *ts[4:7], lambda *a: 0)
    many = torch.zeros(1, 1, 9, 16, 8)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        TF._dense_shapes("k", many, many, many, torch.zeros(20, 16), *ts[4:7], lambda *a: 0)
    with pytest.raises(ValueError, match="shared memory"):
        TF._dense_shapes("k", *ts[:7], lambda *a: TF.MAX_SMEM_BYTES + 1)


# ---------------------------- (b) the backward ----------------------------


def _jax_grads(arrays, dy, beta_not):
    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            y = JF.fused_edgewise_dense_attention(*a[:7], beta_not=beta_not, chain_w=a[7],
                                                  force=True)
        return jnp.sum(y * dy)

    return jax.grad(loss, argnums=tuple(range(8)))(*[jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("v_", [2, 5])
def test_dense_function_grads_match_jax_kernel(v_):
    arrays, dy = _inputs(16, 8, v_, seed=50 + v_)
    want = _jax_grads(arrays, dy, 0.7)
    ts, y = _port_dense(arrays, 0.7, grad=True)
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=G_ATOL, rtol=G_RTOL,
                                   err_msg=name)


def test_dense_bwd_plain_per_program_layout_sums_to_the_grads():
    arrays, dy = _inputs(16, 8, 3, seed=55)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays]
    out = TF.fused_edgewise_dense_attention_bwd(*ts[:7], 0.7, ts[7], torch.from_numpy(dy))
    dq, dk, dv, dw1, db1, dw2, db2, dch = out
    assert dq.shape == dk.shape == dv.shape == (2, 2, 3, 16, 8) and dq.is_contiguous()
    assert dw1.shape == (4, 8, 16) and db1.shape == (4, 1, 16)
    assert dw2.shape == (4, 16, 4) and db2.shape == (4, 1, 4) and dch.shape == (4,)
    assert torch.count_nonzero(dv[:, :, 1]) == 0  # only v_0 and v_{V-1} get a grad
    ts_g, y = _port_dense(arrays, 0.7, grad=True)
    grads = torch.autograd.grad(y, ts_g, torch.from_numpy(dy))
    sums = (dq, dk, dv, dw1.sum(0), db1.sum((0, 1)), dw2.sum(0), db2.sum((0, 1)), dch.sum())
    for name, s, g in zip(NAMES, sums, grads):
        torch.testing.assert_close(s, g, rtol=1e-5, atol=1e-6, msg=name)


def test_dense_grads_come_back_in_each_inputs_dtype():
    arrays, dy = _inputs(16, 8, 3, seed=56)
    ts, y = _port_dense(arrays, 0.5, torch.bfloat16, grad=True)
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy).bfloat16())
    assert all(g.dtype == t.dtype for g, t in zip(got, ts))
    ts32, y32 = _port_dense(arrays, 0.5, grad=True)
    want = torch.autograd.grad(y32, ts32, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        # bf16 rounds the operands of every product: hold each grad to 5% of
        # its largest magnitude.
        err = (g.float() - w).abs().max().item()
        assert err <= 5e-2 * w.abs().max().item(), (name, err)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _gelu_grad(x):
    k = math.sqrt(2.0 / math.pi)
    t = torch.tanh(k * (x + 0.044715 * x ** 3))
    return 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * k * (1 + 3 * 0.044715 * x * x)


def _program_forward(q, k, v, w1, b1, w2, b2, beta, w):
    """One program of the dense pipeline in the input dtype, with the
    intermediates the hand-derived VJP reads."""
    nv, n, dk = q.shape
    sc = 1.0 / math.sqrt(dk)
    s = [(q[i] * sc) @ k[i].T for i in range(nv)]
    a = [torch.softmax(x, -1) for x in s]
    fm = [None, a[0] @ a[1]]
    bm = [None, a[-1] @ a[-2]]
    for j in range(2, nv):
        fm.append(fm[j - 1] @ a[j])
        bm.append(bm[j - 1] @ a[nv - 1 - j])
    cf, cb = fm[nv - 1], bm[nv - 1]
    lf, lb = torch.log(cf + 1e-6), torch.log(cb + 1e-6)
    feat = torch.stack(s + [x.T for x in s] + [lf, lb], -1)  # (N, N, C)
    pre = feat @ w1 + b1
    hid = _gelu(pre)
    g = torch.sigmoid(hid @ w2 + b2).unbind(-1)
    stack = torch.stack(s)
    lse = torch.logsumexp(stack, 0)
    others = stack.sum(0) - s[0]
    n_o = max(1, nv - 1)
    smix = s[0] + g[0] * others + g[1] * (lse - s[0]) - g[2] * beta * others / n_o + g[3] * lf
    att = torch.softmax(smix, -1)
    pv = [None] * (nv + 1)
    pv[nv] = v[nv - 1]
    for i in range(nv - 1, 0, -1):
        pv[i] = a[i] @ pv[i + 1]
    y = att @ v[0] + w * (a[0] @ pv[1])
    return dict(sc=sc, s=s, a=a, fm=fm, bm=bm, cf=cf, cb=cb, lf=lf, feat=feat, pre=pre, hid=hid,
                g=g, stack=stack, lse=lse, others=others, n_o=n_o, att=att, pv=pv, y=y)


def _kernel_edge_order(n):
    """The order in which K3b's dense edge walk adds each edge to the warps'
    weight-grad sums: pairs of 16 x 16 edge blocks (bi <= bj), block
    (bi, bj) and then (bj, bi), warp w taking edges 32w .. 32w + 31 of each
    block. One list of edges per warp; the warps' sums are added in order."""
    nb = -(-n // 16)
    order = [[] for _ in range(8)]
    for bi in range(nb):
        for bj in range(bi, nb):
            for b0, b1 in ((bi, bj),) if bi == bj else ((bi, bj), (bj, bi)):
                for e in range(256):
                    i, j = b0 * 16 + e // 16, b1 * 16 + e % 16
                    if i < n and j < n:
                        order[e // 32].append((i, j))
    return order


def _walk_sum(order, x, y):
    """sum over the edges (i, j) of x[i, j] (x) y[i, j], in the walk's order."""
    total = 0
    for edges in order:
        part = 0
        for i, j in edges:
            part = part + torch.outer(x[i, j], y[i, j])
        total = total + part
    return total


def _hand_vjp(q, k, v, w1, b1, w2, b2, beta, w, dy):
    """K3b's derivation (csrc/edgewise_bwd.cu, stages 1-6 with the dense
    head's single-visit edge walk) for one program, written with plain
    tensor ops: (dq, dk, dv, dw1, db1, dw2, db2, dchain). Each dS_c is the
    mix's share plus the edge's own channel, then the transposed channel's
    share, as the walk adds them."""
    nv = q.shape[0]
    f = _program_forward(q, k, v, w1, b1, w2, b2, beta, w)
    sc, s, a, fm, bm, cf, cb, lf = (f[key] for key in ("sc", "s", "a", "fm", "bm", "cf", "cb",
                                                        "lf"))
    feat, pre, hid, g, stack, lse = (f[key] for key in ("feat", "pre", "hid", "g", "stack",
                                                         "lse"))
    others, n_o, att, pv = f["others"], f["n_o"], f["att"], f["pv"]
    # 1. output and transport
    dchain = (dy * (a[0] @ pv[1])).sum()
    datt = dy @ v[0].T
    dv = torch.zeros_like(v)
    dv[0] = att.T @ dy
    da = [None] * nv
    da[0] = w * dy @ pv[1].T
    dp = w * a[0].T @ dy
    for i in range(1, nv):
        da[i] = dp @ pv[i + 1].T
        dp = a[i].T @ dp
    dv[nv - 1] = dv[nv - 1] + dp
    # 2. softmax of smix and the mix
    dsm = att * (datt - (datt * att).sum(-1, keepdim=True))
    p = torch.exp(stack - lse)
    ds = [dsm * (1 - g[1]) + dsm * g[1] * p[0]]
    ds += [dsm * (g[0] - g[2] * beta / n_o) + dsm * g[1] * p[i] for i in range(1, nv)]
    dg = (dsm * others, dsm * (lse - s[0]), -dsm * beta * others / n_o, dsm * lf)
    dz = torch.stack([dg[c] * g[c] * (1 - g[c]) for c in range(4)], -1)  # (N, N, 4)
    # 3-4. the dense head's backward, per edge; the weight grads summed over
    # the edges in the kernel's order (_kernel_edge_order)
    dhid = dz @ w2.T
    dpre = dhid * _gelu_grad(pre)
    ones = torch.ones(*pre.shape[:2], 1, dtype=pre.dtype)
    order = _kernel_edge_order(pre.shape[0])
    dw1, db1 = _walk_sum(order, feat, dpre), _walk_sum(order, ones, dpre)[0]
    dw2, db2 = _walk_sum(order, hid, dz), _walk_sum(order, ones, dz)[0]
    dfeat = dpre @ w1.T  # (N, N, C)
    for c in range(nv):
        ds[c] = ds[c] + dfeat[..., c] + dfeat[..., nv + c].T
    dlf = dsm * g[3] + dfeat[..., 2 * nv]
    dlb = dfeat[..., 2 * nv + 1]
    # 5. chains
    for chain, dlog, cm, mats in ((0, dlf, cf, fm), (1, dlb, cb, bm)):
        df = dlog / (cm + 1e-6)
        for j in range(nv - 1, 1, -1):
            view = j if chain == 0 else nv - 1 - j
            da[view] = da[view] + mats[j - 1].T @ df
            df = df @ a[view].T
        v0, v1 = (0, 1) if chain == 0 else (nv - 1, nv - 2)
        da[v0] = da[v0] + df @ a[v1].T
        da[v1] = da[v1] + a[v0].T @ df
    # 6. score maps
    dq, dkey = torch.zeros_like(q), torch.zeros_like(k)
    for i in range(nv):
        dsi = ds[i] + a[i] * (da[i] - (da[i] * a[i]).sum(-1, keepdim=True))
        dq[i] = sc * dsi @ k[i]
        dkey[i] = dsi.T @ (q[i] * sc)
    return dq, dkey, dv, dw1, db1, dw2, db2, dchain


@pytest.mark.parametrize("v_", [2, 4])
def test_hand_derived_dense_vjp_matches_autograd(v_):
    """The stage-by-stage VJP that K3b writes out by hand, in fp64, against
    autograd through the same forward, program by program; that forward is
    the plain op's."""
    arrays, dy = _inputs(12, 8, v_, seed=60 + v_)
    ts = [torch.from_numpy(np.asarray(a)).double() for a in arrays]
    dyt = torch.from_numpy(dy).double()
    y32 = TF.fused_edgewise_dense_attention_plain(*[t.float() for t in ts[:7]], 0.6, 0.4)
    for b in range(2):
        for h in range(2):
            ins = [ts[0][b, h], ts[1][b, h], ts[2][b, h], *ts[3:7]]
            got = _hand_vjp(*ins, 0.6, ts[7], dyt[b, h])
            leaves = [t.clone().requires_grad_() for t in (*ins, ts[7])]
            y = _program_forward(*leaves[:7], 0.6, leaves[7])["y"]
            np.testing.assert_allclose(y.detach().numpy(), y32[b, h].numpy(), rtol=RTOL,
                                       atol=ATOL)
            want = torch.autograd.grad(y, leaves, dyt[b, h])
            for name, x, r in zip(NAMES, got, want):
                torch.testing.assert_close(x, r, rtol=1e-9, atol=1e-12, msg=name)


# ------------------------------ (c, d) EdgewiseMSA ------------------------------

MSA = {
    "dense": dict(n_views=3, gate_mode="dense", gate_init="and"),
    "dense_v5_neutral": dict(n_views=5, gate_mode="dense"),
    "dense_k3": dict(n_views=3, gate_mode="dense", gate_init="or", use_k3=True),
    "dense_shared": dict(n_views=3, gate_mode="dense", gate_init="chain", share_qkv=True),
    "dense_lens": dict(n_views=2, gate_mode="dense", gate_init="not", use_lens_bank=True,
                       lens_dilations=(1, 2)),
    "dense_lens_qk": dict(n_views=3, gate_mode="dense", share_qkv=True, use_lens_bank_qk=True,
                          lens_qk_dilations=(1, 3)),
    "lowrank_both_lens": dict(n_views=3, gate_mode="lowrank", gate_rank=2, gate_init="mix5",
                              share_qkv=True, use_lens_bank=True, use_lens_bank_qk=True,
                              lens_qk_causal=True),
}


def _msa_pair(name, seed=3):
    kw = dict(dim=32, heads=4, **MSA[name])
    x = np.random.default_rng(seed).standard_normal((2, 16, 32)).astype(np.float32)
    jm = JEdgewiseMSA(**kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    if kw.get("share_qkv"):  # move the per-view scales off their all-ones init
        scales = np.random.default_rng(4).uniform(0.5, 1.5, (3, kw["n_views"], 4, 1, 8))
        for key, s in zip(("q_scale", "k_scale", "v_scale"), scales):
            params["params"][key] = s.astype(np.float32)
    return jm, params, load_jax_params(EdgewiseMSA(**kw), params), x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MSA))
def test_edgewise_msa_matches_jax(name, train):
    """Output, input grads and every parameter's grad against the JAX module
    (which composes on the CPU), through the eval forward (the K3 route for
    the dense head) or the train forward (composed)."""
    jm, params, tm, x = _msa_pair(name)
    dy = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        y = jm.apply(p, xx, train=train, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * dy), y

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=G_ATOL, rtol=G_RTOL)
    want_g = jax_state_dict(jax.device_get(gp))
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k], atol=G_ATOL, rtol=G_RTOL, err_msg=k)


def _composed_route(monkeypatch):
    """Make ``EdgewiseMSA`` compose its dense head, as it does where the
    fused op's kernels do not take the shape."""
    monkeypatch.setattr(TF, "edgewise_dense_fits", lambda *a: False)


@pytest.mark.parametrize("name", ["dense", "dense_v5_neutral", "dense_shared"])
def test_dense_eval_route_equals_train_route(name, monkeypatch):
    """The fused route (K3 + K3b on the card), which the dense head takes in
    eval and in training, and the composed route are one function: same
    output and grads at fp32 on one module in training mode."""
    _, _, tm, x = _msa_pair(name, seed=11)
    dy = torch.from_numpy(np.random.default_rng(12).standard_normal(x.shape).astype(np.float32))
    out = {}
    for route in ("fused", "composed"):
        tm.zero_grad()
        xt = torch.from_numpy(x).requires_grad_()
        calls = []
        orig = TF.fused_edgewise_dense_attention_plain

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        with monkeypatch.context() as m:
            m.setattr(TF, "fused_edgewise_dense_attention_plain", spy)
            if route == "composed":
                _composed_route(m)
            y = tm.train(True)(xt)
        assert bool(calls) == (route == "fused")
        (y * dy).sum().backward()
        out[route] = (y.detach(), xt.grad, {k: p.grad.clone() for k, p in tm.named_parameters()})
    torch.testing.assert_close(out["fused"][0], out["composed"][0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(out["fused"][1], out["composed"][1], rtol=G_RTOL, atol=G_ATOL)
    for k, g in out["fused"][2].items():
        torch.testing.assert_close(g, out["composed"][2][k], rtol=G_RTOL, atol=G_ATOL, msg=k)


def test_dense_eval_route_bf16_close_to_train_route(monkeypatch):
    """At bf16 the fused route (eval and training alike) differs from the
    composed route by the composed path's cast of the feature stack to bf16
    before the head (the kernels keep it fp32)."""
    _, _, tm, x = _msa_pair("dense_v5_neutral", seed=13)
    tm = tm.to(torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        ev, tr = tm.eval()(xb).float(), tm.train()(xb).float()
        with monkeypatch.context() as m:
            _composed_route(m)
            comp = tm.train()(xb).float()
    assert torch.equal(ev, tr)
    assert (ev - comp).abs().max().item() <= 5e-2 * comp.abs().max().item()


def test_lens_qk_requires_shared_qkv():
    with pytest.raises(ValueError, match="share_qkv"):
        EdgewiseMSA(32, 4, use_lens_bank_qk=True)


# ------------------------------ (e) goldens ------------------------------


@pytest.mark.parametrize("name,kw", [
    ("edgewise_dense", dict(n_views=3, use_k3=True, gate_mode="dense", gate_init="and")),
    ("edgewise_lowrank_lens", dict(n_views=3, share_qkv=True, gate_mode="lowrank",
                                   gate_rank=2, gate_init="mix5", use_lens_bank=True,
                                   lens_dilations=(1, 2), use_lens_bank_qk=True,
                                   lens_qk_dilations=(1, 2), lens_qk_causal=True)),
])
def test_msa_reference_golden(name, kw):
    """The torch reference's state dict loads by name and reproduces its output."""
    ins, ws, outs = load_golden(os.path.join(GOLDEN, f"{name}.npz"))
    model = EdgewiseMSA(dim=32, heads=4, **kw).eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ws.items()},
                          strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(ins["x"]))
    np.testing.assert_allclose(y.numpy(), outs["y"], rtol=RTOL, atol=ATOL)


def test_msa_e_dense_trajectory_matches_torch_reference():
    data = np.load(os.path.join(GOLDEN, "trajectory_msa_E_dense.npz"))
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("w__")}
    golden = data["out__losses"]
    model = EdgewiseMSA(dim=MSA_CONFIG["dim"], heads=MSA_CONFIG["heads"], **MSA_KWARGS["E_dense"])
    model.load_state_dict(sd, strict=True)
    xs, ys = make_msa_batches(MSA_CONFIG)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    sch = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=xs.shape[0])
    losses = []
    model.train()
    for x, y in zip(xs, ys):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.mse_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        opt.step()
        sch.step()
        losses.append(loss.item())
    # tests/test_trajectory_parity.py: fp32 drift compounds through AdamW.
    np.testing.assert_allclose(losses[:10], golden[:10], rtol=2e-4)
    np.testing.assert_allclose(losses[10:], golden[10:], rtol=5e-3)


# ------------------------------ (f) ViTEdgewise dense ------------------------------

VIT = dict(dim=32, depth=2, heads=4, n_classes=10, n_views=3, gate_mode="dense",
           gate_init="and", drop_path=0.0)


def _batch(seed, b=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 3, 32, 32), dtype=np.uint8),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _vit_pair():
    jm = J.ViTEdgewise(**VIT)
    params = jax.device_get(jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 3, 32, 32))))
    return jm, params, load_jax_params(P.ViTEdgewise(**VIT, device="cpu"), params)


def test_vit_dense_eval_step_matches_jax():
    jm, params, pm = _vit_pair()
    mean, std = jpp.CIFAR100_MEAN, jpp.CIFAR100_STD
    x, y = _batch(1)
    with torch.no_grad():
        logits = pm.eval()(P.ops.preprocess.cifar_eval_transform(torch.from_numpy(x), mean, std))
    y[::2] = logits.argmax(-1).numpy()[::2]  # the count is neither 0 nor the batch
    mask = np.ones(16, np.float32)
    want = [float(v) for v in jax_eval_step(jm, make_mesh(n_devices=1), mean, std)(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))]
    plain = TF.fused_edgewise_dense_attention_plain
    calls = []
    TF.fused_edgewise_dense_attention_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        got = [float(v) for v in P.make_classifier_eval_step(pm, mean, std, device="cpu")(
            torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(mask))]
    finally:
        TF.fused_edgewise_dense_attention_plain = plain
    assert len(calls) == VIT["depth"]  # every block's eval forward took the K3 route
    assert got == want and 0 < got[0] < got[1]


def test_vit_dense_train_step_matches_jax():
    jm, params, pm = _vit_pair()
    mean, std = jpp.CIFAR100_MEAN, jpp.CIFAR100_STD
    x, y = _batch(2)
    jstep = jax_train_step(jm, optax.identity(), make_mesh(n_devices=1), mean, std,
                           augment=False, compute_dtype=None)
    p1, _, m = jstep(params, optax.identity().init(params), jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(0))
    want = jax_state_dict(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), jax.device_get(p1), params))
    step = P.make_classifier_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0), mean, std,
                                        augment=False, compute_dtype=None, device="cpu")
    got_loss = float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
    np.testing.assert_allclose(got_loss, float(m["loss"]), rtol=2e-4)
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], atol=G_ATOL, rtol=G_RTOL, err_msg=k)
