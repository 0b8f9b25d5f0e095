"""K4 and the C/D attention modules: the port's multi-hop op (its plain
forward, which CPU tensors run, and its recompute backward) against the JAX
Pallas kernel in TPU interpret mode and ``jax.grad`` through it;
``MultiHopMSA``, ``DualPathMSA``, ``CrossViewMixerMSA`` and ``UnifiedMSA``
against the JAX modules with transplanted weights, in eval and train mode and
under a mask; and the torch-reference goldens of C, D and the two-hop MSA."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mop_tpu.models as J
import mop_tpu.ops.fused as JF
import mop_tpu_torch.models as PM
import mop_tpu_torch.ops.fused as TF
from mop_tpu.utils.torch_port import load_golden, port_torch_state_dict
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
RTOL, ATOL = 2e-4, 3e-5  # forward: the goldens' rtol, the JAX K4 test's atol
G_RTOL, G_ATOL = 10 * RTOL, 10 * ATOL  # grads: 10x the forward's
M_ATOL, M_RTOL = 1e-4, 1e-3  # module grads (tests/test_ops.py's fused-backward tolerance)
GATES = dict(base=0.9, and_=1.0, or_=0.5, not_=0.25, chain=0.75)
NAMES = ("q1", "k1", "v1", "q2", "k2", "v2", "chain_w")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(6)] + [np.float32(0.3)]


def _jax_op(arrays, gates, hops, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        return JF.fused_multihop_attention(
            *[jnp.asarray(a, dtype) for a in arrays[:6]], gates=gates, beta_not=0.5, hops=hops,
            chain_w=jnp.asarray(arrays[6]), force=True)


# ------------------------------ (a) the op ------------------------------


@pytest.mark.parametrize("hops", [2, 3, 4])
def test_multihop_op_matches_jax_kernel(hops):
    arrays = _inputs((2, 2, 16, 8), seed=hops)
    want = _jax_op(arrays, GATES, hops)
    before = [f.launches for f in TF.KERNELS]
    got = TF.fused_multihop_attention(*[torch.from_numpy(np.asarray(a)) for a in arrays[:6]],
                                      GATES, 0.5, hops, torch.tensor(arrays[6]))
    assert [f.launches for f in TF.KERNELS] == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_multihop_op_default_gates_and_odd_shape_match_jax_kernel():
    arrays = _inputs((1, 3, 12, 20), seed=7)
    want = _jax_op(arrays, {}, 3)
    got = TF.fused_multihop_attention(*[torch.from_numpy(np.asarray(a)) for a in arrays[:6]],
                                      {}, 0.5, 3, float(arrays[6]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_multihop_op_bf16_matches_jax_kernel():
    arrays = _inputs((2, 2, 16, 8), seed=8)
    want = np.asarray(_jax_op(arrays, GATES, 3, jnp.bfloat16), np.float32)
    got = TF.fused_multihop_attention(
        *[torch.from_numpy(np.asarray(a)).bfloat16() for a in arrays[:6]], GATES, 0.5, 3,
        torch.tensor(arrays[6]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=5e-2)


def test_multihop_strided_views_match_contiguous():
    arrays = _inputs((2, 16, 2, 8), seed=9)
    ts = [torch.from_numpy(a) for a in arrays[:6]]
    strided = [t.transpose(1, 2) for t in ts]  # (B, H, N, dk) views of (B, N, H, dk)
    assert not strided[0].is_contiguous()
    want = TF.fused_multihop_attention(*[t.contiguous() for t in strided], GATES, 0.5, 3, 0.3)
    got = TF.fused_multihop_attention(*strided, GATES, 0.5, 3, 0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_multihop_kernel_refuses_shapes_outside_its_envelope():
    def call(n, dk, hops):
        t = torch.zeros(1, 1, n, dk)
        TF._multihop_fwd_cuda(t, t, t, t, t, t, {}, 0.5, hops, 0.3)

    for n, dk, hops in ((65, 8, 3), (16, 129, 3), (16, 8, 1)):
        with pytest.raises(ValueError, match="outside the kernel's shapes"):
            call(n, dk, hops)
    t = torch.zeros(1, 1, 16, 8)
    with pytest.raises(ValueError, match="shapes"):
        TF._multihop_fwd_cuda(t, t, t, t, t, torch.zeros(1, 1, 16, 4), {}, 0.5, 3, 0.3)


def multihop_fp32_schedule(q1, k1, v1, q2, k2, v2, gates, beta_not, hops, chain_w):
    """K4's fp32 kernel in its own order: the scores of q * scale, both
    softmaxes and the mix as ``_multihop_kernel``, the fp32 chain
    C = A1 A2^(hops-1) (every cast of the JAX kernel is the identity in
    fp32), its log term, att, and y = [att | w C] [v1 ; v2] as one product
    over K = 2N, where the JAX kernel runs the transport A1 (A2 (... v2))."""
    sc = torch.tensor(1.0 / np.sqrt(q1.shape[-1]), dtype=torch.float32)
    s1 = (q1 * sc) @ k1.transpose(-1, -2)
    s2 = (q2 * sc) @ k2.transpose(-1, -2)
    a1, a2 = torch.softmax(s1, -1), torch.softmax(s2, -1)
    c = a1 @ a2
    for _ in range(hops - 2):
        c = c @ a2
    base, g_and, g_or, g_not, g_chain = TF._gate_values(gates)
    smix = base * s1
    smix = smix + g_and * s2
    smix = smix + g_or * (torch.logaddexp(s1, s2) - s1)
    smix = smix - g_not * (beta_not * s2)
    smix = smix + g_chain * torch.log(c + 1e-6)
    att = torch.softmax(smix, -1)
    w = torch.as_tensor(chain_w, dtype=torch.float32)
    return torch.cat([att, w * c], -1) @ torch.cat([v1, v2], -2)


@pytest.mark.parametrize("dk", [8, 64, 100])
@pytest.mark.parametrize("n", [1, 33, 64])
@pytest.mark.parametrize("hops", [2, 3, 4])
def test_multihop_fp32_schedule_matches_jax_kernel_and_plain(hops, n, dk):
    arrays = _inputs((1, 2, n, dk), seed=100 * hops + n + dk)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays[:6]]
    got = multihop_fp32_schedule(*ts, GATES, 0.5, hops, float(arrays[6]))
    want = _jax_op(arrays, GATES, hops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    plain = TF.fused_multihop_attention_plain(*ts, GATES, 0.5, hops, float(arrays[6]))
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype,n,dk,smem", [
    # fp32 (F32Layout, np = round4(N), lq = ld4(dk)): [att | C] N (2 np + 4),
    # A2 from max(att + A1's N (np + 4), q1 and k1's 2 N lq), the stacked
    # [v1 ; v2] 2 np lq after max(A2 + np (np + 4), q2 and k2's end).
    (torch.float32, 64, 64, 104448),   # the main shape: two programs an SM
    (torch.float32, 33, 100, 88128),   # q and k reach past A2
    (torch.float32, 64, 128, 202752),  # the envelope's widest
    # bf16, unchanged: four N x N fp32 maps and two N x dk buffers, rows at
    # an odd stride.
    (torch.bfloat16, 64, 64, 99840),
    (torch.bfloat16, 33, 100, 44088),
])
def test_multihop_smem_bytes(dtype, n, dk, smem):
    """K4's shared memory at (N, dk) (``multihop_smem_bytes``, which
    chip_smoke.py phase 2 holds to the kernel's own count), counted from the
    kernel's layout."""
    assert TF.multihop_smem_bytes(dtype, n, dk) == smem


def test_multihop_smem_bytes_envelope():
    """fp32 K4 fits two programs an SM at the main shape (113 KB a block at
    most) and every shape of the envelope in a block's 227 KB."""
    assert TF.multihop_smem_bytes(torch.float32, 64, 64) <= 113 * 1024
    for n in range(1, TF.MULTIHOP_MAX_N + 1):
        for dk in range(1, TF.MULTIHOP_MAX_DK + 1):
            for dtype in (torch.float32, torch.bfloat16):
                assert TF.multihop_smem_bytes(dtype, n, dk) <= TF.MAX_SMEM_BYTES


@pytest.mark.parametrize("hops", [2, 3])
def test_multihop_function_grads_match_jax_grad(hops):
    arrays = _inputs((2, 2, 16, 8), seed=20 + hops)
    dy = np.random.default_rng(30 + hops).standard_normal((2, 2, 16, 8)).astype(np.float32)

    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            y = JF.fused_multihop_attention(*a[:6], gates=GATES, beta_not=0.5, hops=hops,
                                            chain_w=a[6], force=True)
        return jnp.sum(y * dy)

    want = jax.grad(loss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = TF.fused_multihop_attention(*ts[:6], GATES, 0.5, hops, ts[6])
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=name)


def test_multihop_function_saves_only_its_inputs_and_keeps_dtypes():
    arrays = _inputs((1, 2, 8, 8), seed=40)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays[:6]]
    ts = [t.bfloat16() for t in ts] + [torch.tensor(0.3, requires_grad=True)]
    y = TF.fused_multihop_attention(*ts[:6], GATES, 0.5, 3, ts[6])
    assert len(y.grad_fn.saved_tensors) == 7
    grads = torch.autograd.grad(y.float().sum(), ts)
    assert [g.dtype for g in grads] == [t.dtype for t in ts]


# ------------------------------ (b) the modules ------------------------------

MODULES = {
    "D_hops3": (J.MultiHopMSA, PM.MultiHopMSA, dict(beta_not=0.5, gates=GATES, hops=3)),
    "D_hops2_default_gates": (J.MultiHopMSA, PM.MultiHopMSA, dict(hops=2)),
    "dualpath": (J.DualPathMSA, PM.DualPathMSA, dict(beta_not=0.6, gates=GATES)),
    "C_fixed_prior": (J.CrossViewMixerMSA, PM.CrossViewMixerMSA,
                      dict(use_transpose_cues=True, t1=0.1, t2=0.2, enable_per_key_prior=True,
                           prior_weight=0.3, anchor_mode="fixed", fixed_k_star=5)),
    "C_none_anchor": (J.CrossViewMixerMSA, PM.CrossViewMixerMSA,
                      dict(use_transpose_cues=False, t1=0.5, enable_per_key_prior=True,
                           anchor_mode="none")),
    "C_plain": (J.CrossViewMixerMSA, PM.CrossViewMixerMSA, dict()),
}


def _module_pair(name, seed=3):
    jcls, pcls, kw = MODULES[name]
    x = np.random.default_rng(seed).standard_normal((2, 16, 32)).astype(np.float32)
    jm = jcls(dim=32, heads=4, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    p = params["params"]
    rng = np.random.default_rng(seed + 1)
    # Move the scalar leaves off their init, so that loading them is tested.
    if "chain_value_logit" in p:
        p["chain_value_logit"] = np.float32(rng.uniform(-1.0, 1.0))
    if "mix" in p:
        p["mix"] = (np.eye(2) + 0.3 * rng.standard_normal((2, 2))).astype(np.float32)
    return jm, params, load_jax_params(pcls(dim=32, heads=4, **kw), params), x


def _mask():
    m = np.ones((2, 1, 1, 16), np.float32)
    m[1, ..., -3:] = 0.0  # the last three keys of the second sequence are padding
    return m


def _check_against_jax(jm, params, tm, x, train, mask=None):
    """Output, input grads and every parameter's grad against the JAX module."""
    dy = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(p, xx):
        y = jm.apply(p, xx, attn_mask=jmask, train=train,
                     rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * dy), y

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt) if mask is None else tm(xt, torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=M_ATOL, rtol=M_RTOL)
    want_g = jax_state_dict(jax.device_get(gp))
    got_g = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k], atol=M_ATOL, rtol=M_RTOL, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train):
    _check_against_jax(*_module_pair(name), train)


@pytest.mark.parametrize("name", ["D_hops3", "dualpath", "C_fixed_prior"])
def test_masked_module_matches_jax(name):
    """A mask takes the composed path in eval mode too, as in JAX."""
    _check_against_jax(*_module_pair(name, seed=5), False, mask=_mask())


@pytest.mark.parametrize("name,hops", [("D_hops3", 3), ("dualpath", 2)])
def test_eval_route_is_k4_and_train_route_composes(name, hops):
    _, _, tm, x = _module_pair(name, seed=6)
    calls = []
    orig = TF.fused_multihop_attention_plain

    def spy(*a, **k):
        calls.append(a[8])  # hops
        return orig(*a, **k)

    TF.fused_multihop_attention_plain = spy
    try:
        with torch.no_grad():
            tm.eval()(torch.from_numpy(x))
            tm.eval()(torch.from_numpy(x), torch.from_numpy(_mask()))
            tm.train()(torch.from_numpy(x))
    finally:
        TF.fused_multihop_attention_plain = orig
    assert calls == [hops]


def test_crossview_argmax_anchor_picks_the_row_of_largest_sum():
    _, _, tm, _ = _module_pair("C_fixed_prior")
    a2 = torch.softmax(torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(0)), -1)
    a2[1, 2, 4] = 0.0
    a2[1, 2, 4, 0] = 3.0  # row 4 of (1, 2) has the largest sum
    tm.anchor_mode = "argmax_row_sum"
    row = tm._anchor(a2)
    assert row.shape == (2, 3, 1, 6)
    torch.testing.assert_close(row[1, 2, 0], a2[1, 2, 4])
    tm.anchor_mode, tm.fixed_k_star = "fixed", 99  # clamped to the last row
    torch.testing.assert_close(tm._anchor(a2)[0, 0, 0], a2[0, 0, 5])


def test_multihop_needs_two_hops():
    with pytest.raises(ValueError, match="hops"):
        PM.MultiHopMSA(32, 4, hops=1)


UNIFIED = {
    "A": dict(),
    "B": dict(),
    "C": dict(enable_per_key_prior=True, anchor_mode="fixed", fixed_k_star=2, t1=0.2),
    "D": dict(gates=GATES, hops=3),
    "E": dict(n_views=3, gate_mode="lowrank", gate_rank=2, gate_init="mix5", share_qkv=True,
              use_lens_bank=True, lens_dilations=(1, 2)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", sorted(UNIFIED))
def test_unified_msa_matches_jax(mode, train):
    kw = dict(mode=mode, dim=32, heads=4, **UNIFIED[mode])
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(np.float32)
    jm = J.UnifiedMSA(**kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tm = load_jax_params(PM.UnifiedMSA(**kw), params)
    _check_against_jax(jm, params, tm, x, train)


def test_unified_msa_refuses_unknown_modes_and_masks_on_e():
    with pytest.raises(ValueError, match="Unknown attention mode"):
        PM.UnifiedMSA("F", 32)
    tm = PM.UnifiedMSA("E", 32, 4)
    with pytest.raises(NotImplementedError, match="mask"):
        tm(torch.zeros(1, 4, 32), torch.ones(1, 1, 1, 4))


# ------------------------------ (c) goldens ------------------------------


@pytest.mark.parametrize("name,ctor", [
    ("multihop_msa", lambda: PM.MultiHopMSA(
        dim=32, heads=4, beta_not=0.5,
        gates=dict(base=1.0, and_=1.0, or_=0.5, not_=0.25, chain=0.75), hops=3)),
    ("dualpath_msa", lambda: PM.DualPathMSA(
        dim=32, heads=4, beta_not=0.5,
        gates=dict(base=0.9, and_=1.0, or_=0.5, not_=0.25, chain=0.75))),
    ("crossview_msa", lambda: PM.CrossViewMixerMSA(
        dim=32, heads=4, use_transpose_cues=True, t1=0.1, t2=0.2, enable_per_key_prior=True,
        prior_weight=0.5, anchor_mode="fixed", fixed_k_star=3)),
])
def test_msa_reference_golden(name, ctor):
    """The torch reference's state dict loads by name and reproduces its
    eval output (K4 for D and the two-hop MSA)."""
    ins, ws, outs = load_golden(os.path.join(GOLDEN, f"{name}.npz"))
    model = ctor().eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ws.items()},
                          strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(ins["x"]))
    np.testing.assert_allclose(y.numpy(), outs["y"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name,cls", [("C", PM.CrossViewMixerMSA), ("D", PM.MultiHopMSA)])
def test_msa_trajectory_matches_torch_reference(name, cls):
    data = np.load(os.path.join(GOLDEN, f"trajectory_msa_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("w__")}
    golden = data["out__losses"]
    model = cls(dim=MSA_CONFIG["dim"], heads=MSA_CONFIG["heads"], **MSA_KWARGS[name])
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


@pytest.mark.parametrize("name", ["D_hops3", "dualpath", "C_fixed_prior"])
def test_scalar_leaves_round_trip_exactly(name):
    """JAX -> port (load_jax_params) -> JAX (port_torch_state_dict) gives the
    scalar leaves back bit for bit, shapes included."""
    _, params, tm, _ = _module_pair(name, seed=11)
    p = params["params"]
    back = port_torch_state_dict({k: v.detach().numpy() for k, v in tm.state_dict().items()},
                                 params)["params"]
    for key in ("chain_value_logit", "mix"):
        if key in p:
            got = getattr(tm, key).detach().numpy()
            assert got.shape == np.shape(p[key]) and np.array_equal(got, p[key]), key
            assert np.shape(back[key]) == np.shape(p[key]), key
            assert np.array_equal(np.asarray(back[key]), p[key]), key


@pytest.mark.parametrize("cls", [PM.MultiHopMSA, PM.DualPathMSA, PM.CrossViewMixerMSA])
def test_attention_dropout_draws_from_the_generator(cls):
    torch.manual_seed(0)
    tm = cls(32, 4, attn_drop=0.5).train()
    x = torch.randn(2, 16, 32)
    with pytest.raises(RuntimeError, match="generator"):
        tm(x)
    ys = []
    for seed in (1, 1, 2):
        PM.set_generator(tm, torch.Generator().manual_seed(seed))
        ys.append(tm(x))
    assert torch.equal(ys[0], ys[1]) and not torch.equal(ys[0], ys[2])
    assert torch.equal(tm.eval()(x), tm(x))  # eval mode drops nothing
