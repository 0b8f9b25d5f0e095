"""The top-1 MoE MLP of the port (``mop_tpu_torch.ops.moe``, ``MoEMLP`` and
``ViT_MoP(use_moe=True)``) against the JAX package: the dispatch indices, the
dense and routed ops in fp32 (values and grads; a capacity that overflows,
one that holds the worst load, where routed equals dense, and gate ties) and
their bf16 rounding points, the MoE ViT's logits and grads with both impls
through transplanted weights, and the weights' round trip through both
packages' carriers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.ops.moe as jmoe
import mop_tpu_torch as P
import mop_tpu_torch.ops.moe as tmoe
from mop_tpu.models.layers import gelu_tanh as jgelu
from mop_tpu.utils.torch_port import port_torch_state_dict
from mop_tpu_torch.models.layers import gelu_tanh as tgelu
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 2e-5
G_RTOL, G_ATOL = 2e-3, 2e-4
T, D, H, E = 48, 16, 32, 4


def _op_inputs(seed, ties=False):
    """(x, gate_w, gate_b, w1, w2, cotangent) as float32 numpy; with ``ties``
    the gate ranks experts 0 and 1 equal for every token, and 2 and 3 below
    (zero gate weights, biases 0.5, 0.5, 0.25, -1)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(T, D).astype(np.float32)
    gw = (rs.randn(D, E) * 0.5).astype(np.float32)
    gb = (rs.randn(E) * 0.1).astype(np.float32)
    if ties:
        gw[:] = 0.0
        gb[:] = [0.5, 0.5, 0.25, -1.0]
    w1 = (rs.randn(E, D, H) * 0.2).astype(np.float32)
    w2 = (rs.randn(E, H, D) * 0.2).astype(np.float32)
    ct = rs.randn(T, D).astype(np.float32)
    return x, gw, gb, w1, w2, ct


def _jax_op(impl, cf):
    if impl == "dense":
        return lambda *a: jmoe.dense_top1_mlp(*a, jgelu)
    return lambda *a: jmoe.top1_routed_mlp(*a, jgelu, capacity_factor=cf)


def _torch_op(impl, cf):
    if impl == "dense":
        return lambda *a: tmoe.dense_top1_mlp(*a, tgelu)
    return lambda *a: tmoe.top1_routed_mlp(*a, tgelu, capacity_factor=cf)


def _both(impl, cf, ins):
    """(JAX out, JAX grads, port out, port grads) of sum(op(...) * ct)."""
    *args, ct = ins
    jop = _jax_op(impl, cf)
    jout = np.asarray(jop(*map(jnp.asarray, args)))
    jgrads = jax.grad(lambda *a: jnp.sum(jop(*a) * ct), argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = _torch_op(impl, cf)(*targs)
    (tout * torch.from_numpy(ct)).sum().backward()
    return jout, [np.asarray(g) for g in jgrads], tout.detach().numpy(), [
        a.grad.numpy() for a in targs]


@pytest.mark.parametrize("expert,cap", [([0, 1, 1, 2, 1, 0, 1, 3, 1, 2], 2),
                                        ([3, 3, 3, 3], 1), ([0, 1, 2, 3, 0], 5)])
def test_top1_dispatch_matches_jax(expert, cap):
    slot, keep = jmoe.top1_dispatch(jnp.asarray(expert, jnp.int32), 4, cap)
    got_slot, got_keep = tmoe.top1_dispatch(torch.tensor(expert), 4, cap)
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(keep))


@pytest.mark.parametrize("t,e,cf,want", [(48, 4, 1.25, 15), (5, 4, 1.0, 2), (3, 8, 0.1, 1),
                                         (10, 2, 4.0, 10)])
def test_capacity_is_jax_s(t, e, cf, want):
    assert tmoe.capacity(t, e, cf) == want


@pytest.mark.parametrize("impl,cf,ties", [("dense", None, False), ("dense", None, True),
                                          ("routed", 1.25, False), ("routed", 0.5, False),
                                          ("routed", 1.0, True), ("routed", float(E), False),
                                          ("routed", float(E), True)])
def test_moe_op_matches_jax(impl, cf, ties):
    ins = _op_inputs(1, ties)
    jout, jgrads, tout, tgrads = _both(impl, cf, ins)
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    for name, g, want in zip(("x", "gate_w", "gate_b", "w1", "w2"), tgrads, jgrads):
        np.testing.assert_allclose(g, want, rtol=G_RTOL, atol=G_ATOL, err_msg=name)
    if impl == "routed":
        # The tokens past their expert's capacity come back as zeros, with
        # zero grads; at cf 0.5, and with every token on expert 0, some do.
        dropped = ~np.asarray(jmoe.top1_dispatch(
            jnp.argmax(jnp.asarray(ins[0] @ ins[1] + ins[2]), -1), E,
            tmoe.capacity(T, E, cf))[1])
        assert dropped.any() == (cf <= 1.0)  # seed 1 fits within cf 1.25
        assert not tout[dropped].any() and not tgrads[0][dropped].any()


@pytest.mark.parametrize("ties", [False, True])
def test_routed_equals_dense_where_the_capacity_holds_the_worst_load(ties):
    *args, _ = _op_inputs(2, ties)
    targs = [torch.from_numpy(a) for a in args]
    dense = tmoe.dense_top1_mlp(*targs, tgelu)
    # cf = E gives every expert room for all T tokens.
    routed = tmoe.top1_routed_mlp(*targs, tgelu, capacity_factor=float(E))
    torch.testing.assert_close(routed, dense, rtol=RTOL, atol=ATOL)
    if ties:  # every token goes to expert 0, the first of the tied pair
        experts = (targs[0] @ targs[1] + targs[2]).argmax(-1)
        assert (experts == 0).all()


@pytest.mark.parametrize("impl,cf", [("dense", None), ("routed", 1.25), ("routed", float(E))])
def test_moe_op_bf16_rounding_points_match_jax(impl, cf):
    """In bf16 the port rounds where the JAX op does: the gate logits (so
    both route every token alike), each product's output (fp32
    accumulation, one rounding) and the GELU. Against JAX's bf16 op the port
    is held to two bf16 units of the largest output (2^-7 each), and more of
    its outputs equal JAX's bit for bit than those of the fp32 op rounded
    once at the end."""
    *args, _ = _op_inputs(3)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jout = np.asarray(_jax_op(impl, cf)(*jargs), np.float32)
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    tout = _torch_op(impl, cf)(*targs)
    assert tout.dtype == torch.bfloat16
    tout = tout.float().numpy()
    f32 = _torch_op(impl, cf)(*(t.float() for t in targs)).to(torch.bfloat16).float().numpy()
    want_experts = np.asarray(jnp.argmax(jargs[0] @ jargs[1] + jargs[2], -1))
    got_experts = (targs[0] @ targs[1] + targs[2]).argmax(-1).numpy()
    np.testing.assert_array_equal(got_experts, want_experts)
    assert np.abs(tout - jout).max() <= 2 ** -6 * np.abs(jout).max()
    assert (tout == jout).mean() > (f32 == jout).mean()


SMALL = dict(dim=32, depth=2, heads=4, n_classes=10, n_views=3, n_kernels=2, drop_path=0.0,
             patch=8, img_size=32, use_moe=True, moe_experts=3)


def _moe_vit(impl, **over):
    kw = {**SMALL, "moe_impl": impl, **over}
    jm = J.ViT_MoP(**kw)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(5), jnp.zeros((1, 3, 32, 32))))
    return jm, params, load_jax_params(P.ViT_MoP(**kw, device="cpu"), params)


@pytest.mark.parametrize("impl", ["dense", "routed"])
def test_moe_vit_logits_and_grads_match_jax(impl):
    jm, params, pm = _moe_vit(impl)
    rs = np.random.RandomState(4)
    x = rs.randn(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, 4)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), y]), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    pm.eval()
    logits = pm(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    want = jax_state_dict(jax.device_get(jg))
    got = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    assert not [k for k, g in got.items() if g is None]  # the gates get zero grads
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=G_RTOL, atol=G_ATOL, err_msg=k)
    assert not got["enc.blocks.0.mlp.gate_kernel"].any()


def test_moe_vit_reference_case_builds_on_the_port():
    """``tests/test_mop_moe.py``'s model (3 experts, 64 wide) on the port."""
    kw = dict(dim=64, depth=2, heads=4, n_classes=10, n_views=3, n_kernels=2, use_moe=True,
              moe_experts=3)
    jm = J.ViT_MoP(**kw)
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 3, 32, 32)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    pm = load_jax_params(P.ViT_MoP(**kw, device="cpu"), jax.device_get(params)).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_moe_weights_round_trip_through_both_carriers():
    """The JAX tree into the port (``load_jax_params`` raises on any missing,
    extra or misshapen leaf) and the port's state dict back through the JAX
    package's ``port_torch_state_dict``: the tree comes back equal."""
    _, params, pm = _moe_vit("routed")
    mlp = dict(pm.named_parameters())
    assert tuple(mlp["enc.blocks.1.mlp.fc1"].shape) == (3, 32, 128)
    assert tuple(mlp["enc.blocks.1.mlp.fc2"].shape) == (3, 128, 32)
    assert tuple(mlp["enc.blocks.1.mlp.gate_kernel"].shape) == (3, 32)
    back = port_torch_state_dict({k: v.numpy() for k, v in pm.state_dict().items()},
                                 jax.eval_shape(lambda: params))
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), leaf)


def test_moe_mlp_rejects_one_expert_and_an_unknown_impl():
    with pytest.raises(ValueError):
        P.models.components.MoEMLP(8, num_experts=1)
    with pytest.raises(ValueError):
        P.models.components.MoEMLP(8, impl="sparse")


def test_moe_init_bounds_follow_the_jax_fan_in():
    m = P.models.components.MoEMLP(16, 2.0, num_experts=4)
    P.models.layers.init_params(m, torch.Generator().manual_seed(0))
    for w, fan_in in ((m.fc1, 4 * 16), (m.fc2, 4 * 32), (m.gate_kernel, 16),
                      (m.gate_bias, 16)):
        bound = fan_in ** -0.5
        assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound


def test_no_parameter_is_left_without_a_grad_in_a_train_step():
    for impl in ("dense", "routed"):
        pm = P.ViT_MoP(**{**SMALL, "drop_path": 0.1}, moe_impl=impl, device="cpu",
                       generator=torch.Generator().manual_seed(0))
        step = P.make_classifier_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0),
                                            (0.5,) * 3, (0.25,) * 3, device="cpu")
        x = torch.randint(0, 256, (4, 3, 32, 32), dtype=torch.uint8)
        m = step(x, torch.randint(0, 10, (4,)), torch.Generator().manual_seed(1))
        assert np.isfinite(float(m["loss"]))
        assert all(p.grad is not None for p in pm.parameters())
