"""K2b: the port's K2 autograd Function, driven on the CPU by the plain
backward, against ``jax.grad`` of the JAX kernel (its in-kernel VJP, K2b) in
TPU interpret mode; and the port's ``EdgewiseMSA`` gradients against the JAX
module's at ``train=True``."""

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
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 1e-4, 1e-3  # tests/test_ops.py's fused-backward tolerance
NAMES = ("qs", "ks", "vs", "wrow", "brow", "wcol", "bcol", "chain_w")


def _inputs(n, dk, v_, r, seed):
    rng = np.random.default_rng(seed)
    qs, ks, vs = (rng.standard_normal((2, 2, v_, n, dk)).astype(np.float32)
                  for _ in range(3))
    c = 2 * v_ + 2
    wrow = (rng.standard_normal((c, 4 * r)) * 0.3).astype(np.float32)
    wcol = (rng.standard_normal((c, 4 * r)) * 0.3).astype(np.float32)
    brow = np.linspace(-0.5, 0.5, 4 * r).astype(np.float32)
    bcol = np.linspace(0.5, -0.5, 4 * r).astype(np.float32)
    dy = rng.standard_normal((2, 2, n, dk)).astype(np.float32)
    return (qs, ks, vs, wrow, brow, wcol, bcol, np.float32(0.4)), dy


def _jax_grads(arrays, dy, beta_not):
    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            y = JF.fused_edgewise_lowrank_attention(*a[:7], beta_not=beta_not,
                                                    chain_w=a[7], force=True)
        return jnp.sum(y * dy)

    return jax.grad(loss, argnums=tuple(range(8)))(*[jnp.asarray(a) for a in arrays])


def _port_grads(arrays, dy, beta_not, dtype=torch.float32):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    y = TF.fused_edgewise_lowrank_attention(*ts[:7], beta_not=beta_not, chain_w=ts[7])
    return torch.autograd.grad(y, ts, torch.tensor(dy, dtype=dtype))


@pytest.mark.parametrize("n,dk,v_,r", [(16, 8, 3, 2), (16, 8, 5, 4), (16, 8, 2, 1)])
def test_edgewise_function_grads_match_jax_kernel(n, dk, v_, r):
    arrays, dy = _inputs(n, dk, v_, r, seed=n + dk + v_ + r)
    want = _jax_grads(arrays, dy, 0.7)
    counts = [f.launches for f in TF.KERNELS]
    got = _port_grads(arrays, dy, 0.7)
    assert [f.launches for f in TF.KERNELS] == counts  # CPU tensors launch no kernel
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_bwd_plain_per_program_layout_sums_to_the_grads():
    """The plain backward returns the kernel's layout: dq/dk/dv as
    (B, H, V, N, dk) and per-program weight grads, which sum to the
    Function's weight grads."""
    arrays, dy = _inputs(16, 8, 3, 2, seed=11)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays]
    out = TF.fused_edgewise_lowrank_attention_bwd(*ts[:7], 0.7, ts[7], torch.from_numpy(dy))
    dq, dk, dv, dwr, dbr, dwc, dbc, dch = out
    assert dq.shape == dk.shape == dv.shape == (2, 2, 3, 16, 8)
    assert dq.is_contiguous() and dv.is_contiguous()
    assert dwr.shape == dwc.shape == (4, 8, 8) and dbr.shape == dbc.shape == (4, 1, 8)
    assert dch.shape == (4,) and dwr.dtype == torch.float32
    # Only v_0 and v_{V-1} receive a value gradient.
    assert torch.count_nonzero(dv[:, :, 1]) == 0
    grads = _port_grads(arrays, dy, 0.7)
    sums = (dq, dk, dv, dwr.sum(0), dbr.sum((0, 1)), dwc.sum(0), dbc.sum((0, 1)), dch.sum())
    for name, s, g in zip(NAMES, sums, grads):
        torch.testing.assert_close(s, g, rtol=1e-5, atol=1e-6, msg=name)


def test_grads_come_back_in_each_inputs_dtype():
    arrays, dy = _inputs(16, 8, 3, 2, seed=12)
    grads = _port_grads(arrays, dy, 0.5, dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    want = _port_grads(arrays, dy, 0.5)
    for name, g, w in zip(NAMES, grads, want):
        # bf16 rounds the operands of every product; hold each grad to 5% of
        # its largest magnitude.
        err = (g.float() - w).abs().max().item()
        assert err <= 5e-2 * w.abs().max().item(), (name, err)


def test_cuda_backward_rejects_shapes_outside_the_kernel():
    arrays, dy = _inputs(16, 8, 3, 2, seed=13)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays]
    with pytest.raises(ValueError, match="gate-head shapes"):
        TF._edgewise_shapes("k", *ts[:3], ts[3][:, :7], *ts[4:7], 8, lambda *a: 0)
    many = torch.zeros(1, 1, 9, 16, 8)
    w = torch.zeros(20, 8)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        TF._edgewise_shapes("k", many, many, many, w, w[0], w, w[0], 8, lambda *a: 0)


@pytest.mark.parametrize("share_qkv,n_views,rank,gate_init", [
    (False, 5, 4, "mix5"),
    (True, 3, 2, "and"),
])
def test_edgewise_msa_grads_match_jax(share_qkv, n_views, rank, gate_init):
    kw = dict(dim=32, heads=4, n_views=n_views, share_qkv=share_qkv,
              gate_mode="lowrank", gate_rank=rank, gate_init=gate_init)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 16, 32)).astype(np.float32)
    jm = JEdgewiseMSA(**kw)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))

    def loss(p, xx):
        y = jm.apply(p, xx, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * dy)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    want = jax_state_dict(jax.device_get(gp))

    tm = load_jax_params(EdgewiseMSA(**kw), jax.device_get(params)).train()
    xt = torch.from_numpy(x).requires_grad_()
    (tm(xt) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL, rtol=RTOL)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=ATOL, rtol=RTOL, err_msg=k)
