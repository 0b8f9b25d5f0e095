"""K1's autograd: the port's ``flash_attention`` gradients (forward, then the
plain recompute backward) against ``jax.grad`` of the JAX kernel, whose
``custom_vjp`` recomputes the scores through XLA (``_flash_bwd_rule``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mop_tpu.ops.fused as JF
import mop_tpu_torch.ops.fused as TF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("shape,n_kv,causal", [
    ((2, 3, 16, 8), 16, False),
    ((2, 3, 16, 8), 16, True),
    ((1, 2, 24, 12), 40, False),
])
def test_flash_grads_match_jax(shape, n_kv, causal):
    rng = np.random.default_rng(sum(shape) + n_kv)
    b, h, n, dk = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((b, h, n_kv, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, n_kv, dk)).astype(np.float32)
    do = rng.standard_normal(shape).astype(np.float32)

    def loss(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            o = JF.flash_attention(q, k, v, causal=causal, force=True)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(TF.flash_attention(*ts, causal=causal), ts, torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=name)


def test_flash_recompute_backward_keeps_dtypes_and_three_dim_inputs():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 16, 8)).astype(np.float32))
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    out = TF.flash_attention(q, k, v)
    assert out.shape == (6, 16, 8)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert all(g.dtype == torch.bfloat16 and g.shape == (6, 16, 8) for g in grads)


def test_flash_without_grad_skips_the_function():
    """Under no_grad the op returns the plain forward itself: no autograd
    node, nothing saved."""
    q = torch.randn(1, 2, 8, 4, requires_grad=True)
    with torch.no_grad():
        out = TF.flash_attention(q, q, q)
    assert out.grad_fn is None
    assert TF.flash_attention(q, q, q).grad_fn is not None
