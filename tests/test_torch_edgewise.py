"""K2: the port's ``fused_edgewise_lowrank_attention`` (its plain version,
which a CPU tensor runs) against the JAX Pallas kernel in TPU interpret mode,
and the port's ``EdgewiseMSA`` against the JAX module."""

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 2e-5


def _inputs(n, dk, v_, r, seed):
    rng = np.random.default_rng(seed)
    qs, ks, vs = (rng.standard_normal((2, 2, v_, n, dk)).astype(np.float32)
                  for _ in range(3))
    c = 2 * v_ + 2
    wrow = (rng.standard_normal((c, 4 * r)) * 0.3).astype(np.float32)
    wcol = (rng.standard_normal((c, 4 * r)) * 0.3).astype(np.float32)
    brow = np.linspace(-0.5, 0.5, 4 * r).astype(np.float32)
    bcol = np.linspace(0.5, -0.5, 4 * r).astype(np.float32)
    return qs, ks, vs, wrow, brow, wcol, bcol


@pytest.mark.parametrize("n,dk,v_,r", [(16, 8, 3, 2), (16, 8, 5, 4), (16, 8, 1, 2)])
def test_edgewise_lowrank_matches_jax_kernel(n, dk, v_, r):
    arrays = _inputs(n, dk, v_, r, seed=n + dk + v_ + r)
    beta_not, chain_w = 0.7, 0.4
    with pltpu.force_tpu_interpret_mode():
        want = JF.fused_edgewise_lowrank_attention(
            *[jnp.asarray(a) for a in arrays], beta_not=beta_not,
            chain_w=jnp.asarray(chain_w), force=True)
    before = TF.fused_edgewise_lowrank_attention.launches
    got = TF.fused_edgewise_lowrank_attention(
        *[torch.from_numpy(a) for a in arrays], beta_not=beta_not,
        chain_w=torch.tensor(chain_w))
    assert TF.fused_edgewise_lowrank_attention.launches == before
    assert got.shape == (2, 2, n, dk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_edgewise_strided_views_match_contiguous():
    """The kernel reads (B, H, V, N, dk) views with any strides; the op's
    result may not depend on the layout of its inputs."""
    arrays = [torch.from_numpy(a) for a in _inputs(16, 8, 3, 2, seed=5)]
    qs, ks, vs = arrays[:3]
    strided = [t.permute(0, 3, 2, 1, 4).contiguous().permute(0, 3, 2, 1, 4)
               for t in (qs, ks, vs)]
    assert not strided[0].is_contiguous()
    want = TF.fused_edgewise_lowrank_attention(*arrays, beta_not=0.5, chain_w=0.3)
    got = TF.fused_edgewise_lowrank_attention(*strided, *arrays[3:], beta_not=0.5,
                                              chain_w=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("share_qkv,n_views,rank,gate_init", [
    (False, 5, 4, "mix5"),
    (True, 3, 2, "and"),
])
def test_edgewise_msa_matches_jax(share_qkv, n_views, rank, gate_init):
    kw = dict(dim=32, heads=4, n_views=n_views, share_qkv=share_qkv,
              gate_mode="lowrank", gate_rank=rank, gate_init=gate_init)
    x = np.random.default_rng(9).standard_normal((2, 16, 32)).astype(np.float32)
    jm = JEdgewiseMSA(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    if share_qkv:  # move the per-view scales off their all-ones init
        scales = np.random.default_rng(4).uniform(0.5, 1.5, (3, n_views, 4, 1, 8))
        for name, s in zip(("q_scale", "k_scale", "v_scale"), scales):
            params["params"][name] = jnp.asarray(s, jnp.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = load_jax_params(EdgewiseMSA(**kw), jax.device_get(params)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
