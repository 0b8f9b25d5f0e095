"""K1: the port's ``flash_attention`` (its plain version, which a CPU tensor
runs) against the JAX Pallas kernel run in TPU interpret mode."""

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


ATOL = 2e-5


@pytest.mark.parametrize("b,h,n,n_kv,dk,causal", [
    (2, 3, 16, 16, 8, False),
    (2, 3, 16, 16, 8, True),
    (1, 2, 24, 40, 12, False),  # ragged KV: the kernel masks the padded keys
    (1, 2, 40, 40, 7, True),    # N not a multiple of the block
])
def test_flash_matches_jax_kernel(b, h, n, n_kv, dk, causal):
    rng = np.random.default_rng(n * 100 + dk)
    q = rng.standard_normal((b, h, n, dk)).astype(np.float32)
    k = rng.standard_normal((b, h, n_kv, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, n_kv, dk)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, force=True)
    before = TF.flash_attention.launches
    got = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert TF.flash_attention.launches == before  # a CPU tensor launches no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_three_dim_input_matches_four_dim():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 16, 8)).astype(np.float32))
               for _ in range(3))
    got = TF.flash_attention(q, k, v, causal=True)
    want = TF.flash_attention(q[None], k[None], v[None], causal=True)[0]
    assert got.shape == (6, 16, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
