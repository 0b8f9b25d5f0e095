"""Ring attention and the expert-parallel MoE on the port, over gloo on the CPU
(one 4-process group for the file). The ring at 2 and 4 processes, causal and
not, against full attention in the forward and in all three grads
(``tests/test_ring_attention.py``'s tolerances) and against
``mop_tpu.ops.ring_attention`` on the same inputs; the expert-parallel op
against ``dense_top1_mlp`` (values and grads) with a capacity that drops
nothing, and against JAX's ``expert_parallel_top1_mlp``, zeros included, at
one that drops; the collectives of each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.ops.moe import expert_parallel_top1_mlp as jax_ep
from mop_tpu.ops.ring_attention import ring_attention as jax_ring
from mop_tpu.parallel import make_mesh as jax_make_mesh
from mop_tpu_torch.models.layers import gelu_tanh
from mop_tpu_torch.ops import moe as ops_moe
from tests._torch_parallel_common import run_ranks

B, H, N, DK = 2, 3, 64, 16
E, D, HID, T = 8, 32, 64, 128
AMPLE, DROPPING = 8.0, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(B, H, N, DK).astype(np.float32) for _ in range(3))
    w = np.sin(np.arange(DK, dtype=np.float32))
    moe = dict(moe_x=rs.randn(T, D), moe_gw=rs.randn(D, E) * 0.5, moe_gb=rs.randn(E) * 0.1,
               moe_w1=rs.randn(E, D, HID) * 0.2, moe_w2=rs.randn(E, HID, D) * 0.2,
               moe_w=rs.randn(T, D))
    moe = {k_: torch.tensor(a, dtype=torch.float32) for k_, a in moe.items()}
    inputs = dict(q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
                  w=torch.from_numpy(w), capacity_factors=(AMPLE, DROPPING), **moe)
    jx = {}
    for s in (2, 4):
        mesh = jax_make_mesh(n_devices=8, model_parallel=s)
        for causal in (False, True):
            jx[("ring", s, causal)] = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k),
                                                          jnp.asarray(v), mesh, causal=causal))
        jx[("moe", s)] = np.asarray(jax_ep(
            *(jnp.asarray(moe[n].numpy()) for n in ("moe_x", "moe_gw", "moe_gb", "moe_w1",
                                                     "moe_w2")),
            act=jax.nn.gelu, mesh=mesh, capacity_factor=DROPPING))
    return inputs, jx


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks("ring_moe", case[0], tmp_path_factory.mktemp("ring_moe"))


def _full_attention(q, k, v, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / DK ** 0.5
    if causal:
        s = s.masked_fill(~torch.tril(torch.ones(N, N, dtype=torch.bool)), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [2, 4])
def test_ring_matches_full_attention(case, ranks, s, causal):
    inputs, jx = case
    q, k, v = (inputs[n].clone().requires_grad_() for n in "qkv")
    ref = _full_attention(q, k, v, causal)
    (ref * inputs["w"]).sum().backward()
    for r in ranks:
        out, dq, dk, dv = r[("ring", s, causal)]
        np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=2e-5, atol=2e-6)
        for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-5, atol=5e-6)
    # ... and the JAX package's ring on the same inputs.
    np.testing.assert_allclose(ranks[0][("ring", s, causal)][0].numpy(), jx[("ring", s, causal)],
                               rtol=2e-5, atol=2e-6)


def test_ring_collectives_and_raise(ranks):
    """S - 1 hops of K and V each forward (one permute per block sent, of one
    block's bytes); backward S - 1 hops of K, V, dK and dV and one more of
    dK and dV; nothing gathered. A sequence that does not divide raises."""
    block = ranks[0]["ring_block_bytes"]
    fwd, bwd = ranks[0]["ring_fwd_collectives"], ranks[0]["ring_bwd_collectives"]
    assert fwd == {"collective-permute": {"count": 2 * 3, "bytes": 2 * 3 * block}}, fwd
    assert set(bwd) == {"collective-permute"} and bwd["collective-permute"]["count"] == 4 * 3 + 2
    assert "must divide" in ranks[0]["ring_raise"]


@pytest.mark.parametrize("s", [2, 4])
def test_expert_parallel_equals_dense(case, ranks, s):
    inputs, _ = case
    x, w1, w2 = (inputs[n].clone().requires_grad_() for n in ("moe_x", "moe_w1", "moe_w2"))
    ref = ops_moe.dense_top1_mlp(x, inputs["moe_gw"], inputs["moe_gb"], w1, w2, gelu_tanh)
    (ref * inputs["moe_w"]).sum().backward()
    ys, dxs = zip(*((r[("moe", s, AMPLE)][0], r[("moe", s, AMPLE)][1]) for r in ranks[:s]))
    np.testing.assert_allclose(torch.cat(ys).numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat(dxs).numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-5)
    e_loc = E // s
    for i, r in enumerate(ranks[:s]):
        np.testing.assert_allclose(r[("moe", s, AMPLE)][2].numpy(),
                                   w1.grad[i * e_loc:(i + 1) * e_loc].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[("moe", s, AMPLE)][3].numpy(),
                                   w2.grad[i * e_loc:(i + 1) * e_loc].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [2, 4])
def test_expert_parallel_equals_jax_when_dropping(case, ranks, s):
    """At capacity factor 0.5 tokens overflow their expert's per-source
    slots: the outputs, and which rows are zero, are JAX's."""
    _, jx = case
    got = torch.cat([r[("moe", s, DROPPING)][0] for r in ranks[:s]]).numpy()
    want = jx[("moe", s)]
    zero = ~want.any(-1)
    assert zero.sum() > 0 and np.array_equal(~got.any(-1), zero)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [2, 4])
def test_expert_parallel_collectives(ranks, s):
    """Dispatch and combine: exactly two all-to-alls, O(tokens x d_model)
    bytes, and nothing gathered."""
    summ = ranks[0][("moe", s, DROPPING)][4]
    assert set(summ) == {"all-to-all"} and summ["all-to-all"]["count"] == 2, summ
    assert summ["all-to-all"]["bytes"] <= 4 * (T // s) * D * 4, summ
