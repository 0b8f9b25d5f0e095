"""Composed parallelism on the port, over gloo on the CPU (one 8-process
group for the file, ``make_mesh3``'s (data 2, model 2, stage 2) mesh, JAX's):
the dp x tp x pp GPipe step for the base, Quartet and MoP families against
JAX's one-device step (``tests/test_parallel_composed.py``'s tolerances),
with the stage split and the tensor split of a ``q_proj`` weight; and the
ring over 'stage' inside a tensor-parallel attention block (heads over
'model', batch over 'data') against the dense composition (forward rtol
2e-4 / atol 2e-5, gradients rtol 1e-3 / atol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_pp_common as C
from tests._torch_parallel_common import assert_params_close, run_ranks

RING = dict(B=2, N=32, D=64, H=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return C.jax_setup()


def _ring_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((RING["B"], RING["N"], RING["D"])).astype(np.float32)
    ws = [(rng.standard_normal((RING["D"], RING["D"])) * 0.1).astype(np.float32)
          for _ in range(4)]
    return x, ws


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    idx, tgt = C.batch()
    x, ws = _ring_inputs()
    inputs = dict(pp_cfg=C.CFG, pp_kw=C.KW, pp_sd={f: v[2] for f, v in setup.items()},
                  idx=torch.from_numpy(idx), tgt=torch.from_numpy(tgt),
                  ring_x=torch.from_numpy(x), ring_w=[torch.from_numpy(w) for w in ws])
    return run_ranks("composed", inputs, tmp_path_factory.mktemp("composed"), nproc=8)


@pytest.mark.parametrize("family", C.FAMILIES)
def test_dp_tp_pp_composed_step_matches_jax(setup, ranks, family):
    idx, tgt = C.batch()
    model, params, _ = setup[family]
    want_loss, after = C.jax_ref_step(model, params, idx, tgt)
    want = C.port_model(family, after).state_dict()
    for r in ranks:
        assert r["mesh"] == {"data": 2, "model": 2, "stage": 2}
        loss, got, shapes = r[("composed", family)]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert_params_close(got, want, 2e-3, 5e-4)
        # (layers, out, in): the stage split and the column split of q_proj.
        assert shapes["attn.q_proj.weight"] == (2, 32, 64)
        assert shapes["attn.o_proj.weight"] == (2, 64, 32)
        assert shapes["ln1.weight"] == (2, 64)


def _dense(x, ws):
    """The single-device composition and its weight grads, in JAX."""
    b, n, d = x.shape
    h, dk = RING["H"], d // RING["H"]

    def attn(wq, wk, wv, wo):
        split = lambda y: y.reshape(b, n, h, dk).transpose(0, 2, 1, 3)  # noqa: E731
        q, k, v = split(x @ wq), split(x @ wk), split(x @ wv)
        s = jnp.einsum("bhnd,bhmd->bhnm", q, k) / np.sqrt(dk)
        s = jnp.where(jnp.tril(jnp.ones((n, n), bool)), s, -jnp.inf)
        o = jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(s, -1), v)
        return o.transpose(0, 2, 1, 3).reshape(b, n, d) @ wo

    def loss(*w):
        y = attn(*w)
        return jnp.sum(y * jnp.cos(y))

    return np.asarray(attn(*ws)), [np.asarray(g) for g in
                                   jax.grad(loss, argnums=(0, 1, 2, 3))(*ws)]


def test_ring_attention_inside_tp_block(ranks):
    x, ws = _ring_inputs()
    want_y, want_g = _dense(jnp.asarray(x), [jnp.asarray(w) for w in ws])
    got_y = np.zeros_like(want_y)
    got_g = [np.zeros_like(g) for g in want_g]
    nl, w = RING["N"] // 2, RING["D"] // 2
    for r in ranks:
        (d, mi, st), y, grads = r["ring"]
        got_y[d:d + 1, st * nl:(st + 1) * nl] = y.numpy()
        for i in range(3):  # q, k, v: this process's columns
            got_g[i][:, mi * w:(mi + 1) * w] = grads[i].numpy()
        got_g[3][mi * w:(mi + 1) * w] = grads[3].numpy()  # the output's rows
    np.testing.assert_allclose(got_y, want_y, rtol=2e-4, atol=2e-5)
    for g, want in zip(got_g, want_g):
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-4)
