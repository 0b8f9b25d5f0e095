"""Attention dropout and masks in the port's MSA modules, where the JAX
modules compose: ``MSA`` / ``BaselineMSA`` and ``EdgewiseMSA`` with
``attn_drop > 0`` in eval mode against the JAX modules (and equal to rate 0:
no dropout is applied), in train mode against the composed path with the
mask drawn by hand from the same generator and scaled by 1 / (1 - p); and
``UnifiedMSA("E")`` under a mask against the JAX module, output and grads."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.models.components import MSA as JaxMSA
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
M_ATOL, M_RTOL = 1e-4, 1e-3
P_DROP = 0.3
# name -> (JAX module, port module, kwargs)
MODULES = {
    "MSA": (JaxMSA, PM.MSA, dict()),
    "BaselineMSA": (J.BaselineMSA, PM.BaselineMSA, dict()),
    "E_lowrank": (J.EdgewiseMSA, PM.EdgewiseMSA,
                  dict(n_views=3, gate_mode="lowrank", gate_rank=2, gate_init="mix5")),
    "E_dense": (J.EdgewiseMSA, PM.EdgewiseMSA, dict(n_views=3, gate_mode="dense",
                                                      gate_init="and")),
}


def _pair(name, seed=0):
    jcls, pcls, kw = MODULES[name]
    x = np.random.default_rng(seed).standard_normal((2, 16, 32)).astype(np.float32)
    jm = jcls(dim=32, heads=4, attn_drop=P_DROP, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return jm, params, load_jax_params(pcls(32, 4, attn_drop=P_DROP, **kw), params), x


class _HandDrop(nn.Module):
    """The dropout of the JAX module's composed path, written out: keep an
    entry where a uniform draw from ``generator`` is below 1 - p, scaled by
    1 / (1 - p). ``p`` is the module's rate, which its route reads."""

    def __init__(self, p, generator):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, a):
        keep = 1.0 - self.p
        mask = torch.rand(a.shape, generator=self.generator) < keep
        return torch.where(mask, a / keep, torch.zeros_like(a))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_attn_drop_eval_matches_jax_and_drops_nothing(name):
    jm, params, tm, x = _pair(name)
    want = np.asarray(jm.apply(params, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        tm.attn_drop.p = 0.0
        torch.testing.assert_close(tm(torch.from_numpy(x)), got, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_attn_drop_train_is_the_composed_path_with_the_generators_mask(name):
    """Train mode composes and drops after the final softmax: the same
    output as the module with its attention dropout replaced by the hand
    mask drawn from a generator of the same seed; the same seed gives the
    same output, another seed another, and eval mode differs."""
    _, _, tm, x = _pair(name, seed=1)
    xt = torch.from_numpy(x)
    ref = copy.deepcopy(tm)
    ref.attn_drop = _HandDrop(P_DROP, torch.Generator().manual_seed(7))
    tm.train()
    PM.set_generator(tm, torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = tm(xt)
        torch.testing.assert_close(got, ref.train()(xt), rtol=0, atol=0)
        PM.set_generator(tm, torch.Generator().manual_seed(7))
        torch.testing.assert_close(tm(xt), got, rtol=0, atol=0)
        PM.set_generator(tm, torch.Generator().manual_seed(8))
        assert not torch.allclose(tm(xt), got)
        assert not torch.allclose(tm.eval()(xt), got)


def _block_mask(n=16, split=10):
    """Two packed segments that attend within themselves: a symmetric mask,
    under which every unmasked entry of the dense head's features stays finite."""
    m = np.zeros((1, 1, n, n), np.float32)
    m[..., :split, :split] = 1.0
    m[..., split:, split:] = 1.0
    return m


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unified_e_under_a_mask_matches_jax(train):
    """UnifiedMSA("E") with a mask composes and masks every score map and the
    mixed logits, as JAX: output, input grads and every parameter's grad."""
    kw = dict(mode="E", dim=32, heads=4, n_views=3, gate_mode="dense", gate_init="and")
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    mask = _block_mask()
    jm = J.UnifiedMSA(**kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))

    def loss(p, xx):
        y = jm.apply(p, xx, attn_mask=jnp.asarray(mask), train=train,
                     rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * dy), y

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm = load_jax_params(PM.UnifiedMSA(**kw), params).train(train)
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt, torch.from_numpy(mask))
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=M_ATOL, rtol=M_RTOL)
    want_g = jax_state_dict(jax.device_get(gp))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k], atol=M_ATOL, rtol=M_RTOL,
                                   err_msg=k)
