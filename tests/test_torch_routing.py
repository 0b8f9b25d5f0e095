"""The routing rule of the port's attention modules: each calls its fused op
only where ``ops.fused`` says the op's kernels take the shape, from the shape
alone and the same on the CPU as on the card, and composes otherwise, as the
JAX modules do outside their kernels' envelopes.

Above their kernels' N ``EdgewiseMSA`` (lowrank head above 256, dense head
above 64), ``MultiHopMSA`` and ``DualPathMSA`` (above 64) compose in eval and
in training and match the JAX modules (which compose off the TPU); a spy
shows the fused op is not called (x of 257 or 81 tokens). At N = 64 the same
spy shows it is. ``MSA`` composes above K1's head width (dk > 128) and
matches the JAX ``MSA``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
import mop_tpu_torch.ops.fused as TF
from mop_tpu_torch.models.components import MSA
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 2e-5  # forward (tests/test_golden_numerics.py)
GATES = dict(base=0.9, and_=1.0, or_=0.5, not_=0.25, chain=0.75)

# name -> (JAX class, port class, kwargs, the fused op the module calls)
MODULES = {
    "E_lowrank": (J.EdgewiseMSA, PM.EdgewiseMSA,
                  dict(n_views=3, gate_mode="lowrank", gate_rank=2, gate_init="mix5"),
                  "fused_edgewise_lowrank_attention"),
    "E_dense": (J.EdgewiseMSA, PM.EdgewiseMSA, dict(n_views=3, gate_mode="dense",
                                                    gate_init="and"),
                "fused_edgewise_dense_attention"),
    "D": (J.MultiHopMSA, PM.MultiHopMSA, dict(beta_not=0.5, gates=GATES, hops=3),
          "fused_multihop_attention"),
    "dualpath": (J.DualPathMSA, PM.DualPathMSA, dict(beta_not=0.6, gates=GATES),
                 "fused_multihop_attention"),
}


@functools.lru_cache(maxsize=None)
def _pair(name, n, seed=3):
    """The JAX module, its params, the port module with those params, and x
    (one of each per configuration; the tests only set the mode)."""
    jcls, pcls, kw, _ = MODULES[name]
    x = np.random.default_rng(seed).standard_normal((2, n, 32)).astype(np.float32)
    jm = jcls(dim=32, heads=4, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    p = params["params"]
    if "chain_value_logit" in p:  # off its init, so that loading it is tested
        p["chain_value_logit"] = np.float32(0.3)
    return jm, params, load_jax_params(pcls(dim=32, heads=4, **kw), params), x


def _spy(monkeypatch, op_name):
    """Count the calls of the fused op ``op_name`` that the modules make."""
    calls = []
    orig = getattr(TF, op_name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(TF, op_name, spy)
    return calls


@functools.lru_cache(maxsize=None)
def _jax_out(name, n):
    """The JAX module's output (it composes on the CPU, and draws no dropout
    here, so eval and training give one output)."""
    jm, params, _, x = _pair(name, n)
    return np.asarray(jm.apply(params, jnp.asarray(x)))


def _run(name, n, train, monkeypatch):
    """The module's output against the JAX module's, and how often the
    module called its fused op."""
    _, _, tm, x = _pair(name, n)
    calls = _spy(monkeypatch, MODULES[name][3])
    with torch.no_grad():
        y = tm.train(train)(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), _jax_out(name, n), rtol=RTOL, atol=ATOL)
    return len(calls)


# The least N above each module's fused op's envelope: the lowrank op's
# kernels take N <= 256 (K2w / K2bw above K2's 64), K3's and K4's N <= 64.
ABOVE = {"E_lowrank": 257, "E_dense": 81, "D": 81, "dualpath": 81}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_composes_above_the_kernels_shapes(name, train, monkeypatch):
    """Above the fused op's N (257 for the lowrank head, 81 for the others):
    the module composes, in eval and in training, and matches the JAX
    module."""
    assert _run(name, ABOVE[name], train, monkeypatch) == 0


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_fuses_at_n64(name, train, monkeypatch):
    """At N = 64 the fused op still runs: the edgewise ops in eval and in
    training, K4 in eval (D and the two-hop path train composed, as in JAX)."""
    fused_in_training = name.startswith("E_")
    assert _run(name, 64, train, monkeypatch) == (1 if fused_in_training or not train else 0)


def test_predicates_follow_the_kernels_envelopes():
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        assert TF.edgewise_lowrank_fits(dtype, 5, 64, 56, 4)
        assert TF.edgewise_lowrank_fits(dtype, 5, 65, 56, 4)  # K2w / K2bw
        assert not TF.edgewise_lowrank_fits(dtype, 5, 257, 56, 4)
        assert not TF.edgewise_lowrank_fits(dtype, 9, 64, 56, 4)  # K2b takes V <= 8
        assert TF.edgewise_dense_fits(dtype, 5, 64, 56)
        assert not TF.edgewise_dense_fits(dtype, 5, 196, 56)
        assert not TF.edgewise_dense_fits(dtype, 5, 64, 129)
    # K2's fp32 maps take more shared memory than its bf16 ones.
    assert TF.edgewise_lowrank_fits(bf16, 8, 64, 128, 4)
    assert not TF.edgewise_lowrank_fits(f32, 8, 64, 128, 4)
    assert TF.multihop_fits(64, 64, 3) and not TF.multihop_fits(196, 64, 3)
    assert not TF.multihop_fits(64, 129, 3) and not TF.multihop_fits(64, 64, 1)
    assert TF.flash_fits(128) and not TF.flash_fits(129)
    assert TF.quartet_fits(128) and not TF.quartet_fits(136)


@pytest.mark.parametrize("dim,heads,fused", [(144, 1, False), (64, 2, True)])
def test_msa_composes_above_k1_head_width(dim, heads, fused, monkeypatch):
    """``MSA`` at dk = 144 composes its scores, softmax and value product
    (K1 takes dk <= 128) and matches the JAX ``MSA``; at dk = 32 it calls K1."""
    x = np.random.default_rng(5).standard_normal((2, 16, dim)).astype(np.float32)
    jm = J.MSA(dim=dim, heads=heads)
    params = jax.device_get(jm.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    tm = load_jax_params(MSA(dim, heads), params)
    calls = _spy(monkeypatch, "flash_attention")
    with torch.no_grad():
        y = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jm.apply(params, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    assert len(calls) == (1 if fused else 0)
