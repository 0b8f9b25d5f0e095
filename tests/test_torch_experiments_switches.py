"""The kernel switches of ``mop_tpu_torch/config.py`` against ``mop_tpu/config.py``:
the four flags with the JAX names, environment variables and defaults; with
each flag off, the module's fused op is not called (it is replaced by one
that raises) and the output equals the JAX module's with the same flag off,
its composed path; with the flag on, the op is called."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.config as JCFG
import mop_tpu.models as J
import mop_tpu_torch.config as TCFG
import mop_tpu_torch.models as PM
import mop_tpu_torch.ops.fused as TF
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
FLAGS = ("fused_attention", "fused_multihop", "fused_quartet", "fused_edgewise_train")
LM_CFG = dict(n_layer=1, n_head=2, n_embd=32, dropout=0.0, block_size=16)

# case -> (JAX module, port module, the flag, the fused op, train mode)
CASES = {
    "MSA": (lambda: J.BaselineMSA(dim=32, heads=4), lambda: PM.BaselineMSA(32, 4),
            "fused_attention", "flash_attention", False),
    "E_lowrank": (lambda: J.EdgewiseMSA(dim=32, heads=4, n_views=3, gate_mode="lowrank",
                                        gate_rank=2, gate_init="mix5"),
                  lambda: PM.EdgewiseMSA(32, 4, n_views=3, gate_mode="lowrank", gate_rank=2,
                                         gate_init="mix5"),
                  "fused_attention", "fused_edgewise_lowrank_attention", False),
    "E_dense": (lambda: J.EdgewiseMSA(dim=32, heads=4, n_views=3, gate_mode="dense",
                                      gate_init="and"),
                lambda: PM.EdgewiseMSA(32, 4, n_views=3, gate_mode="dense", gate_init="and"),
                "fused_attention", "fused_edgewise_dense_attention", False),
    "E_lowrank_train": (lambda: J.EdgewiseMSA(dim=32, heads=4, n_views=3, gate_mode="lowrank",
                                              gate_rank=2, gate_init="mix5"),
                        lambda: PM.EdgewiseMSA(32, 4, n_views=3, gate_mode="lowrank",
                                               gate_rank=2, gate_init="mix5"),
                        "fused_edgewise_train", "fused_edgewise_lowrank_attention", True),
    "E_dense_train": (lambda: J.EdgewiseMSA(dim=32, heads=4, n_views=3, gate_mode="dense",
                                            gate_init="and"),
                      lambda: PM.EdgewiseMSA(32, 4, n_views=3, gate_mode="dense",
                                             gate_init="and"),
                      "fused_edgewise_train", "fused_edgewise_dense_attention", True),
    "D": (lambda: J.MultiHopMSA(dim=32, heads=4, beta_not=0.5, gates=GATES, hops=3),
          lambda: PM.MultiHopMSA(32, 4, beta_not=0.5, gates=GATES, hops=3),
          "fused_multihop", "fused_multihop_attention", False),
    "dualpath": (lambda: J.DualPathMSA(dim=32, heads=4, beta_not=0.6, gates=GATES),
                 lambda: PM.DualPathMSA(32, 4, beta_not=0.6, gates=GATES),
                 "fused_multihop", "fused_multihop_attention", False),
    "quartet": (lambda: J.CausalSelfAttention(J.TransformerConfig(**LM_CFG)),
                lambda: PM.CausalSelfAttention(PM.TransformerConfig(**LM_CFG)),
                "fused_quartet", "fused_quartet_attention", False),
}


@functools.lru_cache(maxsize=None)
def _pair(case):
    jctor, pctor, _, _, _ = CASES[case]
    n = 16 if case == "quartet" else 64  # inside every kernel's shapes
    x = np.random.default_rng(7).standard_normal((2, n, 32)).astype(np.float32)
    jm = jctor()
    params = jax.device_get(jm.init(jax.random.PRNGKey(7), jnp.asarray(x)))
    return jm, params, load_jax_params(pctor(), params), x


@functools.lru_cache(maxsize=None)
def _jax_composed(case):
    """The JAX module's output with the case's flag off: its composed path."""
    jm, params, _, x = _pair(case)
    cfg = JCFG.config
    flag, train = CASES[case][2], CASES[case][4]
    old = getattr(cfg, flag)
    setattr(cfg, flag, False)
    try:
        return np.asarray(jm.apply(params, jnp.asarray(x), train=train))
    finally:
        setattr(cfg, flag, old)


def _port(case, monkeypatch, flag_on):
    """The port module's output and whether its fused op was called."""
    _, _, pm, x = _pair(case)
    _, _, flag, op, train = CASES[case]
    calls = []
    orig = getattr(TF, op)

    def spy(*a, **k):
        if not flag_on:
            raise AssertionError(f"{op} called with {flag} off")
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(TF, op, spy)
    monkeypatch.setattr(TCFG.config, flag, flag_on)
    with torch.no_grad():
        y = pm.train(train)(torch.from_numpy(x))
    if isinstance(y, tuple):
        y = y[0]
    return y.numpy(), len(calls)


@pytest.mark.parametrize("case", CASES)
def test_flag_off_composes_as_jax(case, monkeypatch):
    y, n = _port(case, monkeypatch, flag_on=False)
    assert n == 0
    np.testing.assert_allclose(y, _jax_composed(case), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_flag_on_calls_the_fused_op(case, monkeypatch):
    y, n = _port(case, monkeypatch, flag_on=True)
    assert n == 1
    np.testing.assert_allclose(y, _jax_composed(case), rtol=RTOL, atol=ATOL)


def test_edgewise_train_flag_leaves_eval_fused(monkeypatch):
    """``fused_edgewise_train`` off composes training only; eval keeps K2."""
    monkeypatch.setattr(TCFG.config, "fused_edgewise_train", False)
    _, _, pm, x = _pair("E_lowrank")
    calls = []
    orig = TF.fused_edgewise_lowrank_attention
    monkeypatch.setattr(TF, "fused_edgewise_lowrank_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        pm.eval()(torch.from_numpy(x))
    assert calls == [1]


@pytest.mark.parametrize("value,on", [(None, True), ("0", False), ("false", False),
                                      ("off", False), ("1", True), ("Yes", True)])
def test_flags_read_the_jax_environment_names(monkeypatch, value, on):
    for flag in FLAGS:
        env = f"MOP_TPU_{flag.upper()}"
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
    assert [getattr(TCFG._Config(), f) for f in FLAGS] == [on] * 4
    assert [getattr(JCFG._Config(), f) for f in FLAGS] == [on] * 4
