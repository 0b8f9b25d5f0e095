"""The GPT family's two config options that no other port test builds:
``bias=True`` (every GPT linear with a bias) and ``use_abs_pos_emb=False``
(no position table). The Quartet LM, the baseline LM and GPT-MoP (Quartet
attention on) against the JAX models with transplanted weights, in eval
mode: logits and loss at rtol 2e-4 / atol 2e-5 and every grad.

``k_proj.bias``'s grad is zero in exact arithmetic (a per-row constant of
the scores, which the standardization removes), so it is held absolutely:
both packages' values must be rounding noise, under 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
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
M_ATOL, M_RTOL = 1e-4, 1e-3  # grads, as tests/test_torch_quartet.py
VOCAB = 50
CFG = dict(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=16)
# name -> (JAX builder, port builder) of a config dict. The Quartet and
# baseline factories rebuild the config without ``use_abs_pos_emb`` (in both
# packages), so those two LMs are built directly.
LMS = {
    "quartet": (lambda c: J.TinyTransformerLM(VOCAB, J.TransformerConfig(**c, use_quartet=True)),
                lambda c: PM.TinyTransformerLM(VOCAB, PM.TransformerConfig(**c, use_quartet=True),
                                               device="cpu")),
    "baseline": (lambda c: J.TinyTransformerLM(VOCAB, J.TransformerConfig(**c, use_quartet=False)),
                 lambda c: PM.TinyTransformerLM(
                     VOCAB, PM.TransformerConfig(**c, use_quartet=False), device="cpu")),
    "mop": (lambda c: J.create_gpt_mop(VOCAB, J.TransformerConfig(**c), n_views=3, n_kernels=2),
            lambda c: PM.create_gpt_mop(VOCAB, PM.TransformerConfig(**c), n_views=3, n_kernels=2,
                                        device="cpu")),
}
OPTIONS = {"bias": dict(bias=True), "no_abs_pos": dict(bias=False, use_abs_pos_emb=False)}


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("name", LMS)
def test_lm_option_matches_jax(name, option):
    jbuild, pbuild = LMS[name]
    cfg = {**CFG, **OPTIONS[option]}
    jm, pm = jbuild(cfg), pbuild(cfg)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    tgt = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(idx)))
    for blk in params["params"].values():  # move the raw scalars and biases off their init
        if isinstance(blk, dict):
            attn = blk.get("attn", {})
            if "mixture" in attn:
                attn["mixture"] = rng.uniform(-1.0, 1.0, (1,)).astype(np.float32)
            for lin in attn.values():
                if isinstance(lin, dict) and "bias" in lin:
                    lin["bias"] = rng.normal(0.0, 0.1, lin["bias"].shape).astype(np.float32)
    pm = load_jax_params(pm, params)
    names = dict(pm.named_parameters())
    assert any(k.endswith("k_proj.bias") for k in names) == OPTIONS[option]["bias"]
    assert ("wpe.weight" in names) == (option != "no_abs_pos")

    def loss(p):
        logits, l_ = jm.apply(p, jnp.asarray(idx), targets=jnp.asarray(tgt), train=False)
        return l_, logits

    (want_loss, want_logits), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm.eval()
    logits, got_loss = pm(torch.from_numpy(idx).long(), targets=torch.from_numpy(tgt).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=RTOL)
    got_loss.backward()
    want_g = jax_state_dict(jax.device_get(gp))
    got_g = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        if k.endswith("k_proj.bias"):
            assert g.abs().max().item() < 1e-6 and np.abs(want_g[k]).max() < 1e-6, k
            continue
        np.testing.assert_allclose(g.numpy(), want_g[k], atol=M_ATOL, rtol=M_RTOL, err_msg=k)
