"""Whisper-MoP in the port against the JAX package: the port's ``Conv2d``
against the JAX ``Conv`` through ``load_jax_params``' 4-D rule; the
``whisper_mop`` golden (logits, loss, gates); ``WhisperMoP`` from
``create_whisper_mop`` and ``create_whisper_baseline`` against the JAX model
with its weights carried over by ``load_jax_params``, in eval and in train
mode at dropout 0 (logits, loss, gates at rtol 2e-4 / atol 2e-5, every grad
within 1e-3 of its tensor's largest value, none missing), ``get_gate_maps``;
K1's three attention sites and the routes that compose. The parameter counts
and the comparison framework are in ``test_torch_whisper_comparison.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import mop_tpu.models as J
import mop_tpu_torch.models as PM
import mop_tpu_torch.ops.fused as TF
from mop_tpu.models.layers import Conv as JaxConv
from mop_tpu.utils.torch_port import load_golden
from mop_tpu_torch.config import config as kernel_switches
from mop_tpu_torch.models.layers import Conv2d
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL, ATOL = 2e-4, 2e-5
GRAD_FRAC = 1e-3
# The golden's config (tests/test_golden_numerics.py).
GOLDEN_CFG = dict(n_layer_enc=2, n_layer_dec=2, n_head=2, n_embd=32, n_mels=16, n_audio_ctx=32,
                  n_text_ctx=32, dropout=0.0, bias=False, n_views=2, n_kernels=1,
                  kernel_size=3, vocab_size=50)
FACTORIES = {"mop": (J.create_whisper_mop, PM.create_whisper_mop),
             "baseline": (J.create_whisper_baseline, PM.create_whisper_baseline)}


# ------------------------------ Conv2d ------------------------------


class _Holder(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv


@pytest.mark.parametrize("padding,stride,bias", [
    (1, 1, False), ((2, 0), 1, True), ("SAME", 1, False), ("SAME", 2, True),
    ("VALID", 1, True), (((1, 0), (0, 2)), 1, False)])
def test_conv2d_matches_jax(padding, stride, bias):
    """The port's Conv2d (NCHW) against the JAX Conv (NHWC) with its kernel
    moved by load_jax_params (HWIO -> OIHW), over the JAX layer's padding forms."""
    x = np.random.default_rng(0).standard_normal((2, 9, 7, 3)).astype(np.float32)
    jc = JaxConv(4, (3, 3), strides=(stride, stride), padding=padding, use_bias=bias)
    params = jax.device_get(jc.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    holder = load_jax_params(_Holder(Conv2d(3, 4, 3, stride=stride, padding=padding, bias=bias)),
                             {"conv": params["params"]})
    got = holder.conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------ golden ------------------------------


def _golden_state(ws):
    """The reference's state dict without its tied head, which is ``wte``."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in ws.items()}
    head = sd.pop("lm_head.weight")
    assert torch.equal(head, sd["wte.weight"])
    return sd


def test_whisper_mop_golden():
    ins, ws, outs = load_golden(os.path.join(GOLDEN, "whisper_mop.npz"))
    model = PM.create_whisper_mop(PM.WhisperConfig(**GOLDEN_CFG), device="cpu").eval()
    model.load_state_dict(_golden_state(ws), strict=True)
    with torch.no_grad():
        logits, loss, gates = model(torch.from_numpy(ins["mel"]), torch.from_numpy(ins["dec"]),
                                    targets=torch.from_numpy(ins["targets"]))
    for name, got in (("logits", logits), ("loss", loss), ("gates", gates)):
        np.testing.assert_allclose(got.numpy(), outs[name], rtol=RTOL, atol=ATOL, err_msg=name)


# ------------------------------ vs JAX ------------------------------


def _pair(kind, seed=0):
    jfac, pfac = FACTORIES[kind]
    jm = jfac(J.WhisperConfig(**GOLDEN_CFG))
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, 12, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 10)).astype(np.int32)
    tgt = rng.integers(0, 50, (2, 10)).astype(np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(mel), jnp.asarray(ids)))
    if kind == "mop":  # move the alphas off their init, so that loading them is tested
        for name, blk in params["params"].items():
            if name.startswith("encoder_"):
                blk["mop"]["fuse"]["alpha"] = rng.uniform(0.5, 1.5, (2,)).astype(np.float32)
    pm = load_jax_params(pfac(PM.WhisperConfig(**GOLDEN_CFG), device="cpu"), params)
    return jm, params, pm, mel, ids, tgt


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(FACTORIES))
def test_whisper_matches_jax(kind, train):
    """Logits, loss and gates; every parameter's grad, none None."""
    jm, params, pm, mel, ids, tgt = _pair(kind)

    def loss(p):
        logits, l_, gates = jm.apply(p, jnp.asarray(mel), jnp.asarray(ids),
                                     targets=jnp.asarray(tgt), train=train)
        return l_, (logits, gates)

    (want_loss, (want_logits, want_gates)), gp = jax.value_and_grad(loss, has_aux=True)(params)
    pm.train(train)
    logits, got_loss, gates = pm(torch.from_numpy(mel), torch.from_numpy(ids).long(),
                                 targets=torch.from_numpy(tgt).long())
    for name, got, want in (("logits", logits, want_logits), ("loss", got_loss, want_loss),
                            ("gates", gates, want_gates)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if kind == "baseline":
        assert torch.equal(gates, torch.ones_like(gates))
    got_loss.backward()
    want_g = jax_state_dict(jax.device_get(gp))
    got_g = dict(pm.named_parameters())
    assert sorted(got_g) == sorted(want_g)
    for k, p in got_g.items():
        assert p.grad is not None, k
        scale = max(np.abs(want_g[k]).max(), 1e-30)
        assert np.abs(p.grad.numpy() - want_g[k]).max() <= GRAD_FRAC * scale, k


def test_get_gate_maps_matches_jax():
    jm, params, pm, mel, _, _ = _pair("mop", seed=1)
    want = np.asarray(jm.apply(params, jnp.asarray(mel), method=jm.get_gate_maps))
    pm.train()
    got = pm.get_gate_maps(torch.from_numpy(mel))
    assert pm.training  # the mode is restored
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_zero_mop_alphas_gives_unit_gates():
    _, _, pm, mel, _, _ = _pair("mop")
    gates = PM.zero_mop_alphas(pm).get_gate_maps(torch.from_numpy(mel))
    assert torch.equal(gates, torch.ones_like(gates))


def test_positions_beyond_the_context_raise():
    _, _, pm, _, _, _ = _pair("mop")
    with pytest.raises(ValueError, match="context"):
        pm.encode(torch.zeros(1, 33, 16))
    with pytest.raises(ValueError, match="bins"):
        pm.encode(torch.zeros(1, 4, 15))


# ------------------------------ K1's sites and routes ------------------------------


def _flash_calls(pm, mel, ids, train=False):
    """The (q, k) shapes and causal flag of every call of K1's plain version."""
    calls = []
    orig = TF.flash_attention_plain

    def spy(q, k, v, causal=False):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return orig(q, k, v, causal)

    TF.flash_attention_plain = spy
    try:
        pm.train(train)(torch.from_numpy(mel), torch.from_numpy(ids).long())
    finally:
        TF.flash_attention_plain = orig
    return calls


def test_k1_takes_all_three_attention_sites():
    _, _, pm, mel, ids, _ = _pair("mop")
    enc, dec, cross = ((2, 2, 12, 16), (2, 2, 12, 16), False), \
        ((2, 2, 10, 16), (2, 2, 10, 16), True), ((2, 2, 10, 16), (2, 2, 12, 16), False)
    assert _flash_calls(pm, mel, ids) == [enc, enc, dec, cross, dec, cross]
    assert _flash_calls(pm, mel, ids, train=True) == [enc, enc, dec, cross, dec, cross]


def test_routes_that_compose():
    """The kernel switch off, or dropout in training, composes (no K1 call)
    and computes what K1 computes at dropout 0; eval mode with dropout runs K1."""
    _, params, pm, mel, ids, _ = _pair("mop")
    with torch.no_grad():
        want = pm.eval()(torch.from_numpy(mel), torch.from_numpy(ids).long())[0]
        kernel_switches.fused_attention = False
        try:
            assert _flash_calls(pm, mel, ids) == []
            got = pm.eval()(torch.from_numpy(mel), torch.from_numpy(ids).long())[0]
        finally:
            kernel_switches.fused_attention = True
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    drop = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**{**GOLDEN_CFG,
                                                                     "dropout": 0.1}),
                                                 device="cpu"), params)
    PM.set_generator(drop, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert _flash_calls(drop, mel, ids, train=True) == []
        assert len(_flash_calls(drop, mel, ids, train=False)) == 6
        torch.testing.assert_close(drop.eval()(torch.from_numpy(mel),
                                               torch.from_numpy(ids).long())[0], want)


def test_self_and_cross_attention_biases_compose():
    """An additive score bias (self) or mask (cross) takes the composed route:
    a zero bias computes the unbiased output, a bias of -inf on a key drops it."""
    torch.manual_seed(0)
    sa = PM.whisper_mop.MultiheadSelfAttention(32, 2, 0.0, False, causal=False).eval()
    ca = PM.whisper_mop.MultiheadCrossAttention(32, 32, 2, 0.0, False).eval()
    x, mem = torch.randn(2, 5, 32), torch.randn(2, 7, 32)
    with torch.no_grad():
        torch.testing.assert_close(sa(x, torch.zeros(5, 5)), sa(x), rtol=RTOL, atol=ATOL)
        bias = torch.zeros(5, 7)
        bias[:, -2:] = float("-inf")
        torch.testing.assert_close(ca(x, mem, bias), ca(x, mem[:, :5]), rtol=RTOL, atol=ATOL)
