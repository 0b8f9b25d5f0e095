"""Whisper's cached decode over a JAX-layout tree in the port, against the
JAX package: ``whisper_decode_params`` laid out as the JAX tree;
``whisper_transcribe_cached`` over int8 / int4 weights
(``quantize_params(..., bits=8|4)``) giving JAX's tokens over the same
quantized tree, up to the first near tie; the fp32 tree giving the module's
tokens; and ``whisper_transcribe_auto`` under int8 KV giving the cached
route's int8 tokens on both sides of ``whisper_cached_min_ctx``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.models.generate import whisper_decode_prep as jax_prep
from mop_tpu.models.generate import whisper_decode_token as jax_token
from mop_tpu.models.generate import whisper_transcribe_cached as jax_cached
from mop_tpu.ops.quant import quantize_params as jax_quantize
from mop_tpu_torch.config import config as run_config
from mop_tpu_torch.utils.jax_weights import _flatten, load_jax_params

from _torch_decode_common import _one_torch_thread, assert_tokens_up_to_tie, margin, to_torch  # noqa: F401

G = importlib.import_module("mop_tpu_torch.models.generate")

# tests/test_generate.py:129's config, with a wider MLP-free budget: every
# 2-D kernel (32 x 32 and up) is quantized at min_size 1024.
CFG = dict(n_mels=16, n_audio_ctx=24, vocab_size=40, n_text_ctx=16, n_embd=32, n_head=2,
           n_layer_enc=2, n_layer_dec=2, dropout=0.0)
MIN_SIZE = 1024
KERNEL_SCALE = 5.0  # the greedy tokens vary instead of repeating BOS


def _pair(seed=0, b=3):
    jm = J.create_whisper_mop(J.WhisperConfig(**CFG))
    mel = np.random.default_rng(seed).standard_normal((b, 24, 16)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed + 1), jnp.asarray(mel),
                                    jnp.zeros((b, 4), jnp.int32)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, w: w * KERNEL_SCALE if "kernel" in jax.tree_util.keystr(path) else w, params)
    pm = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**CFG), device="cpu"), params)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm.eval(), mel


def _jax_margins(jm, params, mel, toks, bos):
    """Each step's top-two margin of JAX's cached logits, teacher-forced on
    its own tokens."""
    p, cfg, ck, cv = jax_prep(jm, params, jnp.asarray(mel))
    b, n = toks.shape
    shape = (cfg.n_layer_dec, b, cfg.n_head, n + 1, cfg.n_embd // cfg.n_head)
    ks = vs = jnp.zeros(shape, jnp.float32)
    tok = jnp.full((b,), bos, jnp.int32)
    out = []
    for i in range(n):
        logits, ks, vs = jax_token(p, cfg, tok, i, ks, vs, ck, cv)
        out.append(margin(logits))
        tok = jnp.asarray(toks[:, i])
    return np.stack(out, 1)


def test_whisper_decode_params_is_the_jax_tree():
    _, params, pm, _ = _pair()
    want = _flatten(jax.device_get(params)["params"])
    got = _flatten(G.whisper_decode_params(pm)["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bits", [8, 4])
def test_cached_quantized_weights_equal_jax(bits):
    jm, params, pm, mel = _pair()
    qj = jax_quantize(params, min_size=MIN_SIZE, bits=bits)
    want = np.asarray(jax_cached(jm, qj, jnp.asarray(mel), 3, 10))
    qt = to_torch(jax.device_get(qj))
    pm.train()
    got = G.whisper_transcribe_cached(pm, torch.from_numpy(mel), 3, 10, params=qt)
    assert pm.training  # the mode is restored
    assert len(np.unique(want)) > 2
    assert_tokens_up_to_tie(got.numpy(), want, _jax_margins(jm, qj, mel, want, 3))
    # the quantized weights change the tokens: the tree is what the decode reads
    fp = np.asarray(jax_cached(jm, params, jnp.asarray(mel), 3, 10))
    assert (fp != want).any() or bits == 8


def test_cached_fp32_tree_equals_module():
    _, params, pm, mel = _pair(seed=2)
    mel_t = torch.from_numpy(mel)
    own = G.whisper_transcribe_cached(pm, mel_t, 3, 10)
    tree = G.whisper_transcribe_cached(pm, mel_t, 3, 10, params=to_torch(jax.device_get(params)))
    np.testing.assert_array_equal(tree.numpy(), own.numpy())
    enc_tree = G.whisper_encode(pm, mel_t, to_torch(jax.device_get(params)))
    with torch.no_grad():
        enc_own = pm.encode(mel_t)[0]
    np.testing.assert_allclose(enc_tree.numpy(), enc_own.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [6, 12])
def test_auto_int8_kv_takes_the_cached_route_on_both_sides(n):
    """Below the threshold an fp32-KV request takes the full window; an
    int8-KV request keeps its quantized cache whatever its length, so the
    tokens are ``whisper_transcribe_cached``'s int8 tokens on both sides."""
    _, _, pm, mel = _pair(seed=7, b=4)
    mel_t = torch.from_numpy(mel)
    saved = run_config.whisper_cached_min_ctx
    try:
        run_config.whisper_cached_min_ctx = 10
        got = G.whisper_transcribe_auto(pm, mel_t, 1, n, kv_dtype=torch.int8)
    finally:
        run_config.whisper_cached_min_ctx = saved
    want = G.whisper_transcribe_cached(pm, mel_t, 1, n, kv_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
