"""Greedy Whisper transcription in the port against the JAX package:
``whisper_transcribe`` (the full window) tokens equal to JAX's at
``tests/test_generate.py``'s configs; ``whisper_transcribe_cached`` equal to
the full window in the port with fp32 and bf16 KV, and its int8-KV tokens
equal to JAX's ``whisper_transcribe_cached(kv_dtype=int8)``;
``whisper_decode_prep`` refusing int8; ``whisper_transcribe_auto``
switching at ``MOP_TPU_WHISPER_CACHED_MIN_CTX``; and the model's mode kept."""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.models.generate import whisper_transcribe_cached as jax_cached
from mop_tpu_torch.config import WHISPER_CACHED_MIN_CTX
from mop_tpu_torch.config import config as run_config
from mop_tpu_torch.utils.jax_weights import load_jax_params

# The module: the package's ``generate`` attribute is the GPT sampler.
G = importlib.import_module("mop_tpu_torch.models.generate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_generate.py:57 (greedy) and :129 (cached vs full), with their
# batch shapes, BOS tokens and lengths; tests/test_kv_dtype.py:121 (int8 KV).
CONFIGS = {
    "greedy": (dict(n_layer_enc=1, n_layer_dec=1, n_head=2, n_embd=32, n_mels=16,
                    n_audio_ctx=16, n_text_ctx=8, dropout=0.0, bias=False, n_views=2,
                    n_kernels=1, kernel_size=3, vocab_size=20), (2, 12, 16), 19, 6),
    "cached": (dict(n_mels=16, n_audio_ctx=24, vocab_size=40, n_text_ctx=16, n_embd=32,
                    n_head=2, n_layer_enc=2, n_layer_dec=2, dropout=0.0), (2, 24, 16), 3, 8),
    "int8": (dict(n_mels=8, n_audio_ctx=16, vocab_size=40, n_text_ctx=16, n_embd=32, n_head=2,
                  n_layer_enc=1, n_layer_dec=1, dropout=0.0), (4, 16, 8), 1, 8),
}


# The linear and conv kernels are scaled up from their init, so that the
# greedy tokens change along the sequence instead of repeating BOS.
KERNEL_SCALE = 5.0


def _pair(name, seed=0):
    cfg, mel_shape, bos, n = CONFIGS[name]
    jm = J.create_whisper_mop(J.WhisperConfig(**cfg))
    mel = np.random.default_rng(seed).standard_normal(mel_shape).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed + 1), jnp.asarray(mel),
                                    jnp.zeros((mel_shape[0], 4), jnp.int32)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, w: w * KERNEL_SCALE if "kernel" in jax.tree_util.keystr(path) else w, params)
    pm = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**cfg), device="cpu"), params)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm, mel, bos, n


@pytest.mark.parametrize("name", ["greedy", "cached"])
def test_full_window_tokens_equal_jax(name):
    jm, params, pm, mel, bos, n = _pair(name)
    want = np.asarray(J.whisper_transcribe(jm, params, jnp.asarray(mel), bos, n))
    pm.train()
    got = PM.whisper_transcribe(pm, torch.from_numpy(mel), bos, n)
    assert pm.training  # the mode is restored
    assert got.shape == (mel.shape[0], n) and len(np.unique(want)) > 2
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["greedy", "cached"])
def test_cached_tokens_equal_the_full_window(name, kv_dtype):
    _, _, pm, mel, bos, n = _pair(name, seed=2)
    full = PM.whisper_transcribe(pm, torch.from_numpy(mel), bos, n)
    got = PM.whisper_transcribe_cached(pm, torch.from_numpy(mel), bos, n, kv_dtype=kv_dtype)
    torch.testing.assert_close(got, full, rtol=0, atol=0)


def test_cached_logits_equal_the_full_window():
    """Each cached step's logits against the full window's at that position."""
    _, _, pm, mel, bos, n = _pair("cached", seed=4)
    mel_t = torch.from_numpy(mel)
    toks = PM.whisper_transcribe(pm, mel_t, bos, n)
    ids = torch.cat([torch.full((mel.shape[0], 1), bos), toks], 1)
    with torch.no_grad():
        full = pm.eval().decode(pm.encode(mel_t)[0], ids)
        cross_k, cross_v = G.whisper_decode_prep(pm, mel_t)
        cfg = pm.cfg
        shape = (cfg.n_layer_dec, mel.shape[0], cfg.n_head, n + 1, cfg.n_embd // cfg.n_head)
        ks, vs = torch.zeros(shape), torch.zeros(shape)
        for i in range(n):
            logits, ks, vs = G.whisper_decode_token(pm, ids[:, i], i, ks, vs, cross_k, cross_v)
            torch.testing.assert_close(logits, full[:, i], rtol=1e-5, atol=1e-5)


def test_int8_kv_tokens_equal_jax():
    jm, params, pm, mel, bos, n = _pair("int8", seed=3)
    want = np.asarray(jax_cached(jm, params, jnp.asarray(mel), bos, n, kv_dtype=jnp.int8))
    got = PM.whisper_transcribe_cached(pm, torch.from_numpy(mel), bos, n, kv_dtype=torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_q8_rows_equal_jax():
    from mop_tpu.models.generate import _q8_rows as jax_q8

    rows = np.random.default_rng(5).standard_normal((2, 3, 7, 16)).astype(np.float32)
    rows[0, 1, 2] = 0.0  # an all-zero row gets scale 1
    q, s = G._q8_rows(torch.from_numpy(rows))
    jq, js = jax_q8(jnp.asarray(rows))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 1, 2] == 1.0


def test_decode_prep_refuses_int8():
    _, _, pm, mel, _, _ = _pair("int8")
    with pytest.raises(ValueError, match="scales"):
        G.whisper_decode_prep(pm, torch.from_numpy(mel), torch.int8)
    k, v = G.whisper_decode_prep(pm, torch.from_numpy(mel), torch.bfloat16)
    assert k.dtype == v.dtype == torch.bfloat16 and tuple(k.shape) == (1, 4, 2, 16, 16)


def test_auto_switches_at_the_threshold():
    _, _, pm, mel, bos, n = _pair("cached", seed=6)
    routes = []
    full, cached = G.whisper_transcribe, G.whisper_transcribe_cached
    G.whisper_transcribe = lambda *a, **k: routes.append("full") or full(*a, **k)
    G.whisper_transcribe_cached = lambda *a, **k: routes.append("cached") or cached(*a, **k)
    saved = run_config.whisper_cached_min_ctx
    try:
        outs = []
        for threshold in (n + 1, n, 0):
            run_config.whisper_cached_min_ctx = threshold
            outs.append(G.whisper_transcribe_auto(pm, torch.from_numpy(mel), bos, n))
    finally:
        run_config.whisper_cached_min_ctx = saved
        G.whisper_transcribe, G.whisper_transcribe_cached = full, cached
    assert routes == ["full", "cached", "cached"]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)


def test_threshold_reads_its_environment_variable():
    code = ("from mop_tpu_torch.config import config, WHISPER_CACHED_MIN_CTX; "
            "print(config.whisper_cached_min_ctx, WHISPER_CACHED_MIN_CTX)")
    env = {**os.environ, "MOP_TPU_WHISPER_CACHED_MIN_CTX": "7"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         check=True, timeout=120).stdout.split()
    assert out == ["7", str(WHISPER_CACHED_MIN_CTX)]
