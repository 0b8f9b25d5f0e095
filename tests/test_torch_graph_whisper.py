"""Both Whisper transcription routes' ``cuda_graph=True`` forms on the CPU,
where no CUDA graph can be captured.

- The refusals: ``whisper_transcribe``, ``whisper_transcribe_cached`` and
  ``whisper_transcribe_auto`` on the CPU.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): the full
  window's step at a device position (the logits gathered at it, the token
  written by a one-hot select) and the cached step at a (B,) device position
  give JAX's ``whisper_transcribe`` / ``whisper_transcribe_cached`` tokens
  (fp32 KV, and int8 KV against JAX's int8); bf16 and int8 KV equal to the
  eager port token for token; ``whisper_transcribe_auto`` passes
  ``cuda_graph`` to the route it takes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.models.generate import whisper_transcribe_cached as jax_cached
from mop_tpu_torch.config import config as run_config
from mop_tpu_torch.utils.jax_weights import load_jax_params

G = importlib.import_module("mop_tpu_torch.models.generate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lifted(monkeypatch):
    """The graphed routes on the CPU: ``require_graph`` accepts any device."""
    monkeypatch.setattr(G, "require_graph", lambda *a, **k: None)


# tests/test_torch_whisper_decode.py's "cached" and "int8" configs.
CONFIGS = {
    "fp32": (dict(n_mels=16, n_audio_ctx=24, vocab_size=40, n_text_ctx=16, n_embd=32,
                  n_head=2, n_layer_enc=2, n_layer_dec=2, dropout=0.0), (2, 24, 16), 3, 8),
    "int8": (dict(n_mels=8, n_audio_ctx=16, vocab_size=40, n_text_ctx=16, n_embd=32, n_head=2,
                  n_layer_enc=1, n_layer_dec=1, dropout=0.0), (4, 16, 8), 1, 8),
}
KERNEL_SCALE = 5.0  # the tokens change along the sequence instead of repeating BOS


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX model, JAX params, port model, mel, BOS, tokens)."""
    out = {}
    for seed, (name, (cfg, mel_shape, bos, n)) in enumerate(CONFIGS.items()):
        jm = J.create_whisper_mop(J.WhisperConfig(**cfg))
        mel = np.random.default_rng(seed).standard_normal(mel_shape).astype(np.float32)
        params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed + 1),
                                                 jnp.asarray(mel),
                                                 jnp.zeros((mel_shape[0], 4), jnp.int32)))
        params = jax.tree_util.tree_map_with_path(
            lambda path, w: w * KERNEL_SCALE if "kernel" in jax.tree_util.keystr(path) else w,
            params)
        pm = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**cfg), device="cpu"),
                             params)
        out[name] = (jm, jax.tree_util.tree_map(jnp.asarray, params), pm, mel, bos, n)
    return out


def test_cuda_graph_refuses_the_cpu(pairs):
    _, _, pm, mel, bos, n = pairs["fp32"]
    mel = torch.from_numpy(mel)
    for fn, name in ((G.whisper_transcribe, "whisper_transcribe"),
                     (G.whisper_transcribe_cached, "whisper_transcribe_cached")):
        with pytest.raises(ValueError, match=f"{name}: cuda_graph=True needs a CUDA device"):
            fn(pm, mel, bos, n, cuda_graph=True)
    with pytest.raises(ValueError, match="cuda_graph=True needs a CUDA device"):
        G.whisper_transcribe_auto(pm, mel, bos, n, cuda_graph=True)


def test_device_position_routes_equal_jax(pairs, lifted):
    """The full window and the cached route (fp32 KV) at a device position
    give JAX's ``whisper_transcribe`` tokens; the model's mode is kept."""
    jm, params, pm, mel, bos, n = pairs["fp32"]
    want = np.asarray(J.whisper_transcribe(jm, params, jnp.asarray(mel), bos, n))
    assert len(np.unique(want)) > 2
    pm.train()
    for fn in (G.whisper_transcribe, G.whisper_transcribe_cached):
        got = fn(pm, torch.from_numpy(mel), bos, n, cuda_graph=True)
        assert pm.training and got.shape == (mel.shape[0], n)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)
    pm.eval()


def test_device_position_int8_kv_equals_jax(pairs, lifted):
    jm, params, pm, mel, bos, n = pairs["int8"]
    want = np.asarray(jax_cached(jm, params, jnp.asarray(mel), bos, n, kv_dtype=jnp.int8))
    got = G.whisper_transcribe_cached(pm, torch.from_numpy(mel), bos, n, kv_dtype=torch.int8,
                                      cuda_graph=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_position_cached_route_is_the_eager_loop(pairs, name, kv_dtype, lifted):
    _, _, pm, mel, bos, n = pairs[name]
    runs = [G.whisper_transcribe_cached(pm, torch.from_numpy(mel), bos, n, kv_dtype=kv_dtype,
                                        cuda_graph=graphed) for graphed in (False, True)]
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)


def test_auto_passes_cuda_graph_to_its_route(pairs, monkeypatch, lifted):
    """Below ``whisper_cached_min_ctx`` the full window, from it on the
    cached route, each called with the ``cuda_graph`` it was given."""
    _, _, pm, mel, bos, n = pairs["fp32"]
    seen = []
    for route in ("whisper_transcribe", "whisper_transcribe_cached"):
        real = getattr(G, route)
        monkeypatch.setattr(G, route, lambda *a, _r=route, _f=real, **kw:
                            seen.append((_r, kw["cuda_graph"])) or _f(*a, **kw))
    mel = torch.from_numpy(mel)
    for min_ctx in (n + 1, n):
        monkeypatch.setattr(run_config, "whisper_cached_min_ctx", min_ctx)
        G.whisper_transcribe_auto(pm, mel, bos, n, cuda_graph=True)
    G.whisper_transcribe_auto(pm, mel, bos, n, kv_dtype=torch.bfloat16)
    assert seen == [("whisper_transcribe", True), ("whisper_transcribe_cached", True),
                    ("whisper_transcribe_cached", False)]
