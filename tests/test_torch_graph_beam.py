"""Beam search's ``cuda_graph=True`` form on the CPU, where no CUDA graph
can be captured.

- The refusals: ``generate_beam`` and ``whisper_transcribe_beam`` on the
  CPU, ``generate_beam`` with a tensor-parallel model.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): one search
  step at a device position, the caches gathered by parent row in place,
  against the eager search (beams equal, scores at fp32 rtol 2e-4 / atol
  2e-5; Quartet, baseline and causal GPT-MoP, length penalties, EOS, fp32
  and int8 KV; Whisper fp32 and bf16 KV) and against JAX's
  ``generate_beam`` / ``whisper_transcribe_beam``; one beam equal to the
  greedy cached decode.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.models.beam as JB
import mop_tpu_torch.models as PM
from _torch_decode_common import (ATOL, RTOL, _one_torch_thread,  # noqa: F401
                                  lift_graphs, lm_pair, prompt_of)
from mop_tpu_torch.models import beam as B
from mop_tpu_torch.utils.jax_weights import load_jax_params

G = importlib.import_module("mop_tpu_torch.models.generate")


@pytest.fixture
def lifted(monkeypatch):
    """The graphed search on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, B)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


def _same(got, want):
    """Beams equal token for token, scores within the fp32 tolerance."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def whisper():
    """tests/test_torch_beam.py's Whisper config, kernels x 3 so that the beams differ."""
    cfg = dict(n_mels=16, n_audio_ctx=24, vocab_size=12, n_text_ctx=16, n_embd=32, n_head=2,
               n_layer_enc=1, n_layer_dec=2, dropout=0.0)
    jm = J.create_whisper_mop(J.WhisperConfig(**cfg))
    mel = np.random.default_rng(26).standard_normal((2, 24, 16)).astype(np.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(mel),
                                             jnp.zeros((2, 4), jnp.int32)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, w: w * 3.0 if "kernel" in jax.tree_util.keystr(path) else w, params)
    pm = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**cfg), device="cpu"), params)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm, mel


def test_cuda_graph_refuses_the_cpu_and_tensor_parallel(whisper, monkeypatch):
    _, _, pm = lm_pair("quartet")
    prompt = torch.from_numpy(prompt_of((2, 4)))
    with pytest.raises(ValueError, match="generate_beam: cuda_graph=True needs a CUDA"):
        B.generate_beam(pm, None, prompt, 4, num_beams=2, cuda_graph=True)
    _, _, wm, mel = whisper
    with pytest.raises(ValueError, match="whisper_transcribe_beam: cuda_graph=True needs a CUDA"):
        B.whisper_transcribe_beam(wm, torch.from_numpy(mel), 3, 4, num_beams=2, cuda_graph=True)
    monkeypatch.setattr(pm, "decode_split", SimpleNamespace(n_head=1), raising=False)
    with pytest.raises(ValueError, match="generate_beam: cuda_graph=True does not take a "
                                         "tensor-parallel model"):
        B.generate_beam(pm, None, prompt, 4, num_beams=2, cuda_graph=True)


@pytest.mark.parametrize("kind,penalty,kv", [("quartet", 1.0, "fp32"), ("baseline", 0.5, "fp32"),
                                             ("mop_causal", 0.0, "fp32"),
                                             ("quartet", 1.0, "int8")])
def test_graphed_beam_is_the_eager_search(kind, penalty, kv, lifted):
    _, _, pm = lm_pair(kind, scale=3.0)
    prompt = torch.from_numpy(prompt_of((2, 4), seed=40))
    kw = dict(num_beams=4, length_penalty=penalty, return_all=True,
              kv_dtype=torch.float32 if kv == "fp32" else torch.int8)
    want = B.generate_beam(pm, None, prompt, 8, **kw)
    got = B.generate_beam(pm, None, prompt, 8, cuda_graph=True, **kw)
    _same(got, want)
    assert len(set(got[0][:, :, 4:].flatten().tolist())) > 2
    best = B.generate_beam(pm, None, prompt, 8, num_beams=4, length_penalty=penalty,
                           kv_dtype=kw["kv_dtype"], cuda_graph=True)
    torch.testing.assert_close(best, got[0][:, 0], rtol=0, atol=0)


def test_graphed_beam_with_eos_is_the_eager_search(lifted):
    """EOS is a beam's greedy first token: it finishes at length 1 and pads."""
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompt = torch.from_numpy(prompt_of((1, 4), seed=23))
    eos = int(G.generate_cached(pm, None, prompt, 1)[0, -1])
    kw = dict(num_beams=3, eos_id=eos, length_penalty=0.0, return_all=True)
    got = B.generate_beam(pm, None, prompt, 6, cuda_graph=True, **kw)
    _same(got, B.generate_beam(pm, None, prompt, 6, **kw))
    fin = [i for i in range(3) if got[0][0, i, 4] == eos]
    assert fin and bool((got[0][0, fin[0], 4:] == eos).all())


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_graphed_beam_equals_jax(kind, lifted):
    jm, params, pm = lm_pair(kind, scale=3.0)
    prompt = prompt_of((2, 4), seed=41)
    want = JB.generate_beam(jm, params, jnp.asarray(prompt), 6, num_beams=3, return_all=True)
    got = B.generate_beam(pm, None, torch.from_numpy(prompt), 6, num_beams=3, return_all=True,
                          cuda_graph=True)
    _same(got, want)


def test_graphed_beam1_is_greedy_cached(lifted):
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompt = torch.from_numpy(prompt_of((2, 4), seed=42))
    greedy = G.generate_cached(pm, None, prompt, 8)
    torch.testing.assert_close(B.generate_beam(pm, None, prompt, 8, num_beams=1,
                                               cuda_graph=True), greedy, rtol=0, atol=0)


@pytest.mark.parametrize("kv,penalty,eos", [("fp32", 1.0, None), ("fp32", 0.0, 5),
                                            ("bf16", 1.0, None)])
def test_graphed_whisper_beam_is_the_eager_search(whisper, kv, penalty, eos, lifted):
    _, _, pm, mel = whisper
    kw = dict(num_beams=3, length_penalty=penalty, eos_id=eos, return_all=True,
              kv_dtype=torch.float32 if kv == "fp32" else torch.bfloat16)
    want = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 8, **kw)
    pm.train()
    got = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 8, cuda_graph=True, **kw)
    assert pm.training
    pm.eval()
    _same(got, want)
    assert len(set(got[0].flatten().tolist())) > 2


def test_graphed_whisper_beam_equals_jax(whisper, lifted):
    jm, params, pm, mel = whisper
    kw = dict(num_beams=3, length_penalty=1.0, return_all=True)
    want = JB.whisper_transcribe_beam(jm, params, jnp.asarray(mel), 3, 8, **kw)
    got = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 8, cuda_graph=True, **kw)
    _same(got, want)
    greedy = G.whisper_transcribe_cached(pm, torch.from_numpy(mel), 3, 8)
    one = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 8, num_beams=1,
                                    cuda_graph=True)
    torch.testing.assert_close(one, greedy, rtol=0, atol=0)
