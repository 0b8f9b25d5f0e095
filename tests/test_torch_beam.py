"""Beam search in the port against the JAX package (``mop_tpu.models.beam``):
``generate_beam`` sequences and scores (Quartet LM, baseline, causal
GPT-MoP; length penalties 1, 0 and 0.5; int8 KV), ``whisper_transcribe_beam``
sequences and scores; beam 1 equal to greedy on both; EOS freezing and
padding; the exhaustive two-step search; the stable top-k's tie order;
the argument checks and int8 refused on the Whisper beam."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.models.beam as JB
import mop_tpu_torch.models as PM
from _torch_decode_common import (ATOL, RTOL, _one_torch_thread,  # noqa: F401
                                  lm_pair, prompt_of)
from mop_tpu_torch.models import beam as B
from mop_tpu_torch.utils.jax_weights import load_jax_params

G = importlib.import_module("mop_tpu_torch.models.generate")


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("kind,penalty", [("quartet", 1.0), ("quartet", 0.0),
                                          ("baseline", 0.5), ("mop_causal", 1.0)])
def test_generate_beam_equals_jax(kind, penalty):
    jm, params, pm = lm_pair(kind, scale=3.0)
    prompt = prompt_of((2, 4), seed=20)
    want_s, want_f = JB.generate_beam(jm, params, jnp.asarray(prompt), 6, num_beams=4,
                                      length_penalty=penalty, return_all=True)
    got_s, got_f = B.generate_beam(pm, None, torch.from_numpy(prompt), 6, num_beams=4,
                                   length_penalty=penalty, return_all=True)
    assert tuple(got_s.shape) == (2, 4, 10) and got_s.dtype == torch.long
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    np.testing.assert_allclose(got_f.numpy(), _np(want_f), rtol=RTOL, atol=ATOL)
    best = B.generate_beam(pm, None, torch.from_numpy(prompt), 6, num_beams=4,
                           length_penalty=penalty)
    torch.testing.assert_close(best, got_s[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["fp32", "int8"])
def test_beam1_equals_greedy_cached(kv):
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompt = torch.from_numpy(prompt_of((2, 4), seed=21))
    greedy = G.generate_cached(pm, None, prompt, 8, kv_dtype=kv)
    torch.testing.assert_close(B.generate_beam(pm, None, prompt, 8, num_beams=1, kv_dtype=kv),
                               greedy, rtol=0, atol=0)


def test_int8_beam_equals_jax():
    jm, params, pm = lm_pair("baseline", scale=3.0)
    prompt = prompt_of((2, 4), seed=22)
    want_s, want_f = JB.generate_beam(jm, params, jnp.asarray(prompt), 4, num_beams=3,
                                      kv_dtype=jnp.int8, return_all=True)
    got_s, got_f = B.generate_beam(pm, None, torch.from_numpy(prompt), 4, num_beams=3,
                                   kv_dtype=torch.int8, return_all=True)
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    np.testing.assert_allclose(got_f.numpy(), _np(want_f), rtol=1e-3, atol=1e-3)


def test_eos_freezes_and_pads_as_jax():
    """EOS is the greedy first token: that beam finishes at length 1, pads
    with EOS and keeps its one-token score, as JAX's."""
    jm, params, pm = lm_pair("quartet", scale=3.0)
    prompt = prompt_of((1, 4), seed=23)
    eos = int(G.generate_cached(pm, None, torch.from_numpy(prompt), 1)[0, -1])
    kw = dict(num_beams=3, eos_id=eos, length_penalty=0.0, return_all=True)
    seqs, scores = B.generate_beam(pm, None, torch.from_numpy(prompt), 6, **kw)
    want_s, want_f = JB.generate_beam(jm, params, jnp.asarray(prompt), 6, **kw)
    np.testing.assert_array_equal(seqs.numpy(), _np(want_s))
    np.testing.assert_allclose(scores.numpy(), _np(want_f), rtol=RTOL, atol=ATOL)
    fin = [i for i in range(3) if seqs[0, i, 4] == eos]
    assert fin and bool((seqs[0, fin[0], 4:] == eos).all())
    logits0, _ = G.prefill(pm, None, torch.from_numpy(prompt))
    one = torch.log_softmax(logits0, -1)[0, eos]
    torch.testing.assert_close(scores[0, fin[0]], one, rtol=0, atol=1e-5)


def test_exhaustive_two_steps():
    """num_beams = vocab over two steps enumerates every continuation: the
    best is the argmax of the forced two-token log-prob."""
    v = 7
    _, _, pm = lm_pair("quartet", vocab=v, scale=3.0)
    prompt = torch.from_numpy(prompt_of((2, 4), seed=24, vocab=v))
    out = B.generate_beam(pm, None, prompt, 2, num_beams=v, length_penalty=0.0)
    grid = torch.cartesian_prod(torch.arange(v), torch.arange(v))
    for row in range(2):
        rp = prompt[row].expand(v * v, 4)
        logits, cache = G.prefill(pm, None, rp)
        s = torch.log_softmax(logits, -1)[torch.arange(v * v), grid[:, 0]]
        logits, _ = G.decode_step(pm, None, cache, grid[:, 0])
        s = s + torch.log_softmax(logits, -1)[torch.arange(v * v), grid[:, 1]]
        torch.testing.assert_close(out[row, 4:], grid[s.argmax()], rtol=0, atol=0)


def test_beam_select_breaks_ties_by_lower_index_as_jax():
    scores = np.zeros((2, 3), np.float32)
    logp = np.full((2, 3, 5), -2.0, np.float32)
    logp[:, :, 1] = logp[:, :, 3] = -1.0  # six equal best candidates a row
    alive = np.array([[True, False, True], [True, True, True]])
    got = B._beam_select(torch.from_numpy(scores), torch.from_numpy(logp),
                         torch.from_numpy(alive), 0)
    want = JB._beam_select(jnp.asarray(scores), jnp.asarray(logp), jnp.asarray(alive), 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_generate_beam_checks_its_arguments():
    _, _, pm = lm_pair("quartet", vocab=9)
    prompt = torch.zeros(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="num_beams"):
        B.generate_beam(pm, None, prompt, 4, num_beams=0)
    with pytest.raises(ValueError, match="vocab_size"):
        B.generate_beam(pm, None, prompt, 4, num_beams=10)
    with pytest.raises(ValueError, match="block_size"):
        B.generate_beam(pm, None, prompt, 400, num_beams=2)


# ------------------------------ Whisper ------------------------------


@pytest.fixture(scope="module")
def whisper():
    """tests/test_beam.py's Whisper config, kernels x 3 so that the beams differ."""
    cfg = dict(n_mels=16, n_audio_ctx=24, vocab_size=12, n_text_ctx=16, n_embd=32, n_head=2,
               n_layer_enc=1, n_layer_dec=2, dropout=0.0)
    jm = J.create_whisper_mop(J.WhisperConfig(**cfg))
    mel = np.random.default_rng(25).standard_normal((2, 24, 16)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(mel),
                                    jnp.zeros((2, 4), jnp.int32)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, w: w * 3.0 if "kernel" in jax.tree_util.keystr(path) else w, params)
    pm = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**cfg), device="cpu"), params)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm, mel


@pytest.mark.parametrize("penalty,eos", [(1.0, None), (0.0, 5)])
def test_whisper_beam_equals_jax(whisper, penalty, eos):
    jm, params, pm, mel = whisper
    kw = dict(num_beams=3, length_penalty=penalty, eos_id=eos, return_all=True)
    want_s, want_f = JB.whisper_transcribe_beam(jm, params, jnp.asarray(mel), 3, 8, **kw)
    pm.train()
    got_s, got_f = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 8, **kw)
    assert pm.training and tuple(got_s.shape) == (2, 3, 8)
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    np.testing.assert_allclose(got_f.numpy(), _np(want_f), rtol=RTOL, atol=ATOL)
    assert bool((got_f[:, :-1] >= got_f[:, 1:]).all())


def test_whisper_beam1_equals_greedy_cached(whisper):
    _, _, pm, mel = whisper
    greedy = G.whisper_transcribe_cached(pm, torch.from_numpy(mel), 3, 8)
    beam = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 8, num_beams=1)
    torch.testing.assert_close(beam, greedy, rtol=0, atol=0)
    assert len(set(greedy.flatten().tolist())) > 2


def test_whisper_beam_refuses_int8_and_checks_beams(whisper):
    _, _, pm, mel = whisper
    with pytest.raises(ValueError, match="scales"):
        B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 4, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="vocab_size"):
        B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 4, num_beams=13)
    out = B.whisper_transcribe_beam(pm, torch.from_numpy(mel), 3, 4, kv_dtype=torch.bfloat16)
    assert tuple(out.shape) == (2, 4)
