"""Whisper transcription serving in the port against the JAX package: the
port's ``WhisperServingEngine`` emits JAX's ``WhisperServingEngine`` tokens
over the same weights (int8 / int4 in ``test_torch_serving_whisper_quant.py``)
for staggered requests admitted into slots at
different decode positions; each stream equals the port's single-stream
``whisper_transcribe_cached`` for its mel alone; EOS retires a stream;
``step(n_tokens=k)`` gives the tokens of single steps. Tokens equal up to
the first near tie of the single-stream logits, teacher-forced on JAX's
tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.ops.quant import quantize_params as jax_quantize
from mop_tpu.serving import WhisperServingEngine as JaxWhisperEngine
from mop_tpu_torch.serving import WhisperServingEngine
from mop_tpu_torch.utils.jax_weights import load_jax_params

from _torch_serving_common import G, TIE, _one_torch_thread, to_torch  # noqa: F401

BOS = 1
CFG = dict(n_mels=8, n_audio_ctx=16, vocab_size=40, n_text_ctx=16, n_embd=32, n_head=2,
           n_layer_enc=1, n_layer_dec=2, dropout=0.0)
BUDGETS = [12, 7, 9, 5]


def _setup():
    jm = J.create_whisper_mop(J.WhisperConfig(**CFG))
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 8)),
                                    jnp.zeros((1, 4), jnp.int32)))
    params = jax.tree_util.tree_map_with_path(  # spread the logits: the tokens vary
        lambda path, w: w * 4.0 if "kernel" in jax.tree_util.keystr(path) else w, params)
    pm = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**CFG), device="cpu"), params)
    mels = [np.random.default_rng(i).standard_normal((1, 16, 8)).astype(np.float32)
            for i in range(len(BUDGETS))]
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm.eval(), mels


def _staggered(eng, mels, n_tokens=1):
    rids = [eng.submit(m, n) for m, n in zip(mels[:2], BUDGETS[:2])]
    eng.step(n_tokens=n_tokens)
    eng.step(n_tokens=n_tokens)
    rids += [eng.submit(m, n) for m, n in zip(mels[2:], BUDGETS[2:])]
    res = eng.run(n_tokens=n_tokens)
    return [res[r] for r in rids]


def _margins(pm, params, mel, toks):
    """The port's single-stream top-two margins, teacher-forced on ``toks``."""
    m = torch.from_numpy(mel)
    ck, cv = G.whisper_decode_prep(pm, m, params=params)
    shape = (CFG["n_layer_dec"], 1, 2, len(toks) + 1, 16)
    ks, vs = torch.zeros(shape), torch.zeros(shape)
    out, tok = [], torch.tensor([BOS])
    with torch.no_grad():
        for i, t in enumerate(toks):
            logits = G.whisper_decode_token(pm, tok, i, ks, vs, ck, cv, params=params)[0]
            top = logits[0].sort().values
            out.append(float(top[-1] - top[-2]))
            tok = torch.tensor([t])
    return out


def engines_agree(bits=None):
    jm, jp, pm, mels = _setup()
    if bits is not None:
        jp = jax_quantize(jp, min_size=1024, bits=bits)
    pp = to_torch(jax.device_get(jp))
    want = _staggered(JaxWhisperEngine(jm, jp, max_batch=2, bos_token=BOS), mels)
    got = _staggered(WhisperServingEngine(pm, pp, max_batch=2, bos_token=BOS), mels)
    for i, mel in enumerate(mels):
        margins = _margins(pm, pp, mel, want[i])
        stop = next((j for j, m in enumerate(margins) if m < TIE), len(want[i]))
        assert stop > 0 and got[i][:stop] == want[i][:stop], (i, got[i], want[i])
        solo = G.whisper_transcribe_cached(pm, torch.from_numpy(mel), BOS, BUDGETS[i],
                                           params=pp)[0].tolist()
        assert got[i][:stop] == solo[:stop]
    assert len({tuple(g) for g in got}) > 1


def test_engine_tokens_equal_jax_engine():
    engines_agree()


def test_eos_multistep_and_checks():
    _, _, pm, mels = _setup()
    full = G.whisper_transcribe_cached(pm, torch.from_numpy(mels[0]), BOS, 12)[0].tolist()
    eng = WhisperServingEngine(pm, None, max_batch=1, bos_token=BOS, eos_id=full[2])
    rid = eng.submit(mels[0], 12)
    assert eng.run()[rid] == full[:full.index(full[2]) + 1] and eng.is_done(rid)
    one = _staggered(WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS), mels)
    three = _staggered(WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS), mels, 3)
    assert three == one
    bf = WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS, kv_dtype=torch.bfloat16)
    assert len(_staggered(bf, mels)[0]) == BUDGETS[0]
    with pytest.raises(ValueError, match="fp32 or bf16"):
        WhisperServingEngine(pm, None, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="mel must be"):
        eng.submit(np.zeros((1, 15, 8), np.float32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(mels[0], 17)
