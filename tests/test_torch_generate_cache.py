"""The port's KV-cached GPT decoder against the JAX package
(``mop_tpu.models.generate``): ``prefill`` / ``prefill_padded`` /
``decode_step`` / ``decode_chunk`` with fp32, bf16 and int8 KV for the
Quartet LM, the baseline and both GPT-MoP variants (logits and live cache
rows); ``generate_cached`` greedy and with penalties; the grow window
bit-equal to the single window; the cache's layout and bounds."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode_common import (ATOL, RTOL, VOCAB, _one_torch_thread,  # noqa: F401
                                  assert_tokens_up_to_tie, lm_pair, margin, prompt_of,
                                  to_torch)

# The modules: each package's ``generate`` attribute is the sampler itself.
JG = importlib.import_module("mop_tpu.models.generate")
G = importlib.import_module("mop_tpu_torch.models.generate")

# ------------------------------ the cache ------------------------------

KV = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
      "int8": (torch.int8, jnp.int8)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cache_rows(cache, n):
    """The live rows of a cache (the port's or JAX's) as fp32 arrays, int8
    ones dequantized."""
    out = {}
    for key in ("k", "k2", "v"):
        out[key] = _np(cache[key])[..., :n, :]
        if key + "_s" in cache:
            out[key] = out[key] * _np(cache[key + "_s"])[..., :n, None]
    if "mv" in cache:
        out["mv"] = _np(cache["mv"])[:, :, :n]
    return out


def _close_caches(got, want, n, kv):
    tol = dict(rtol=RTOL, atol=ATOL) if kv == "fp32" else dict(rtol=1e-2, atol=1e-2)
    g, w = _cache_rows(got, n), _cache_rows(want, n)
    assert sorted(g) == sorted(w) and got["len"] == int(want["len"]) == n
    for key in w:
        np.testing.assert_allclose(g[key], w[key], err_msg=key, **tol)


def _logit_tol(kv):
    return dict(rtol=RTOL, atol=ATOL) if kv == "fp32" else dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("kind", ["quartet", "baseline", "mop", "mop_causal"])
def test_prefill_decode_step_and_chunk_equal_jax(kind, kv):
    """``prefill`` then two ``decode_step``s then a ``decode_chunk`` of three,
    the logits and the live cache rows against JAX's, and
    ``prefill_padded`` against ``prefill``."""
    tdt, jdt = KV[kv]
    jm, params, pm = lm_pair(kind, scale=2.0)
    tp = to_torch(params)
    prompt = prompt_of((2, 5), seed=9)
    toks = prompt_of((2, 5), seed=10)
    jl, jc = JG.prefill(jm, params, jnp.asarray(prompt), kv_dtype=jdt)
    pl, pc = G.prefill(pm, tp, torch.from_numpy(prompt), kv_dtype=tdt)
    assert pc["k"].dtype == tdt and pc["len"] == 5
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **_logit_tol(kv))
    _close_caches(pc, jc, 5, kv)
    padded = np.concatenate([prompt, prompt_of((2, 3), seed=11)], 1)
    ql, qc = G.prefill_padded(pm, tp, torch.from_numpy(padded), 5, kv_dtype=tdt)
    jql, jqc = JG.prefill_padded(jm, params, jnp.asarray(padded), 5, kv_dtype=jdt)
    np.testing.assert_allclose(ql.numpy(), pl.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ql.numpy(), np.asarray(jql), **_logit_tol(kv))
    _close_caches(qc, jqc, 5, kv)
    for i in range(2):
        jl, jc = JG.decode_step(jm, params, jc, jnp.asarray(toks[:, i]))
        pl, pc = G.decode_step(pm, tp, pc, torch.from_numpy(toks[:, i]).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **_logit_tol(kv))
    jl, jc = JG.decode_chunk(jm, params, jc, jnp.asarray(toks[:, 2:]))
    pl, pc = G.decode_chunk(pm, tp, pc, torch.from_numpy(toks[:, 2:]).long())
    assert tuple(pl.shape) == (2, 3, VOCAB)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **_logit_tol(kv))
    _close_caches(pc, jc, 10, kv)


@pytest.mark.parametrize("kind", ["quartet", "mop", "mop_causal"])
def test_generate_cached_equals_jax(kind):
    jm, params, pm = lm_pair(kind, scale=3.0)
    prompt = prompt_of((2, 4), seed=12)
    want = np.asarray(JG.generate_cached(jm, params, jnp.asarray(prompt), 10))
    got = G.generate_cached(pm, None, torch.from_numpy(prompt), 10)
    # each step's logits, teacher-forced on JAX's tokens, for the margins
    jl, jc = JG.prefill(jm, params, jnp.asarray(prompt))
    logits = [jl]
    for i in range(9):
        jl, jc = JG.decode_step(jm, params, jc, jnp.asarray(want[:, 4 + i]))
        logits.append(jl)
    assert_tokens_up_to_tie(got[:, 4:], want[:, 4:], margin(np.stack(logits, 1)))


def test_generate_cached_with_penalties_equals_jax():
    jm, params, pm = lm_pair("quartet", scale=3.0)
    prompt = prompt_of((2, 4), seed=13)
    kw = dict(repetition_penalty=1.5, presence_penalty=0.8, frequency_penalty=0.4)
    want = np.asarray(JG.generate_cached(jm, params, jnp.asarray(prompt), 10, **kw))
    got = G.generate_cached(pm, G.decode_params(pm), torch.from_numpy(prompt), 10, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = G.generate_cached(pm, None, torch.from_numpy(prompt), 10)
    assert not torch.equal(got, plain)  # the penalties changed the stream


@pytest.mark.parametrize("kind", ["quartet", "baseline", "mop_causal"])
@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_grow_window_is_bit_equal_to_the_single_window(kind, kv):
    """Block 160: the window starts at 64, grows to 128 and 160. Greedy and
    sampled (the same generator seed), bit-equal."""
    _, _, pm = lm_pair(kind, scale=3.0, block_size=160)
    prompt = torch.from_numpy(prompt_of((2, 10), seed=14))
    tdt = KV[kv][0]
    base = G.generate_cached(pm, None, prompt, 140, kv_dtype=tdt)
    grow = G.generate_cached(pm, None, prompt, 140, kv_dtype=tdt, grow_window=True)
    torch.testing.assert_close(grow, base, rtol=0, atol=0)
    kw = dict(temperature=0.8, top_k=20, top_p=0.95, repetition_penalty=1.2)
    runs = [G.generate_cached(pm, None, prompt, 140, kv_dtype=tdt, grow_window=g,
                              generator=torch.Generator().manual_seed(4), **kw)
            for g in (False, True)]
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)


def test_generate_cached_rejects_overflow_and_keeps_the_first_token():
    """The window's bound, and with a prompt that fills the block but one,
    the cached first token is the full window's (the same statistics)."""
    _, _, pm = lm_pair("quartet", scale=3.0)
    with pytest.raises(ValueError, match="block_size"):
        G.generate_cached(pm, None, torch.zeros(1, 10, dtype=torch.long), 7)
    prompt = torch.from_numpy(prompt_of((2, 16), seed=15))
    full = G.generate(pm, prompt, 1)
    logits, _ = G.prefill(pm, None, prompt)
    torch.testing.assert_close(logits.argmax(-1), full[:, -1], rtol=0, atol=0)


def test_init_decode_cache_layout():
    cfg = lm_pair("mop")[2].config
    c = G.init_decode_cache(cfg, 3, torch.int8, n_views=2, device="cpu")
    j = JG.init_decode_cache(cfg, 3, jnp.int8, n_views=2)
    assert sorted(c) == sorted(j) and c["len"] == 0
    for k in j:
        if k != "len":
            assert tuple(c[k].shape) == j[k].shape and str(c[k].dtype).split(".")[-1] == \
                str(j[k].dtype), k
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(j[k]))
    if not torch.cuda.is_available():  # on the GPU unless a device is given
        with pytest.raises(RuntimeError, match="device='cpu'"):
            G.init_decode_cache(cfg, 1)
