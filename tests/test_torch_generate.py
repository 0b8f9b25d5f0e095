"""GPT decoding in the port against the JAX package (``mop_tpu.models.generate``):
``decode_params`` as the JAX tree; the sampler's transforms exactly and its
draws given JAX's Gumbel noise; ``_standardize_rows``; the exact
full-window ``generate`` (tokens and each step's logits, K5's plain version
once per layer per token) for the Quartet LM and both GPT-MoP variants. The
KV-cached decoder's tests are in ``test_torch_generate_cache.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode_common import (ATOL, RTOL, VOCAB, _one_torch_thread,  # noqa: F401
                                  assert_tokens_up_to_tie, lm_pair, margin, prompt_of)
from mop_tpu_torch.ops import fused as F

# The modules: each package's ``generate`` attribute is the sampler itself.
JG = importlib.import_module("mop_tpu.models.generate")
G = importlib.import_module("mop_tpu_torch.models.generate")


def _logits(b=3, v=VOCAB, seed=0):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32) * 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ------------------------------ the tree ------------------------------


@pytest.mark.parametrize("kind", ["quartet", "baseline", "mop", "mop_causal"])
def test_decode_params_is_the_jax_tree(kind):
    _, params, pm = lm_pair(kind)
    got, want = _flat(G.decode_params(pm)), _flat(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------ the sampler ------------------------------


@pytest.mark.parametrize("top_p", [0.05, 0.5, 0.9])
def test_top_p_mask_equals_jax(top_p):
    x = _logits()
    np.testing.assert_array_equal(G._top_p_mask(torch.from_numpy(x), top_p).numpy(),
                                  np.asarray(JG._top_p_mask(jnp.asarray(x), top_p)))


@pytest.mark.parametrize("min_p", [0.01, 0.3])
def test_min_p_mask_equals_jax(min_p):
    x = _logits(seed=1)
    np.testing.assert_array_equal(G._min_p_mask(torch.from_numpy(x), min_p).numpy(),
                                  np.asarray(JG._min_p_mask(jnp.asarray(x), min_p)))


@pytest.mark.parametrize("rep,pres,freq", [(1.3, None, None), (None, 0.7, None),
                                           (None, None, 0.4), (1.2, 0.5, 0.3)])
def test_apply_penalties_equals_jax(rep, pres, freq):
    x = _logits(seed=2)
    rng = np.random.default_rng(3)
    out = rng.integers(0, 3, x.shape).astype(np.int32)
    seen = (out > 0) | (rng.random(x.shape) < 0.2)
    got = G._apply_penalties(torch.from_numpy(x), torch.from_numpy(out), torch.from_numpy(seen),
                             rep, pres, freq)
    want = JG._apply_penalties(jnp.asarray(x), jnp.asarray(out), jnp.asarray(seen), rep, pres,
                               freq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PICKS = {
    "greedy_penalties": dict(greedy=True, temperature=1.0, top_k=None, top_p=None,
                             repetition_penalty=1.3, presence_penalty=0.5),
    "temperature": dict(greedy=False, temperature=0.7, top_k=None, top_p=None),
    "top_k_ties": dict(greedy=False, temperature=1.0, top_k=5, top_p=None),
    "top_p": dict(greedy=False, temperature=0.9, top_k=None, top_p=0.8),
    "min_p": dict(greedy=False, temperature=1.0, top_k=None, top_p=None, min_p=0.1),
    "all": dict(greedy=False, temperature=0.8, top_k=20, top_p=0.9, min_p=0.05,
                repetition_penalty=1.2, presence_penalty=0.3, frequency_penalty=0.2),
}


@pytest.mark.parametrize("name", list(PICKS))
def test_pick_equals_jax_given_its_gumbel_noise(name):
    """The whole pick (penalties, then greedy or the filters and a draw) for
    20 keys: the port's filtered logits equal JAX's exactly, and the port's
    draw with the Gumbel noise of JAX's key is JAX's token."""
    opts = PICKS[name]
    x = _logits(b=4, seed=4)
    if name == "top_k_ties":
        x[:, 7] = x[:, 9] = np.sort(x, -1)[:, -5]  # the fifth value three times
    rng = np.random.default_rng(5)
    out = rng.integers(0, 2, x.shape).astype(np.int32)
    prm = rng.integers(0, 2, x.shape).astype(np.int32)
    jpick, ppick = JG._make_pick(**opts), G._make_pick(**opts)
    assert jpick.uses_counts == ppick.uses_counts
    t = {k: torch.from_numpy(a) for k, a in (("x", x), ("out", out), ("prm", prm))}
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jpick(jnp.asarray(x), key, jnp.asarray(out), jnp.asarray(prm))[0])
        if opts["greedy"]:
            np.testing.assert_array_equal(ppick(t["x"], None, t["out"], t["prm"]).numpy(), want)
            continue
        logits = t["x"]
        if ppick.uses_counts:
            logits = G._apply_penalties(logits, t["out"], (t["out"] > 0) | (t["prm"] > 0),
                                        opts.get("repetition_penalty"),
                                        opts.get("presence_penalty"),
                                        opts.get("frequency_penalty"))
        scaled = G._filter_logits(logits, opts["temperature"], opts["top_k"], opts["top_p"],
                                  opts.get("min_p"))
        gumbel = jax.random.gumbel(jax.random.split(key)[1], x.shape)
        got = G._categorical(scaled, torch.from_numpy(np.asarray(gumbel)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.all(np.isfinite(scaled.numpy()[np.arange(4), got.numpy()]))


def test_prompt_counts_equal_jax():
    p = prompt_of((3, 9))
    np.testing.assert_array_equal(G._prompt_counts(torch.from_numpy(p), VOCAB).numpy(),
                                  np.asarray(JG._prompt_counts(jnp.asarray(p), VOCAB)))


@pytest.mark.parametrize("n_valid", [1, 5, 12, "rows"], ids=str)
def test_standardize_rows_equals_jax(n_valid):
    s = np.random.default_rng(6).standard_normal((3, 2, 1, 12)).astype(np.float32)
    nv = np.array([1, 4, 12], np.int32) if n_valid == "rows" else n_valid
    got = G._standardize_rows(torch.from_numpy(s), torch.from_numpy(nv) if n_valid == "rows"
                              else nv, 1e-5)
    want = JG._standardize_rows(jnp.asarray(s), jnp.asarray(nv), 1e-5)
    cols = np.asarray(JG._cols_mask(12, jnp.asarray(nv)))
    np.testing.assert_allclose(np.where(cols, got.numpy(), 0), np.where(cols, want, 0),
                               rtol=RTOL, atol=ATOL)


# --------------------------- the full window ---------------------------


def _windows(seq, t0, n, block):
    """Each step's (window, live length) of the full-window sampler along the
    token sequence ``seq`` (B, t0 + n)."""
    out = []
    for s in range(n):
        end = t0 + s
        length = min(end, block)
        w = np.zeros((seq.shape[0], block), np.int32)
        w[:, :length] = seq[:, end - length:end]
        out.append((w, length))
    return out


@pytest.mark.parametrize("kind,t0,n", [("quartet", 4, 8), ("quartet", 5, 20), ("mop", 4, 8),
                                       ("mop_causal", 3, 6)])
def test_generate_equals_jax(kind, t0, n, monkeypatch):
    """Greedy tokens equal JAX's up to the first near tie (past the block the
    window rolls), each step's logits teacher-forced on them within the
    golden tolerance, and K5's plain version once per layer per token."""
    jm, params, pm = lm_pair(kind, scale=3.0)
    prompt = prompt_of((2, t0), seed=7)
    want = np.asarray(JG.generate(jm, params, jnp.asarray(prompt), n))
    calls = []
    k5 = F.fused_quartet_attention
    monkeypatch.setattr(F, "fused_quartet_attention",
                        lambda *a, **k: calls.append(a[0].shape) or k5(*a, **k))
    pm.train()
    got = G.generate(pm, torch.from_numpy(prompt), n)
    assert pm.training and got.dtype == torch.long and tuple(got.shape) == (2, t0 + n)
    quartet = pm.config.use_quartet and not pm.config.causal_std
    assert calls == [(2, 2, 16, 16)] * (2 * n if quartet else 0)
    block = pm.config.block_size
    steps = _windows(want, t0, n, block)
    jl = np.stack([np.asarray(jm.apply(params, jnp.asarray(w), train=False)[0])[:, ln - 1]
                   for w, ln in steps], 1)
    with torch.no_grad():
        pl = torch.stack([pm.eval()(torch.from_numpy(w).long())[0][:, ln - 1]
                          for w, ln in steps], 1)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(want[:, :t0], prompt)
    assert_tokens_up_to_tie(got[:, t0:], want[:, t0:], margin(jl))


def test_generate_sampled_is_seeded_and_in_range():
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompt = torch.from_numpy(prompt_of((2, 4), seed=8))
    kw = dict(temperature=0.9, top_k=10, top_p=0.95, repetition_penalty=1.1)
    a = G.generate(pm, prompt, 10, generator=torch.Generator().manual_seed(3), **kw)
    b = G.generate(pm, prompt, 10, generator=torch.Generator().manual_seed(3), **kw)
    greedy = G.generate(pm, prompt, 10, generator=torch.Generator().manual_seed(3),
                        temperature=0.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(((a >= 0) & (a < VOCAB)).all())
    torch.testing.assert_close(greedy, G.generate(pm, prompt, 10), rtol=0, atol=0)
