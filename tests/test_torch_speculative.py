"""Speculative decoding in the port against the JAX package
(``mop_tpu.models.speculative``): ``decode_chunk`` equal to sequential
``decode_step``s within ``tests/test_speculative.py``'s tolerance (logits
and cache rows, fp32 and int8 KV, Quartet, baseline and causal GPT-MoP; on
the CPU neither package is bit-exact, a one-row product taking another
summation order than a G-row one); greedy ``speculative_generate`` equal
to ``generate_cached`` for any draft and to JAX's, a perfect draft accepting
everything; ``verify_sampled`` equal to JAX's given JAX's draws, its
marginal the target's; the sampled mode seeded, within top-k, and
accepting everything when the draft is the target; the argument checks."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models.speculative as JS
from _torch_decode_common import _one_torch_thread, lm_pair, prompt_of  # noqa: F401
from mop_tpu_torch.models import speculative as S

G = importlib.import_module("mop_tpu_torch.models.generate")


def _clone(cache):
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["fp32", "int8"])
@pytest.mark.parametrize("kind", ["quartet", "baseline", "mop_causal"])
def test_decode_chunk_equals_sequential_steps(kind, kv):
    _, _, pm = lm_pair(kind, scale=2.0, block_size=32)
    _, cache = G.prefill(pm, None, torch.from_numpy(prompt_of((2, 5), seed=30)), kv_dtype=kv)
    toks = torch.from_numpy(prompt_of((2, 4), seed=31)).long()
    seq_cache, seq = _clone(cache), []
    for i in range(4):
        lg, seq_cache = G.decode_step(pm, None, seq_cache, toks[:, i])
        seq.append(lg)
    chunk, chunk_cache = G.decode_chunk(pm, None, _clone(cache), toks)
    torch.testing.assert_close(chunk, torch.stack(seq, 1), rtol=1e-5, atol=1e-5)
    assert chunk_cache["len"] == seq_cache["len"] == 9
    for k in seq_cache:
        if k != "len":
            torch.testing.assert_close(chunk_cache[k].float(), seq_cache[k].float(), rtol=1e-5,
                                       atol=1e-6)


def _pair(block=64):
    target = lm_pair("quartet", seed=1, scale=3.0, n_layer=3, block_size=block)
    draft = lm_pair("quartet", seed=7, scale=3.0, n_layer=1, n_embd=16, block_size=block)
    return target, draft


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["fp32", "int8"])
def test_greedy_equals_generate_cached_and_jax(kv):
    """A random one-layer draft cannot change the three-layer target's greedy
    tokens, at any gamma; the tokens equal JAX's speculative decode's."""
    (jt, tparams, pt), (jd, dparams, pd) = _pair()
    prompt = prompt_of((1, 6), seed=32)
    ref = G.generate_cached(pt, None, torch.from_numpy(prompt), 17, kv_dtype=kv)
    for gamma in (1, 3, 5):
        out, stats = S.speculative_generate(pt, None, pd, None, torch.from_numpy(prompt), 17,
                                            gamma=gamma, return_stats=True, kv_dtype=kv)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        assert stats["rounds"] >= 1 and 0 <= stats["accepted"] <= stats["drafted"]
        assert stats["drafted"] == stats["rounds"] * gamma
    want = JS.speculative_generate(jt, tparams, jd, dparams, jnp.asarray(prompt), 17, gamma=3,
                                   kv_dtype=jnp.int8 if kv == torch.int8 else jnp.float32)
    np.testing.assert_array_equal(ref.numpy(), np.asarray(want))


def test_perfect_draft_accepts_everything():
    (_, _, pt), _ = _pair()
    prompt = torch.zeros(1, 4, dtype=torch.long)
    out, stats = S.speculative_generate(pt, None, pt, None, prompt, 12, gamma=3,
                                        return_stats=True)
    torch.testing.assert_close(out, G.generate_cached(pt, None, prompt, 12), rtol=0, atol=0)
    assert stats["accepted"] == stats["drafted"] and stats["rounds"] == -(-12 // 4)


@pytest.mark.parametrize("g,seed", [(1, 0), (3, 1), (4, 2), (4, 3)])
def test_verify_sampled_equals_jax_given_its_draws(g, seed):
    """p_all, q and d drawn so that some drafts are accepted and some not;
    for 30 keys, the port's accept count and correction with JAX's uniforms
    and Gumbel noise equal JAX's."""
    rng = np.random.default_rng(seed)
    v = 9
    p_all = rng.dirichlet(np.ones(v) * 0.5, g + 1).astype(np.float32)
    q = rng.dirichlet(np.ones(v) * 0.5, g).astype(np.float32)
    if g > 1:  # one position where p == q on the support
        q[1] = p_all[1]
    d = rng.integers(0, v, g).astype(np.int32)
    t = [torch.from_numpy(a) for a in (p_all, q, d)]
    counts = set()
    for k in range(30):
        key = jax.random.PRNGKey(100 * seed + k)
        n_acc, corr = JS.verify_sampled(key, jnp.asarray(p_all), jnp.asarray(q), jnp.asarray(d))
        ku, kc = jax.random.split(key)
        u = torch.from_numpy(np.asarray(jax.random.uniform(ku, (g,))))
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(kc, (v,))))
        got_n, got_c = S._verify_given(u, gumbel, t[0], t[1], t[2].long())
        assert (got_n, int(got_c)) == (int(n_acc), int(corr))
        counts.add(got_n)
    assert len(counts) > 1


def test_verify_sampled_marginal_is_the_target():
    """Whatever q is, the emitted token is distributed as p (gamma 1, 20,000
    draws from one generator)."""
    p = torch.tensor([0.45, 0.25, 0.15, 0.10, 0.05])
    q = torch.tensor([0.10, 0.50, 0.20, 0.10, 0.10])
    gen = torch.Generator().manual_seed(0)
    toks = []
    for _ in range(20000):
        d = torch.multinomial(q, 1, generator=gen)
        n_acc, corr = S.verify_sampled(gen, torch.stack([p, p]), q[None], d)
        toks.append(int(d[0]) if n_acc >= 1 else int(corr))
    emp = np.bincount(toks, minlength=5) / len(toks)
    assert 0.5 * np.abs(emp - p.numpy()).sum() < 0.02


def test_sampled_mode():
    (_, _, pt), (_, _, pd) = _pair()
    prompt = torch.zeros(1, 4, dtype=torch.long)
    kw = dict(temperature=0.9, return_stats=True)
    out, stats = S.speculative_generate(pt, None, pt, None, prompt, 12, gamma=3,
                                        generator=torch.Generator().manual_seed(5), **kw)
    assert tuple(out.shape) == (1, 16) and stats["accepted"] == stats["drafted"]
    runs = [S.speculative_generate(pt, None, pd, None, prompt, 10, gamma=2, top_k=5,
                                   generator=torch.Generator().manual_seed(1), temperature=0.8)
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert bool(((runs[0] >= 0) & (runs[0] < pt.wte.num_embeddings)).all())


def test_speculative_checks_its_arguments():
    (_, _, pt), (_, _, pd) = _pair(block=16)
    with pytest.raises(ValueError, match="batch 1"):
        S.speculative_generate(pt, None, pd, None, torch.zeros(2, 4, dtype=torch.long), 4)
    with pytest.raises(ValueError, match="block_size"):
        S.speculative_generate(pt, None, pd, None, torch.zeros(1, 4, dtype=torch.long), 10,
                               gamma=4)
    with pytest.raises(ValueError, match="gamma"):
        S.speculative_generate(pt, None, pd, None, torch.zeros(1, 4, dtype=torch.long), 4,
                               gamma=0)
