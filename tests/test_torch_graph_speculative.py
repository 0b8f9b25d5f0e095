"""Speculative decoding's ``cuda_graph=True`` form on the CPU, where no CUDA
graph can be captured.

- The refusals: the CPU, a tensor-parallel target or draft.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): a round at
  device lengths, the extra draft step every round and the emitted tokens
  written at a device offset, against the eager loop token for token with
  equal ``rounds`` / ``drafted`` / ``accepted`` (greedy at gamma 1, 3 and
  5 with a distinct draft and the target as its own draft, fp32 and int8
  KV, causal GPT-MoP; sampled from one seeded generator); greedy against
  JAX's ``speculative_generate`` up to the first near tie of
  ``generate_cached``'s margins; sampled against JAX's given JAX's draws.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models.speculative as JS
from _torch_decode_common import (_one_torch_thread, assert_tokens_up_to_tie,  # noqa: F401
                                  lift_graphs, lm_pair, margin, prompt_of)
from mop_tpu_torch.models import speculative as S

G = importlib.import_module("mop_tpu_torch.models.generate")


@pytest.fixture
def lifted(monkeypatch):
    """The graphed rounds on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, S)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


@pytest.fixture(scope="module")
def pair():
    """(target, draft) as JAX / port pairs: a 3-layer Quartet LM and a
    1-layer, 16-wide one, block 64."""
    return (lm_pair("quartet", seed=1, scale=3.0, n_layer=3, block_size=64),
            lm_pair("quartet", seed=7, scale=3.0, n_layer=1, n_embd=16, block_size=64))


def _both(target, draft, prompt, n, **kw):
    """The eager loop's and the graphed rounds' (tokens, stats)."""
    return [S.speculative_generate(target, None, draft, None, prompt, n, return_stats=True,
                                   cuda_graph=graphed, **kw) for graphed in (False, True)]


def test_cuda_graph_refuses_the_cpu_and_tensor_parallel(pair, monkeypatch):
    (_, _, pt), (_, _, pd) = pair
    prompt = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match=r"speculative_generate \(target\): cuda_graph=True "
                                         "needs a CUDA"):
        S.speculative_generate(pt, None, pd, None, prompt, 4, cuda_graph=True)
    monkeypatch.setattr(S, "decode_split_of",
                        lambda m: SimpleNamespace(n_head=1) if m is pt else None)
    with pytest.raises(ValueError, match=r"speculative_generate \(target\): cuda_graph=True does "
                                         "not take a tensor-parallel model"):
        S.speculative_generate(pt, None, pd, None, prompt, 4, cuda_graph=True)


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["fp32", "int8"])
def test_graphed_greedy_is_the_eager_loop(pair, kv, lifted):
    (_, _, pt), (_, _, pd) = pair
    prompt = torch.from_numpy(prompt_of((1, 6), seed=50))
    for gamma in (1, 3, 5):
        (want, ws), (got, gs) = _both(pt, pd, prompt, 17, gamma=gamma, kv_dtype=kv)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert gs == ws and gs["drafted"] == gs["rounds"] * gamma
    # the target as its own draft accepts every draft: rounds of gamma + 1
    (want, ws), (got, gs) = _both(pt, pt, prompt, 17, gamma=3, kv_dtype=kv)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert gs == ws and gs["accepted"] == gs["drafted"] and gs["rounds"] == -(-(17 - 1) // 4)


def test_graphed_greedy_mop_causal_is_the_eager_loop(lifted):
    _, _, pt = lm_pair("mop_causal", seed=1, scale=3.0, block_size=64)
    prompt = torch.from_numpy(prompt_of((1, 5), seed=51))
    for draft in (pt, lm_pair("quartet", seed=7, scale=3.0, n_layer=1, n_embd=16,
                              block_size=64)[2]):
        (want, ws), (got, gs) = _both(pt, draft, prompt, 12, gamma=2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert gs == ws


def test_graphed_sampled_is_the_eager_loop(pair, lifted):
    """Temperature 0.8, top-k 10, one seeded generator: the same draws in the
    same order, so the same tokens and acceptance; the target as its own
    draft accepts everything."""
    (_, _, pt), (_, _, pd) = pair
    prompt = torch.from_numpy(prompt_of((1, 6), seed=52))
    kw = dict(temperature=0.8, top_k=10)
    for draft, gamma in ((pd, 3), (pd, 1), (pt, 3)):
        (want, ws), (got, gs) = [
            S.speculative_generate(pt, None, draft, None, prompt, 17, gamma=gamma,
                                   generator=torch.Generator().manual_seed(9), cuda_graph=g,
                                   return_stats=True, **kw) for g in (False, True)]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert gs == ws
    assert gs["accepted"] == gs["drafted"]


def test_graphed_greedy_equals_jax(pair, lifted):
    (jt, tparams, pt), (jd, dparams, pd) = pair
    prompt = prompt_of((1, 6), seed=53)
    want = np.asarray(JS.speculative_generate(jt, tparams, jd, dparams, jnp.asarray(prompt), 17,
                                              gamma=3))
    got = S.speculative_generate(pt, None, pd, None, torch.from_numpy(prompt), 17, gamma=3,
                                 cuda_graph=True)
    # the margins of the greedy tokens JAX emitted, teacher-forced on them
    logits, cache = G.prefill(pt, None, torch.from_numpy(prompt))
    margins = [margin(logits.numpy())]
    for t in want[0, 6:-1]:
        logits, cache = G.decode_step(pt, None, cache, torch.tensor([int(t)]))
        margins.append(margin(logits.numpy()))
    assert_tokens_up_to_tie(got[:, 6:], want[:, 6:], np.stack(margins, 1))


def test_graphed_sampled_equals_jax_given_its_draws(pair, monkeypatch, lifted):
    """JAX's draws replayed in the port's order (the first token's Gumbel
    noise; a round's draft noise, its verify's uniforms and noise): the
    graphed rounds emit JAX's sampled tokens."""
    (jt, tparams, pt), (jd, dparams, pd) = pair
    prompt = prompt_of((1, 6), seed=54)
    n, gamma, v = 14, 3, 40
    kw = dict(temperature=0.8, top_k=10)
    key = jax.random.PRNGKey(11)
    want = np.asarray(JS.speculative_generate(jt, tparams, jd, dparams, jnp.asarray(prompt), n,
                                              gamma=gamma, rng=key, **kw))
    key, k0 = jax.random.split(key)
    gumbels, uniforms = [np.array(jax.random.gumbel(k0, (1, v)))], []
    for _ in range(n):  # at least one token a round
        key, kd, kv = jax.random.split(key, 3)
        for _ in range(gamma):
            kd, k1 = jax.random.split(kd)
            gumbels.append(np.array(jax.random.gumbel(k1, (1, v))))
        ku, kc = jax.random.split(kv)
        uniforms.append(np.array(jax.random.uniform(ku, (gamma,))))
        gumbels.append(np.array(jax.random.gumbel(kc, (v,))))
    # made here: a body that made them from host data would be flagged
    draws = iter([torch.from_numpy(a) for a in gumbels])
    us = iter([torch.from_numpy(a) for a in uniforms])
    monkeypatch.setattr(S, "_gumbel", lambda shape, gen, dev: next(draws))
    monkeypatch.setattr(S, "_uniform", lambda k, gen, dev: next(us))
    got = S.speculative_generate(pt, None, pd, None, torch.from_numpy(prompt), n, gamma=gamma,
                                 generator=torch.Generator().manual_seed(0), cuda_graph=True,
                                 **kw)
    np.testing.assert_array_equal(got.numpy(), want)
