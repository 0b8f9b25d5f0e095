"""The exact full-window sampler's ``cuda_graph=True`` form on the CPU, where
no CUDA graph can be captured.

- The refusal: ``generate(..., cuda_graph=True)`` on the CPU.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): the
  device-length form (the live length a 0-dim tensor, the logits gathered at
  it, the fill or roll a one-hot select on a static window) against JAX's
  ``generate`` in greedy, for Quartet and GPT-MoP, through the fill and the
  roll, up to each row's first near tie; sampled with JAX's Gumbel noise, up
  to the first near tie of the noised, filtered logits; against the port's
  eager loop token for token, greedy and seeded sampling with penalties.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode_common import (_one_torch_thread, assert_tokens_up_to_tie,  # noqa: F401
                                  lm_pair, margin, prompt_of)

G = importlib.import_module("mop_tpu_torch.models.generate")
JG = importlib.import_module("mop_tpu.models.generate")


@pytest.fixture
def lifted(monkeypatch):
    """The graphed sampler on the CPU: ``require_graph`` accepts any device."""
    monkeypatch.setattr(G, "require_graph", lambda *a, **k: None)


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


def _jax_logits(jm, params, seq, t0, n, block):
    """JAX's logits at each step's last live position, teacher-forced on ``seq``."""
    return np.stack([np.asarray(jm.apply(params, jnp.asarray(w), train=False)[0])[:, ln - 1]
                     for w, ln in _windows(seq, t0, n, block)], 1)


def test_cuda_graph_refuses_the_cpu():
    _, _, pm = lm_pair("quartet")
    with pytest.raises(ValueError, match="generate: cuda_graph=True needs a CUDA device"):
        G.generate(pm, torch.from_numpy(prompt_of((2, 4))), 4, cuda_graph=True)


@pytest.mark.parametrize("kind,t0,n", [("quartet", 5, 20), ("mop", 4, 16)])
def test_device_length_sampler_equals_jax(kind, t0, n, lifted):
    """Block 16: the window fills, then rolls for the last steps."""
    jm, params, pm = lm_pair(kind, scale=3.0)
    prompt = prompt_of((2, t0), seed=21)
    want = np.asarray(JG.generate(jm, params, jnp.asarray(prompt), n))
    pm.train()
    got = G.generate(pm, torch.from_numpy(prompt), n, cuda_graph=True)
    assert pm.training and got.dtype == torch.long and tuple(got.shape) == (2, t0 + n)
    assert t0 + n > pm.config.block_size  # the roll is reached
    jl = _jax_logits(jm, params, want, t0, n, pm.config.block_size)
    np.testing.assert_array_equal(got[:, :t0].numpy(), prompt)
    assert_tokens_up_to_tie(got[:, t0:], want[:, t0:], margin(jl))


def test_device_length_sampling_equals_jax_given_its_noise(monkeypatch, lifted):
    """Temperature 0.8, top-k 10 and a repetition penalty from JAX's key 9:
    the port draws with the Gumbel noise of JAX's per-step subkeys; tokens
    equal up to the first near tie of the noised, filtered logits
    (teacher-forced on JAX's)."""
    jm, params, pm = lm_pair("quartet", scale=3.0)
    t0, n = 6, 14
    prompt = prompt_of((2, t0), seed=22)
    kw = dict(temperature=0.8, top_k=10, repetition_penalty=1.3)
    want = np.asarray(JG.generate(jm, params, jnp.asarray(prompt), n,
                                  rng=jax.random.PRNGKey(9), **kw))
    rng, noise = jax.random.PRNGKey(9), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (2, 40)))))
    draws = iter(noise)
    monkeypatch.setattr(G, "_gumbel", lambda shape, generator, device: next(draws))
    got = G.generate(pm, torch.from_numpy(prompt), n,
                     generator=torch.Generator().manual_seed(0), cuda_graph=True, **kw)
    jl = torch.from_numpy(_jax_logits(jm, params, want, t0, n, pm.config.block_size))
    pcounts = G._prompt_counts(torch.from_numpy(prompt).long(), 40)
    noised = []
    for i in range(n):
        out = G._prompt_counts(torch.tensor(want[:, t0:t0 + i]).long(), 40)
        logits = G._apply_penalties(jl[:, i], out, (out > 0) | (pcounts > 0), 1.3, None, None)
        noised.append((G._filter_logits(logits, 0.8, 10, None, None) + noise[i]).numpy())
    assert_tokens_up_to_tie(got[:, t0:], want[:, t0:], margin(np.stack(noised, 1)))


@pytest.mark.parametrize("kind", ["quartet", "mop", "baseline"])
def test_device_length_sampler_is_the_eager_loop(kind, lifted):
    """Greedy and seeded sampling with every filter and penalty, through the
    fill and the roll: the static form gives the eager loop's tokens."""
    _, _, pm = lm_pair(kind, scale=3.0)
    prompt = torch.from_numpy(prompt_of((3, 7), seed=23))
    sample = dict(temperature=0.7, top_k=12, top_p=0.9, min_p=0.02, repetition_penalty=1.2,
                  presence_penalty=0.3, frequency_penalty=0.2)
    for kw in ({}, dict(repetition_penalty=1.5), sample):
        runs = [G.generate(pm, prompt, 18, cuda_graph=graphed,
                           generator=torch.Generator().manual_seed(6) if kw else None, **kw)
                for graphed in (False, True)]
        torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)


def test_one_step_at_a_device_length_is_the_int_length(lifted):
    """``_window_step``'s logits gathered at a device length and its in-place
    fill, then roll, against the eager loop's slice and writes."""
    _, _, pm = lm_pair("quartet", scale=3.0)
    block = pm.config.block_size
    pick = G._make_pick(True, 1.0, None, None)
    with torch.no_grad():
        for length in (5, block):
            window = torch.from_numpy(prompt_of((2, block), seed=24)).long()
            window[:, length:] = 0
            want_tok = pm.eval()(window)[0][:, length - 1].argmax(-1)
            want = window.roll(-1, 1) if length == block else window.clone()
            want[:, min(length, block - 1)] = want_tok
            lens = torch.tensor(length)
            tok = G._window_step(pm, window, lens, pick, None, None, None)
            torch.testing.assert_close(tok, want_tok, rtol=0, atol=0)
            torch.testing.assert_close(window, want, rtol=0, atol=0)
            assert int(lens) == min(length + 1, block)
