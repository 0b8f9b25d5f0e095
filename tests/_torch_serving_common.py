"""Shared set-up of the serving tests (``tests/test_torch_serving_*.py``):
the decode tests' GPT pair (``_torch_decode_common``: 2 layers, 2 heads,
width 32, block 16, vocab 40, the JAX init loaded into the port), the
port's single-stream references, and the stream comparison up to the first
near tie."""

import importlib

import numpy as np
import torch

from _torch_decode_common import (ATOL, RTOL, TIE, VOCAB, _one_torch_thread,  # noqa: F401
                                  lm_pair, margin, prompt_of, to_torch)

G = importlib.import_module("mop_tpu_torch.models.generate")


def prompts_of(lengths, seed=0, vocab=VOCAB):
    """One prompt per length, each from its own numpy seed."""
    return [prompt_of((n,), seed=seed + i, vocab=vocab).tolist() for i, n in enumerate(lengths)]


def cached_ref(pm, params, prompt, n, kv_dtype=torch.float32):
    """The port's single-stream greedy ``generate_cached`` tokens (a list)
    and each step's top-two logit margin, teacher-forced on those tokens."""
    p = torch.tensor([prompt])
    toks = G.generate_cached(pm, params, p, n, kv_dtype=kv_dtype)[0, len(prompt):].tolist()
    logits, cache = G.prefill(pm, params, p, kv_dtype=kv_dtype)
    margins = [float(margin(logits.numpy())[0])]
    for t in toks[:-1]:
        logits, cache = G.decode_step(pm, params, cache, torch.tensor([t]))
        margins.append(float(margin(logits.numpy())[0]))
    return toks, margins


def _greedy_from(pm, params, logits, cache, n):
    toks, margins = [], []
    for _ in range(n):
        margins.append(float(margin(logits.numpy())[0]))
        toks.append(int(logits.argmax(-1)))
        if len(toks) < n:
            logits, cache = G.decode_step(pm, params, cache, torch.tensor([toks[-1]]))
    return toks, margins


def chunked_ref(pm, params, prompt, n, chunk, base=None):
    """The single-stream greedy tokens (and margins) of a prompt fed through
    ``decode_chunk`` ``chunk`` tokens at a time from an empty cache: the
    engine's chunked prefill. With ``base = (rows, lcp)`` (a prefix-cache
    entry's one-slot rows), the cache starts from those rows at length
    ``lcp`` and the rest is one chunk: the engine's prefix-cache hit. A fed
    row standardizes over its live prefix where a prefill standardizes over
    the whole prompt, so these paths are held to these references."""
    params = G.decode_params(pm) if params is None else params
    cache = G.init_decode_cache(pm.config, 1, n_views=G.model_n_views(pm), device="cpu")
    at = 0
    if base is not None:
        for key, rows in base[0].items():
            cache[key] = rows[:, None].clone()
        at, chunk = base[1], len(prompt)
    cache["len"] = at
    while at < len(prompt):
        g = min(chunk, len(prompt) - at)
        logits, cache = G.decode_chunk(pm, params, cache, torch.tensor([prompt[at:at + g]]))
        at += g
    return _greedy_from(pm, params, logits[:, -1], cache, n)


def shared_prefix_prompts(n_system, tail_lengths, seed=0, vocab=VOCAB):
    """A system prompt of ``n_system`` tokens followed by one tail per
    length, the tails' first tokens all different: any two prompts share
    exactly the system prompt, so a prefix-cache hit reuses ``n_system``
    rows whichever entry it finds."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, n_system).tolist()
    firsts = rng.choice(vocab, len(tail_lengths), replace=False).tolist()
    return [system + [firsts[i]] + rng.integers(0, vocab, n - 1).tolist()
            for i, n in enumerate(tail_lengths)]


def prefill_rows(pm, params, prompt, lcp):
    """``(rows, lcp)``: a fresh single-stream prefill's one-slot rows of
    ``prompt`` (K/K2/V, GPT-MoP's ``mv``), for ``chunked_ref``'s ``base``.
    Every prefix-cache entry of a run that opens with ``prompt`` holds these
    rows below ``lcp``: the first entry is that prefill, and each later one
    copies its shared rows from an earlier entry."""
    _, cache = G.prefill(pm, params, torch.tensor([prompt]))
    return {k: cache[k][:, 0] for k in ("k", "k2", "v", "mv") if k in cache}, lcp


def assert_stream(got, want, margins, name=""):
    """``got`` equals ``want`` up to the first step whose top-two margin is
    below ``TIE`` (and the whole stream when there is none), and holds at
    least one step before any tie."""
    ties = [i for i, m in enumerate(margins) if m < TIE]
    stop = ties[0] if ties else len(want)
    assert stop > 0, f"{name}: a near tie at the first step"
    assert list(got[:stop]) == list(want[:stop]), f"{name}: {got} vs {want}"
    if not ties:
        assert len(got) == len(want), f"{name}: {got} vs {want}"
