"""The decoders' ``cuda_graph=True`` form on the CPU, where no CUDA graph can
be captured.

- The refusals: ``generate_cached`` and ``DecodeEngine`` on the CPU, an
  engine subclass.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes):
  ``generate_cached``'s device-length form (the shared length a 0-dim
  tensor in a buffer, one step graph per window width) against JAX's
  ``generate_cached``, greedy and sampled with JAX's Gumbel noise, up to each
  row's first near tie; against the port's eager loop, token for token,
  greedy and seeded sampling, fp32 and int8 KV, single and growing window;
  one step's logits at a device length against an int one.
- The dense engine's static-lens step against JAX's ``DecodeEngine`` up to
  the first near tie, and against the eager engine token for token with
  per-row LoRA adapters and sampled rows.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine
from mop_tpu_torch.serving import engine as E
from mop_tpu_torch.training import lora as PL

from _torch_decode_common import (_one_torch_thread, assert_tokens_up_to_tie,  # noqa: F401
                                  lm_pair, margin, prompt_of)
from _torch_serving_common import assert_stream, cached_ref, prompts_of

G = importlib.import_module("mop_tpu_torch.models.generate")
JG = importlib.import_module("mop_tpu.models.generate")


@pytest.fixture
def lifted(monkeypatch):
    """The graphed decoders on the CPU: ``require_graph`` accepts any device."""
    for mod in (G, E):
        monkeypatch.setattr(mod, "require_graph", lambda *a, **k: None)


def test_cuda_graph_refuses_the_cpu():
    _, _, pm = lm_pair("quartet")
    prompt = torch.from_numpy(prompt_of((2, 4)))
    with pytest.raises(ValueError, match="generate_cached: cuda_graph=True needs a CUDA"):
        G.generate_cached(pm, None, prompt, 4, cuda_graph=True)
    with pytest.raises(ValueError, match="DecodeEngine: cuda_graph=True needs a CUDA"):
        DecodeEngine(pm, None, max_batch=2, cuda_graph=True)

    class Sub(DecodeEngine):
        pass

    with pytest.raises(ValueError, match="dense DecodeEngine's"):
        Sub(pm, None, max_batch=2, cuda_graph=True)


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_device_length_decode_equals_jax(kind, lifted):
    jm, params, pm = lm_pair(kind, scale=3.0)
    prompt = prompt_of((2, 4), seed=12)
    want = np.asarray(JG.generate_cached(jm, params, jnp.asarray(prompt), 10))
    got = G.generate_cached(pm, None, torch.from_numpy(prompt), 10, cuda_graph=True)
    jl, jc = JG.prefill(jm, params, jnp.asarray(prompt))
    logits = [jl]
    for i in range(9):
        jl, jc = JG.decode_step(jm, params, jc, jnp.asarray(want[:, 4 + i]))
        logits.append(jl)
    assert_tokens_up_to_tie(got[:, 4:], want[:, 4:], margin(np.stack(logits, 1)))


def test_device_length_sampling_equals_jax_given_its_noise(monkeypatch, lifted):
    """Temperature 0.8 and top-k 10 from JAX's key 7: the port draws with
    the Gumbel noise of JAX's per-step subkeys; tokens equal up to the first
    near tie of the noised, filtered logits (teacher-forced on JAX's)."""
    jm, params, pm = lm_pair("quartet", scale=3.0)
    prompt = prompt_of((2, 4), seed=16)
    n, kw = 10, dict(temperature=0.8, top_k=10)
    want = np.asarray(JG.generate_cached(jm, params, jnp.asarray(prompt), n,
                                         rng=jax.random.PRNGKey(7), **kw))
    rng, noise = jax.random.PRNGKey(7), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (2, 40)))))
    draws = iter(noise)
    monkeypatch.setattr(G, "_gumbel", lambda shape, generator, device: next(draws))
    got = G.generate_cached(pm, None, torch.from_numpy(prompt), n,
                            generator=torch.Generator().manual_seed(0), cuda_graph=True, **kw)
    jl, jc = JG.prefill(jm, params, jnp.asarray(prompt))
    noised = []
    for i in range(n):
        scaled = G._filter_logits(torch.from_numpy(np.array(jl)), kw["temperature"],
                                  kw["top_k"], None, None)
        noised.append((scaled + noise[i]).numpy())
        if i < n - 1:
            jl, jc = JG.decode_step(jm, params, jc, jnp.asarray(want[:, 4 + i]))
    assert_tokens_up_to_tie(got[:, 4:], want[:, 4:], margin(np.stack(noised, 1)))


@pytest.mark.parametrize("kind", ["quartet", "baseline", "mop_causal"])
@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_device_length_decode_is_the_eager_loop(kind, kv, lifted):
    """Block 96 (the growing window 64 -> 96): greedy and seeded sampling
    give the eager loop's tokens, single window and growing."""
    _, _, pm = lm_pair(kind, scale=3.0, block_size=96)
    prompt = torch.from_numpy(prompt_of((2, 10), seed=14))
    kv_dtype = torch.float32 if kv == "fp32" else torch.int8
    sample = dict(temperature=0.8, top_k=20, top_p=0.95, repetition_penalty=1.2)
    for grow in (False, True):
        for kw in ({}, sample):
            runs = [G.generate_cached(pm, None, prompt, 80, kv_dtype=kv_dtype,
                                      grow_window=grow, cuda_graph=graphed,
                                      generator=torch.Generator().manual_seed(4) if kw else None,
                                      **kw)
                    for graphed in (False, True)]
            torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)


def test_one_step_at_a_device_length_is_the_int_length():
    _, _, pm = lm_pair("mop", scale=3.0)
    prompt = torch.from_numpy(prompt_of((2, 6), seed=17))
    tok = torch.tensor([3, 5])
    out = []
    for lens in (6, torch.tensor(6)):
        _, cache = G.prefill(pm, None, prompt)
        logits, cache = G.decode_step_rows(pm, None, cache, tok, lens)
        out.append((logits, {k: v for k, v in cache.items() if k != "len"}))
        assert int(cache["len"]) == 7
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    for k in ("k", "k2", "v"):  # rows from before the attention: bit-equal copies
        torch.testing.assert_close(out[1][1][k], out[0][1][k], rtol=0, atol=0)
    # the view rows follow the attention, whose standardization multiplies by
    # the reciprocal at a device length (CUDA's division by a host number)
    torch.testing.assert_close(out[1][1]["mv"], out[0][1]["mv"], rtol=1e-6, atol=1e-6)


def _run(eng, prompts, budgets, **kw):
    rids = [eng.submit(p, n, **kw) for p, n in zip(prompts, budgets)]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("kind", ["mop"])
def test_static_lens_engine_equals_jax(kind, lifted):
    jm, jp, pm = lm_pair(kind, scale=3.0)
    prompts = prompts_of([3, 5, 9, 12, 2], seed=31)
    budgets = [4, 6, 3, 4, 8]
    want = _run(JaxEngine(jm, jp, max_batch=3, prefill_buckets=[16]), prompts, budgets)
    eng = DecodeEngine(pm, None, max_batch=3, cuda_graph=True)
    got = _run(eng, prompts, budgets)
    assert eng._graph is not None and eng._graph.calls > 2
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")


def test_static_lens_engine_is_the_eager_engine_with_lora_and_sampling(lifted):
    """Two LoRA adapters and the base model in one pool, sampled rows
    among greedy ones: the static-lens step gives the eager engine's tokens."""
    _, _, pm = lm_pair("quartet", scale=3.0)
    params = G.decode_params(pm)
    adapters = {}
    for j, name in enumerate(("x", "y")):
        ad = PL.lora_init(torch.Generator().manual_seed(j), params, rank=2)
        g = torch.Generator().manual_seed(10 + j)
        adapters[name] = {p: {"a": f["a"] * 10.0, "b": torch.randn(f["b"].shape, generator=g)
                              * 0.3} for p, f in ad.items()}
    prompts = prompts_of([3, 5, 7, 4, 6, 2], seed=32)
    budgets = [5, 4, 6, 3, 5, 7]
    got = []
    for graphed in (False, True):
        eng = DecodeEngine(pm, params, max_batch=3, adapters=adapters, cuda_graph=graphed,
                           generator=torch.Generator().manual_seed(5))
        rids = [eng.submit(p, n, adapter=(None, "x", "y")[i % 3],
                           temperature=0.7 if i % 2 else None)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        res = eng.run()
        got.append([res[r] for r in rids])
    assert got[1] == got[0]
