"""The dense engine's bucketed admission as one replay (``_admit_rows``:
the prefill to the bucket, the paste into the slot a device index names,
the length, the first pick, its logprobs and the slot's token, counts and
prompt mask), on the CPU, where no CUDA graph can be captured. With
``require_graph`` lifted (``StepGraph`` then runs its body eagerly over the
same buffers, the form a replay computes; no host read in it):

- ``prefill_padded`` with a device ``t0`` (the bucket graph's form: the
  masked statistics whatever ``t0``) against JAX's at ``t0 < T`` and
  ``t0 = T``, for the Quartet LM, the baseline and GPT-MoP (its ``mv``
  rows);
- the graphed engine against the eager one call by call and bit for bit
  (tokens, logprob entries, the generator's state, every pool, lengths,
  output counts, prompt masks, tokens) over greedy, seeded, unseeded,
  LoRA, int8 KV and ``logprobs_topk`` traffic; one graph call an
  admission, keyed (bucket, picker form);
- the deviations: a prompt past the last bucket, an engine without
  buckets and a beam request make no graph call;
- the graphed engine's greedy tokens against JAX's bucketed engine up to
  each row's first near tie.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine
from mop_tpu_torch.serving import engine as E

from _torch_admission_common import (assert_one_call_each, expected_form, lifted,  # noqa: F401
                                     lockstep)
from _torch_decode_common import ATOL, RTOL, to_torch
from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of)
from test_torch_graph_engines_picker import _adapters

JG = importlib.import_module("mop_tpu.models.generate")
G = importlib.import_module("mop_tpu_torch.models.generate")

BUCKETS = [8, 16]
LENGTHS = [5, 9, 3, 12, 7]  # buckets 8, 16, 8, 16, 8

# each mix: the engine's options and the requests' (budget, options)
MIXES = {
    "greedy": ({}, [(6, {}), (5, {}), (7, {}), (4, {}), (6, {})]),
    "seeded": ({}, [(6, dict(temperature=1.0, top_k=20, seed=5)), (5, {}),
                    (7, dict(temperature=0.9, seed=6, repetition_penalty=1.4)), (4, {}),
                    (6, dict(temperature=1.1, seed=7, min_p=0.05))]),
    "unseeded": (dict(eos_id=0), [(6, dict(temperature=0.8, top_k=12)), (5, {}),
                                  (7, dict(temperature=1.2, top_p=0.9, logit_bias={3: 2.0})),
                                  (4, dict(temperature=0.7, frequency_penalty=0.5)), (6, {})]),
    "lora": ("adapters", [(6, dict(adapter="x", temperature=0.9)), (5, dict(adapter="y")),
                          (7, {}), (4, dict(adapter="x", seed=3, temperature=1.0)),
                          (6, dict(adapter="y"))]),
    "int8": (dict(kv_dtype=torch.int8), [(6, {}), (5, dict(temperature=0.9, seed=2)), (7, {}),
                                         (4, {}), (6, dict(presence_penalty=0.6))]),
    "logprobs": (dict(logprobs_topk=3), [(6, dict(temperature=0.9)), (5, {}),
                                         (7, dict(temperature=1.0, seed=8)), (4, {}), (6, {})]),
}


@pytest.fixture(scope="module")
def quartet():
    return lm_pair("quartet", scale=3.0)


@pytest.mark.parametrize("t0", [5, 8])
@pytest.mark.parametrize("kind", ["quartet", "baseline", "mop"])
def test_prefill_padded_device_t0_equals_jax(kind, t0):
    """One body for every ``t0`` of a bucket of 8: the logits and the first
    ``t0`` cache rows (K/K2/V, GPT-MoP's view history) within rtol 2e-4 /
    atol 2e-5 of JAX's ``prefill_padded``, the length the device scalar."""
    jm, params, pm = lm_pair(kind, scale=2.0)
    padded = np.random.default_rng(12).integers(0, 40, (1, 8)).astype(np.int32)
    jl, jc = JG.prefill_padded(jm, params, jnp.asarray(padded), t0)
    t0_dev = torch.tensor(t0)
    pl, pc = G.prefill_padded(pm, to_torch(params), torch.from_numpy(padded).long(), t0_dev)
    assert pc["len"] is t0_dev
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    keys = [k for k in ("k", "k2", "v", "mv") if k in jc]
    assert sorted(keys) == sorted(k for k in pc if k != "len") and ("mv" in keys) == (kind == "mop")
    for key in keys:
        axis = 2 if key == "mv" else 3
        np.testing.assert_allclose(pc[key].narrow(axis, 0, t0).numpy(),
                                   np.asarray(jc[key]).take(range(t0), axis=axis),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("mix", list(MIXES))
def test_bucketed_admissions_replay_bit_for_bit(quartet, mix, lifted):
    pm = quartet[2]
    opts, reqs = MIXES[mix]
    if opts == "adapters":
        opts = dict(adapters=_adapters(pm))
    prompts = prompts_of(LENGTHS, seed=60)
    jobs = [(p, n, kw) for p, (n, kw) in zip(prompts, reqs)]

    def make(graphed):
        return DecodeEngine(pm, None, max_batch=2, prefill_buckets=BUCKETS, cuda_graph=graphed,
                            generator=torch.Generator().manual_seed(21), **opts)

    (eager, graphed), _, log = lockstep(make, jobs)
    assert_one_call_each(log)
    assert len(log) == len(jobs) and graphed._adm_graph.calls == len(jobs)
    want = {(E.BUCKET, graphed._bucket_of(len(p)), expected_form(kw)) for p, _, kw in jobs}
    assert set(graphed._adm_graph.graphs) == want
    assert eager._adm_graph is None
    if mix != "greedy":
        assert len({t for toks in eager.results.values() for t in toks}) > 3


def test_exact_and_beam_admissions_make_no_graph_call(quartet, lifted):
    """A prompt past the last bucket and a beam request are admitted
    eagerly (one prefill at their own length, as JAX compiles per length);
    the bucketed one beside them replays its graph. An engine without
    buckets makes no admission graph at all."""
    pm = quartet[2]
    prompts = prompts_of([11, 5, 6], seed=61)
    jobs = [(prompts[0], 5, {}), (prompts[1], 4, {}), (prompts[2], 6, dict(num_beams=2))]

    def make(graphed):
        return DecodeEngine(pm, None, max_batch=4, max_beams=2, prefill_buckets=[8],
                            cuda_graph=graphed)

    (_, graphed), _, log = lockstep(make, jobs)
    assert [(r, w, c) for r, w, c, _, _ in log] == [(E.EXACT, 11, 0), (E.BUCKET, 8, 1)]
    assert list(graphed._adm_graph.graphs) == [(E.BUCKET, 8, E.GREEDY)]
    assert graphed._adm_graph.calls == 1

    def plain(graphed):
        return DecodeEngine(pm, None, max_batch=2, cuda_graph=graphed)

    (_, graphed), _, log = lockstep(plain, [(p, 4, {}) for p in prompts])
    assert [r for r, _, _, _, _ in log] == [E.EXACT] * 3
    assert graphed._adm_graph.calls == 0 and not graphed._adm_graph.graphs


def test_graphed_bucketed_admissions_equal_jax(quartet, lifted):
    jm, jp, pm = quartet
    prompts = prompts_of(LENGTHS[:4], seed=62)
    budgets = [6, 5, 7, 4]
    jeng = JaxEngine(jm, jp, max_batch=2, prefill_buckets=BUCKETS)
    rids = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    want = jeng.run()
    eng = DecodeEngine(pm, None, max_batch=2, prefill_buckets=BUCKETS, cuda_graph=True)
    got = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = eng.run()
    assert eng._adm_graph.calls == len(prompts)
    assert {k[:2] for k in eng._adm_graph.graphs} == {(E.BUCKET, 8), (E.BUCKET, 16)}
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(res[got[i]], want[rids[i]], margins, f"request {i}")
