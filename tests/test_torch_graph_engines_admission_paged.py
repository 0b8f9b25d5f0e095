"""The paged and speculative engines' admissions as replays of the
admission graph, on the CPU, where no CUDA graph can be captured. With
``require_graph`` lifted (no host read in a captured body):

- the paged engine's bucketed admission (one graph per (bucket, form),
  the prefill pasted over the slot's whole page-table row, the entries
  past its pages the scratch page) against the eager engine call by call
  and bit for bit under preemption, its re-admissions' output counts those
  of the tokens the request emitted (the prompt's last ones) and its prompt
  mask the whole prefix; against JAX's paged engine with buckets under
  preemption up to each row's first near tie;
- the speculative engine's admission: the target's bucketed or prefix-hit
  admission and the draft's bucketed prefill in one replay, keyed by the
  draft's bucket too, against the eager engine bit for bit (both pools);
  a prompt past the last bucket admitted eagerly into both.
"""

import numpy as np
import pytest
import torch

from mop_tpu.serving import PagedDecodeEngine as JaxPaged
from mop_tpu_torch.serving import PagedDecodeEngine, SpecDecodeEngine
from mop_tpu_torch.serving import engine as E

from _torch_admission_common import (assert_one_call_each, bincount, expected_form,  # noqa: F401
                                     lifted, lockstep)
from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair, prompts_of, shared_prefix_prompts)

LENGTHS, BUDGETS = [6, 5, 3, 7, 4], [9, 10, 8, 6, 7]
KWS = [dict(temperature=1.0, seed=5, repetition_penalty=1.6), {},
       dict(temperature=0.9, frequency_penalty=0.5), dict(presence_penalty=0.8), {}]


def _checked_readmissions(eng, vocab):
    """Wrap ``eng._admit_one``: after each admission that picked, the slot's
    output counts are those of the request's emitted tokens and its first
    one, and its prompt mask the prompt's tokens; returns the list of
    (rid, emitted so far) per admission."""
    seen, admit = [], eng._admit_one

    def checked():
        head = eng._queue[0] if eng._queue else None
        out = admit()
        if out is not None and out[2] is not None:
            slot, rid, tok0 = out[:3]
            emitted = list(eng.results[rid])
            assert head[0] == rid
            np.testing.assert_array_equal(eng._ocounts[slot].numpy(),
                                          bincount(emitted + [tok0], vocab))
            np.testing.assert_array_equal(eng._pseen[slot].numpy(), bincount(head[1], vocab) > 0)
            seen.append((rid, len(emitted)))
        return out

    eng._admit_one = checked
    return seen


def test_paged_readmissions_replay_bit_for_bit(lifted):
    """Five pages of 4 rows for two slots: requests are preempted and
    re-admitted (their prefix re-prefilled to its bucket), greedy, seeded
    and penalised, call by call."""
    pm = lm_pair("mop_causal", scale=3.0)[2]
    prompts = prompts_of(LENGTHS, seed=3)
    jobs = list(zip(prompts, BUDGETS, KWS))
    admissions = []

    def make(graphed):
        eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=4, eos_id=0,
                                prefill_buckets=[8, 16], cuda_graph=graphed,
                                generator=torch.Generator().manual_seed(24))
        if graphed:
            admissions.extend([eng, _checked_readmissions(eng, 40)])
        return eng

    (eager, graphed), _, log = lockstep(make, jobs)
    assert graphed.preemptions == eager.preemptions > 0
    readmitted = [n for _, n in admissions[1] if n > 0]
    assert readmitted and len(log) == len(jobs) + len(readmitted)
    assert_one_call_each(log)
    assert {k[:2] for k in graphed._adm_graph.graphs} == {(E.BUCKET, 8), (E.BUCKET, 16)}
    assert graphed.pages_in_use == 0


def test_graphed_paged_buckets_equal_jax_under_preemption(lifted):
    jm, jp, pm = lm_pair("quartet", scale=3.0)
    prompts = prompts_of(LENGTHS[:4], seed=3)
    budgets = BUDGETS[:4]
    jeng = JaxPaged(jm, jp, max_batch=2, n_pages=5, page_size=4, prefill_buckets=[8, 16])
    rids = [jeng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = jeng.run()
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=4,
                            prefill_buckets=[8, 16], cuda_graph=True)
    got = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    out = eng.run()
    assert eng.preemptions == jeng.preemptions > 0
    assert eng._adm_graph.calls == len(prompts) + eng.preemptions
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(out[got[i]], res[rids[i]], margins, f"request {i}")


def test_spec_admissions_replay_bit_for_bit(lifted):
    """The target's admission and the draft's prefill in one replay: a
    bucketed prompt, prefix hits whose whole prompt the draft's bucket holds
    or not, and a prompt past the last bucket (eager into both pools)."""
    pm = lm_pair("quartet", scale=3.0)[2]
    pd = lm_pair("quartet", seed=7, scale=3.0, n_layer=1, n_embd=16)[2]
    prompts = shared_prefix_prompts(5, [1, 2, 4], seed=73) + prompts_of([11], seed=74)
    jobs = [(p, 6, {}) for p in prompts]

    def make(graphed):
        return SpecDecodeEngine(pm, None, pd, None, max_batch=2, gamma=3, prefill_buckets=[8],
                                prefix_cache_entries=2, logprobs_topk=2, cuda_graph=graphed)

    (eager, graphed), _, log = lockstep(make, jobs)
    assert_one_call_each(log)
    # 6 tokens: bucket 8; hits of 7 and 9 tokens (tails 2, 4), the draft's buckets 8 and
    # none; 11 tokens: exact, no graph
    assert [(r, w, c) for r, w, c, _, _ in log] == [
        (E.BUCKET, 8, 1), (E.TAIL, 2, 1), (E.TAIL, 4, 1), (E.EXACT, 11, 0)]
    assert set(graphed._adm_graph.graphs) == {(E.BUCKET, 8, E.GREEDY, 8),
                                              (E.TAIL, 2, E.GREEDY, 8),
                                              (E.TAIL, 4, E.GREEDY, None)}
    assert graphed.drafts_accepted == eager.drafts_accepted
