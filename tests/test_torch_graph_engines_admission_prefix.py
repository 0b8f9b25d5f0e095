"""The dense engine's prefix-cache hits and chunked prefill as replays of
the admission graph (``_admit_rows`` over ``_feed_rows``: the tail padded
to a power of two, or a chunk padded to ``chunk_prefill``, appended to the
slot's rows from a device base, the logits read at the device count's last
token), on the CPU, where no CUDA graph can be captured. With
``require_graph`` lifted (no host read in a captured body):

- the graphed engine against the eager one call by call and bit for bit
  (tokens, logprob entries, the generator's state, every pool, lengths,
  counts, masks): prefix hits keyed (tail width, form), greedy, sampled,
  LoRA with logprobs; chunked prefill keyed (chunk, form, or none before
  the last chunk) beside a decoding stream; a hit whose tail is fed in
  chunks; one graph call an admission and a chunk;
- the graphed engine's greedy tokens against JAX's engine with the prefix
  cache and with chunked prefill, up to each row's first near tie of the
  port's single-stream feed.
"""

import importlib

import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine
from mop_tpu_torch.serving import engine as E

from _torch_admission_common import (assert_one_call_each, expected_form, lifted,  # noqa: F401
                                     lockstep)
from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   chunked_ref, lm_pair, prefill_rows, prompts_of,
                                   shared_prefix_prompts)
from test_torch_graph_engines_picker import _adapters

G = importlib.import_module("mop_tpu_torch.models.generate")

SYSTEM = 7
TAILS = [2, 4, 1, 3, 2]  # tails of g 2, 4, 1, 3, 2: widths 2, 4, 1, 4, 2

MIXES = {
    "greedy": ({}, [{}] * 5),
    "sampled": (dict(eos_id=0), [dict(temperature=0.9, seed=4), {},
                                 dict(temperature=1.1, top_k=10),
                                 dict(repetition_penalty=1.5), dict(temperature=0.8, seed=9)]),
    "lora_logprobs": ("adapters", [dict(adapter="x"), dict(adapter="x", temperature=0.9),
                                   dict(adapter="y"), dict(adapter="x"), {}]),
}


@pytest.fixture(scope="module")
def quartet():
    return lm_pair("quartet", scale=3.0)


def _pow2(g):
    return 1 << (g - 1).bit_length()


@pytest.mark.parametrize("kind,kv", [("quartet", torch.float32), ("quartet", torch.int8),
                                     ("mop", torch.float32)])
def test_one_slot_rows_append_in_place(kind, kv):
    """``OneSlotRows``, the feed's access: a (1, G) append from a device base
    into one slot of a 3-slot pool, in place, gives the logits and the slot's
    rows of ``decode_chunk_rows`` over a copy of that slot, bit for bit, and
    leaves the other slots as they were (K/K2/V, int8 scales, GPT-MoP's view
    history); positions past the window clamp to its last column."""
    pm = lm_pair(kind, scale=2.0)[2]
    gen = torch.Generator().manual_seed(5)
    cache = G.init_decode_cache(pm.config, 3, kv, n_views=G.model_n_views(pm), device="cpu")
    keys = [k for k in cache if k != "len"]
    for key in keys:
        buf = cache[key]
        if buf.dtype == torch.int8:
            buf.copy_(torch.randint(-127, 128, buf.shape, generator=gen))
        else:
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.1)
    width = cache["k"].shape[3]
    toks = torch.randint(0, 40, (1, 4), generator=gen)
    slot = torch.tensor([1])
    for base in (torch.tensor(5), torch.tensor(width - 2)):  # the second runs past the window
        before = {key: cache[key].clone() for key in keys}
        view = {key: cache[key].index_select(1, slot) for key in keys}
        want, _ = G.decode_chunk_rows(pm, None, view, toks, base.reshape(1))
        got = G.decode_rows(pm, None, G.OneSlotRows(cache, slot), toks, base.reshape(1))
        assert torch.equal(got, want)
        for key in keys:
            assert torch.equal(cache[key].index_select(1, slot), view[key]), key
            for other in (0, 2):
                assert torch.equal(cache[key][:, other], before[key][:, other]), (key, other)


@pytest.mark.parametrize("mix", list(MIXES))
def test_prefix_hits_replay_bit_for_bit(quartet, mix, lifted):
    pm = quartet[2]
    opts, kws = MIXES[mix]
    if opts == "adapters":
        opts = dict(adapters=_adapters(pm), logprobs_topk=2)
    prompts = shared_prefix_prompts(SYSTEM, TAILS, seed=70)
    jobs = [(p, 5, kw) for p, kw in zip(prompts, kws)]

    def make(graphed):
        return DecodeEngine(pm, None, max_batch=2, prefix_cache_entries=3, prefill_buckets=[16],
                            cuda_graph=graphed, generator=torch.Generator().manual_seed(22),
                            **opts)

    (eager, graphed), _, log = lockstep(make, jobs)
    assert_one_call_each(log)
    assert graphed.prefix_cache_hits == eager.prefix_cache_hits
    tails = [(w, kw) for (r, w, _, _, _), (_, _, kw) in zip(log, jobs) if r == E.TAIL]
    assert len(tails) == graphed.prefix_cache_hits >= 2  # LoRA: a hit under its adapter only
    assert {w for w, _ in tails} <= {_pow2(g) for g in TAILS}
    assert set(graphed._adm_graph.graphs) == (
        {(E.TAIL, w, expected_form(kw)) for w, kw in tails}
        | {(E.BUCKET, 16, expected_form(kw)) for (r, _, _, _, _), (_, _, kw) in zip(log, jobs)
           if r == E.BUCKET})


def test_chunked_prefill_replays_bit_for_bit(quartet, lifted):
    """A short request decodes while the others feed in 4-token chunks: one
    replay a chunk, the chunks before the last keyed with no picker."""
    pm = quartet[2]
    prompts = prompts_of([2, 13, 11, 3, 9], seed=71)
    kws = [{}, dict(temperature=1.0, seed=3), dict(temperature=0.9), {},
           dict(frequency_penalty=0.4)]
    jobs = [(p, n, kw) for p, n, kw in zip(prompts, [8, 3, 4, 5, 4], kws)]

    def make(graphed):
        return DecodeEngine(pm, None, max_batch=2, chunk_prefill=4, prefill_buckets=[16],
                            logprobs_topk=2, cuda_graph=graphed,
                            generator=torch.Generator().manual_seed(23))

    (_, graphed), _, log = lockstep(make, jobs, staggered=1)
    assert_one_call_each(log)
    chunks = [(w, t is not None) for r, w, _, _, t in log if r == E.CHUNK]
    # 13: 4 + 4 + 4 + 1, 11: 4 + 4 + 3, 9: 4 + 4 + 1; the last of each picks
    assert len(chunks) == 10 and all(w == 4 for w, _ in chunks)
    assert sum(p for _, p in chunks) == 3
    assert set(graphed._adm_graph.graphs) == {
        (E.BUCKET, 16, E.GREEDY), (E.CHUNK, 4, None), (E.CHUNK, 4, E.SAMPLE),
        (E.CHUNK, 4, E.DRAW), (E.CHUNK, 4, E.GREEDY)}


def test_prefix_hit_with_a_chunked_tail(quartet, lifted):
    """A hit whose tail is longer than the chunk feeds it in chunks from the
    entry's rows (the base a device scalar)."""
    pm = quartet[2]
    prompts = shared_prefix_prompts(SYSTEM, [2, 5, 3], seed=72)
    jobs = [(p, 4, {}) for p in prompts]

    def make(graphed):
        return DecodeEngine(pm, None, max_batch=1, prefix_cache_entries=2, chunk_prefill=2,
                            prefill_buckets=[16], cuda_graph=graphed)

    (eager, graphed), _, log = lockstep(make, jobs)
    assert_one_call_each(log)
    assert graphed.prefix_cache_hits == 2
    # the first prompt (9 tokens) fed 2 at a time, then tails of 5 (2 + 2 + 1) and 3 (2 + 1)
    assert [r for r, _, _, _, _ in log] == [E.CHUNK] * 10


def test_graphed_prefix_hits_equal_jax(quartet, lifted):
    jm, jp, pm = quartet
    prompts = shared_prefix_prompts(SYSTEM, TAILS[:4], seed=43)
    jeng = JaxEngine(jm, jp, max_batch=2, prefix_cache_entries=2)
    eng = DecodeEngine(pm, None, max_batch=2, prefix_cache_entries=2, cuda_graph=True)
    base = prefill_rows(pm, None, prompts[0], SYSTEM)
    for i, p in enumerate(prompts):  # one at a time: each later one hits
        rids = jeng.submit(p, 4), eng.submit(p, 4)
        want, got = jeng.run()[rids[0]], eng.run()[rids[1]]
        assert eng.prefix_cache_hits == jeng.prefix_cache_hits == i
        _, margins = (cached_ref(pm, None, p, 4) if i == 0
                      else chunked_ref(pm, None, p, 4, None, base=base))
        assert_stream(got, want, margins, f"request {i}")
    assert eng._adm_graph.calls == len(prompts) - 1  # the first prompt exact: no bucket
    assert {w for r, w, _ in eng._adm_graph.graphs} == {_pow2(g) for g in TAILS[1:4]}


def test_graphed_chunked_prefill_equals_jax(quartet, lifted):
    jm, jp, pm = quartet
    prompts = prompts_of([2, 13, 11, 3], seed=51)
    budgets = [8, 3, 2, 5]

    def staggered(eng):
        rids = [eng.submit(prompts[0], budgets[0])]
        eng.step()
        rids += [eng.submit(p, n) for p, n in zip(prompts[1:], budgets[1:])]
        res = eng.run()
        return [res[r] for r in rids]

    want = staggered(JaxEngine(jm, jp, max_batch=2, chunk_prefill=4))
    eng = DecodeEngine(pm, None, max_batch=2, chunk_prefill=4, cuda_graph=True)
    got = staggered(eng)
    assert {k[:2] for k in eng._adm_graph.graphs} == {(E.CHUNK, 4)}
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = (chunked_ref(pm, None, p, n, 4) if len(p) > 4
                      else cached_ref(pm, None, p, n))
        assert_stream(got[i], want[i], margins, f"request {i}")
