"""Beam search in the port's ``DecodeEngine``: a beam request's tokens equal
to the port's single-stream ``generate_beam`` (best beam, cut after EOS) and
to JAX's ``DecodeEngine`` over the same weights; co-batched greedy requests
unchanged; the group's cache rows permuted from a copy of its parents'
rows; and, once a group finishes or is cancelled, its slots free with their
lengths zeroed."""

import jax
import numpy as np
import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.models.beam import generate_beam
from mop_tpu_torch.serving import DecodeEngine

from _torch_serving_common import _one_torch_thread, cached_ref, lm_pair, prompts_of, to_torch  # noqa: F401,E501


def _beam_ref(pm, params, prompt, n, k, eos=None, lenpen=1.0):
    seqs, _ = generate_beam(pm, params, torch.tensor([prompt]), n, num_beams=k, eos_id=eos,
                            length_penalty=lenpen, return_all=True)
    best = seqs[0, 0, len(prompt):].tolist()
    if eos is not None and eos in best:
        best = best[:best.index(eos) + 1]
    return best


@pytest.mark.parametrize("k,eos,lenpen", [(2, None, 1.0), (3, 5, 1.0), (4, None, 2.0)])
def test_engine_beam_equals_generate_beam(k, eos, lenpen):
    _, _, pm = lm_pair("quartet", scale=2.0)
    prompt = prompts_of([4], seed=100)[0]
    eng = DecodeEngine(pm, None, max_batch=4, max_beams=4)
    rid = eng.submit(prompt, 10, eos_id=eos, num_beams=k, length_penalty=lenpen)
    assert eng.run()[rid] == _beam_ref(pm, None, prompt, 10, k, eos, lenpen)


def test_beam_beside_greedy_and_equal_to_jax_engine():
    jm, jp, pm = lm_pair("mop_causal", scale=2.0)
    pp = to_torch(jax.device_get(jp))
    greedy_p, beam_p = prompts_of([3, 5], seed=101)

    def run(eng):
        g = eng.submit(greedy_p, 8)
        eng.step()
        b = eng.submit(beam_p, 9, num_beams=3)
        res = eng.run()
        return res[g], res[b]

    want_g, want_b = run(JaxEngine(jm, jp, max_batch=5, max_beams=3, prefill_buckets=[16]))
    got_g, got_b = run(DecodeEngine(pm, pp, max_batch=5, max_beams=3))
    assert got_b == want_b == _beam_ref(pm, pp, beam_p, 9, 3)
    assert got_g == want_g == cached_ref(pm, pp, greedy_p, 8)[0]


def test_finished_beam_frees_its_slots_with_zero_lengths():
    _, _, pm = lm_pair("quartet", scale=2.0)
    eng = DecodeEngine(pm, None, max_batch=5, max_beams=3)
    long_rid = eng.submit(prompts_of([2], seed=102)[0], 12)  # keeps the engine busy
    eng.step()
    rid = eng.submit(prompts_of([6], seed=103)[0], 4, num_beams=3)
    eng.step()  # admission
    slots = list(eng._beam_groups[rid]["slots"])
    assert all(eng._lens[s] > 0 for s in slots)
    while not eng.is_done(rid):
        eng.step()
    assert not eng.is_done(long_rid)  # no admission since: nothing else reset them
    assert [eng._slot_rid[s] for s in slots] == [-1] * 3
    assert [int(eng._lens[s]) for s in slots] == [0, 0, 0]
    rid2 = eng.submit(prompts_of([6], seed=104)[0], 8, num_beams=2)
    eng.step()
    slots2 = list(eng._beam_groups[rid2]["slots"])
    assert eng.cancel(rid2)
    assert [int(eng._lens[s]) for s in slots2] == [0, 0]
    eng.run()


def test_beam_permutation_reads_a_copy_of_the_parents():
    """A cycle of three slots and a fan-out through ``_permute_rows``: each
    destination gets its parent's rows as they were before any write."""
    _, _, pm = lm_pair("quartet")
    eng = DecodeEngine(pm, None, max_batch=4, max_beams=4)
    for s in range(4):
        for key in eng._pool_keys:
            eng._cache[key][:, s] = float(s + 1)
    eng._permute_rows(np.asarray([1, 2, 0, 3]))
    assert [float(eng._cache["v"][1, s].flatten()[-1]) for s in range(4)] == [2.0, 3.0, 1.0, 4.0]
    eng._permute_rows(np.asarray([3, 3, 0, 0]))
    assert [float(eng._cache["k2"][0, s].flatten()[0]) for s in range(4)] == [4.0, 4.0, 2.0, 2.0]


def test_beam_request_checks():
    _, _, pm = lm_pair("quartet")
    eng = DecodeEngine(pm, None, max_batch=4, max_beams=2)
    with pytest.raises(ValueError, match="max_beams"):
        eng.submit([1, 2], 4, num_beams=3)
    with pytest.raises(ValueError, match="deterministic"):
        eng.submit([1, 2], 4, num_beams=2, temperature=0.5)
    with pytest.raises(ValueError, match="block_size"):
        eng.submit([1, 2, 3, 4], 13, num_beams=2)
    with pytest.raises(ValueError, match="logprobs"):
        DecodeEngine(pm, None, max_batch=4, max_beams=2, logprobs_topk=2).submit(
            [1, 2], 4, num_beams=2)
    rid = eng.submit([1, 2], 4, num_beams=1)  # one beam is greedy
    assert eng.run()[rid] == cached_ref(pm, None, [1, 2], 4)[0]
