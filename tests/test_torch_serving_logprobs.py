"""Logprobs in the port's serving layer against the JAX package: the
engine's per-token ``logprobs`` and ``top_logprobs`` (``logprobs_topk``)
equal to JAX's ``DecodeEngine``'s over the same weights, 1:1 with the
tokens, also through ``step(n_tokens=k)`` and chunked prefill; and
``prompt_logprobs`` (teacher-forced scoring through ``decode_chunk_rows``)
equal to JAX's. Values at rtol 2e-4 / atol 2e-5."""

import jax
import numpy as np
import pytest

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu.serving import prompt_logprobs as jax_prompt_logprobs
from mop_tpu_torch.serving import DecodeEngine, prompt_logprobs

from _torch_serving_common import (ATOL, RTOL, _one_torch_thread, lm_pair,  # noqa: F401
                                   prompts_of, to_torch)

PROMPTS = [3, 11, 6]
BUDGETS = [5, 4, 6]


def _serve(eng, prompts, n_tokens=1):
    rids = [eng.submit(p, n) for p, n in zip(prompts, BUDGETS)]
    eng.run(n_tokens=n_tokens)
    return [(eng.results[r], eng.logprobs[r], eng.top_logprobs[r]) for r in rids]


def _assert_same(got, want):
    for (gt, gl, gtop), (wt, wl, wtop) in zip(got, want):
        assert gt == wt and len(gl) == len(gt) == len(gtop)
        np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL)
        for a, b in zip(gtop, wtop):
            assert [t for t, _ in a] == [t for t, _ in b]
            np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=RTOL, atol=ATOL)


def test_engine_logprobs_equal_jax():
    jm, jp, pm = lm_pair("quartet", scale=3.0)
    pp = to_torch(jax.device_get(jp))
    prompts = prompts_of(PROMPTS, seed=110)
    want = _serve(JaxEngine(jm, jp, max_batch=2, logprobs_topk=3, prefill_buckets=[16]), prompts)
    got = _serve(DecodeEngine(pm, pp, max_batch=2, logprobs_topk=3), prompts)
    _assert_same(got, want)
    # multi-step records the same entries
    _assert_same(_serve(DecodeEngine(pm, pp, max_batch=2, logprobs_topk=3), prompts, n_tokens=3),
                 want)
    # a chunked prefill scores its first token over the prompt's live
    # prefixes (``decode_chunk_rows``), not its whole window: the entries
    # stay 1:1 with the tokens
    for toks, lps, tops in _serve(DecodeEngine(pm, pp, max_batch=2, logprobs_topk=3,
                                               chunk_prefill=4), prompts):
        assert len(toks) == len(lps) == len(tops) and all(len(t) == 3 for t in tops)
    with pytest.raises(ValueError, match="logprobs_topk"):
        DecodeEngine(pm, pp, logprobs_topk=33)


@pytest.mark.parametrize("kind,n", [("quartet", 9), ("mop", 14)])
def test_prompt_logprobs_equal_jax(kind, n):
    jm, jp, pm = lm_pair(kind, scale=3.0)
    pp = to_torch(jax.device_get(jp))
    prompt = prompts_of([n], seed=111)[0]
    want_lp, want_top = jax_prompt_logprobs(jm, jp, prompt, 3)
    got_lp, got_top = prompt_logprobs(pm, pp, prompt, 3)
    assert got_lp[0] is None and got_top[0] == [] and len(got_lp) == n
    np.testing.assert_allclose(got_lp[1:], want_lp[1:], rtol=RTOL, atol=ATOL)
    for a, b in zip(got_top[1:], want_top[1:]):
        assert [t for t, _ in a] == [t for t, _ in b]
        np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="context window"):
        prompt_logprobs(pm, pp, list(range(17)))
