"""The port's per-row sampler and its engine-level properties, against the
JAX package where the numbers can agree:

- ``sampling_dist`` against JAX's ``DecodeEngine._pick_rows``: the greedy
  token under per-row logit bias and repetition / presence / frequency
  penalties; for sampled rows the kept set and probabilities before the
  draw (every token JAX draws, over 4,000 keys, is in the port's kept set,
  and the draw frequencies sit within 0.05 of the port's probabilities).
  The draws themselves come from different generators and are never
  compared;
- penalties in the engine equal to the single-stream ``generate_cached``;
  logit bias bans and forces tokens; multi-token stops end a stream;
- a seeded request's tokens depend only on (seed, prompt, params): alone,
  co-batched with sampled traffic under another engine generator, and in
  ``step(n_tokens=k)``, they are the same;
- ``step(n_tokens=k)`` gives the tokens of k ``step()`` calls for unseeded
  sampled rows too, with a constrained request co-batched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu_torch.serving import DecodeEngine, choices
from mop_tpu_torch.serving.engine import sampling_dist

from _torch_serving_common import G, _one_torch_thread, cached_ref, lm_pair, prompts_of  # noqa: F401

V = 40
ROWS = {  # temp, topk, topp, minp, rep, pres, freq
    "greedy": (0.0, 0, 1.0, 0.0, 1.0, 0.0, 0.0),
    "penalised": (0.0, 0, 1.0, 0.0, 1.6, 0.7, 0.3),
    "topk": (0.8, 5, 1.0, 0.0, 1.0, 0.0, 0.0),
    "topp": (1.3, 0, 0.6, 0.0, 1.2, 0.0, 0.4),
    "minp": (1.0, 0, 1.0, 0.15, 1.0, 0.5, 0.0),
    "all": (0.7, 8, 0.9, 0.05, 1.3, 0.2, 0.2),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    b = len(ROWS)
    logits = (rng.standard_normal((b, V)) * 2.0).astype(np.float32)
    ocounts = rng.integers(0, 3, (b, V)).astype(np.int32) * (rng.random((b, V)) < 0.2)
    pseen = rng.random((b, V)) < 0.15
    lbias = np.where(rng.random((b, V)) < 0.1, rng.standard_normal((b, V)) * 3, 0.0)
    cols = np.asarray(list(ROWS.values()), np.float32).T
    return logits, ocounts.astype(np.int32), pseen, lbias.astype(np.float32), cols


def _port_dist(logits, ocounts, pseen, lbias, cols):
    sp = {k: torch.from_numpy(c.copy()) for k, c in zip(
        ("temp", "topk", "topp", "minp", "rep", "pres", "freq"), cols)}
    return sampling_dist(torch.from_numpy(logits), sp, torch.from_numpy(ocounts),
                         torch.from_numpy(pseen), torch.from_numpy(lbias))


def _jax_pick(logits, ocounts, pseen, lbias, cols, key):
    temp, topk, topp, minp, rep, pres, freq = (jnp.asarray(c) for c in cols)
    return JaxEngine._pick_rows(jnp.asarray(logits), key, temp, topk.astype(jnp.int32), topp,
                                minp, rep, pres, freq, jnp.asarray(ocounts), jnp.asarray(pseen),
                                jnp.asarray(lbias))


def test_greedy_under_bias_and_penalties_equals_jax():
    logits, ocounts, pseen, lbias, cols = _inputs()
    greedy, _, _ = _port_dist(logits, ocounts, pseen, lbias, cols)
    zero_t = cols.copy()
    zero_t[0] = 0.0
    want = _jax_pick(logits, ocounts, pseen, lbias, zero_t, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))


def test_kept_set_and_probabilities_agree_with_jax_draws():
    logits, ocounts, pseen, lbias, cols = _inputs(seed=1)
    _, order, masked = _port_dist(logits, ocounts, pseen, lbias, cols)
    probs = torch.softmax(masked, -1)
    p_vocab = torch.zeros_like(probs).scatter_(1, order, probs).numpy()
    keys = jax.random.split(jax.random.PRNGKey(7), 4000)
    draws = np.asarray(jax.jit(jax.vmap(
        lambda k: _jax_pick(logits, ocounts, pseen, lbias, cols, k)))(keys))  # (4000, B)
    for r, name in enumerate(ROWS):
        if cols[0, r] == 0.0:
            continue
        kept = set(np.nonzero(p_vocab[r] > 0)[0].tolist())
        drawn = set(draws[:, r].tolist())
        assert drawn <= kept, f"{name}: JAX drew {sorted(drawn - kept)} outside the kept set"
        freq = np.bincount(draws[:, r], minlength=V) / len(keys)
        np.testing.assert_allclose(freq, p_vocab[r], atol=0.05, err_msg=name)
        assert 1 < len(kept) < V, name  # the filters took effect and left a choice


@pytest.mark.parametrize("pen", [dict(repetition_penalty=1.8),
                                 dict(presence_penalty=1.5, frequency_penalty=0.5)])
def test_engine_penalties_equal_generate_cached(pen):
    _, _, pm = lm_pair("quartet", scale=3.0)
    prompts = prompts_of([4, 6, 3], seed=90)
    eng = DecodeEngine(pm, None, max_batch=3)
    rids = [eng.submit(p, 8, **pen) for p in prompts]
    res = eng.run()
    for rid, p in zip(rids, prompts):
        want = G.generate_cached(pm, None, torch.tensor([p]), 8, **pen)[0, len(p):].tolist()
        assert res[rid] == want


def test_logit_bias_and_stop_sequences():
    _, _, pm = lm_pair("quartet", scale=3.0)
    p = prompts_of([4], seed=91)[0]
    ref, _ = cached_ref(pm, None, p, 10)
    seq = ref[3:5]  # the stream ends at the first place it emits ``seq``
    end = next(i + 2 for i in range(len(ref) - 1) if ref[i:i + 2] == seq)
    eng = DecodeEngine(pm, None, max_batch=3)
    forced = eng.submit(p, 5, logit_bias={7: 100.0})
    banned = eng.submit(p, 10, logit_bias={ref[0]: -100.0, ref[1]: -100.0})
    stop = eng.submit(p, 10, stop=[seq, next(t for t in range(V) if t not in ref)])
    res = eng.run()
    assert res[forced] == [7] * 5
    assert ref[0] not in res[banned] and ref[1] not in res[banned]
    assert res[stop] == ref[:end]


def _sampled_run(gen_seed, n_tokens, seeded_first, constrained=False):
    _, _, pm = lm_pair("quartet", scale=1.0)
    gen = torch.Generator().manual_seed(gen_seed)
    eng = DecodeEngine(pm, None, max_batch=4, generator=gen, eos_id=0)
    p = prompts_of([5, 3, 6, 4], seed=92)
    rid = None
    if seeded_first:
        rid = eng.submit(p[0], 10, temperature=1.0, top_k=20, seed=1234)
    others = [eng.submit(p[1], 9, temperature=1.2, top_p=0.95),
              eng.submit(p[2], 7, temperature=0.9)]
    if constrained:
        others.append(eng.submit(p[3], 8, temperature=1.0,
                                 constraint=choices([[3, 4, 5, 6], [3, 7], [8]])))
    if not seeded_first:
        rid = eng.submit(p[0], 10, temperature=1.0, top_k=20, seed=1234)
    res = eng.run(n_tokens=n_tokens)
    return res[rid], [res[r] for r in others]


def test_seeded_request_is_independent_of_traffic_and_generator():
    alone_eng = DecodeEngine(lm_pair("quartet", scale=1.0)[2], None, max_batch=1, eos_id=0)
    rid = alone_eng.submit(prompts_of([5, 3, 6, 4], seed=92)[0], 10, temperature=1.0, top_k=20,
                           seed=1234)
    alone = alone_eng.run()[rid]
    assert len(set(alone)) > 2
    for gen_seed, n_tokens, first in ((0, 1, True), (99, 1, False), (5, 3, False)):
        seeded, _ = _sampled_run(gen_seed, n_tokens, first)
        assert seeded == alone, (gen_seed, n_tokens, first)
    other = DecodeEngine(lm_pair("quartet", scale=1.0)[2], None, max_batch=1, eos_id=0)
    rid = other.submit(prompts_of([5, 3, 6, 4], seed=92)[0], 10, temperature=1.0, top_k=20,
                       seed=1235)
    assert other.run()[rid] != alone


def test_multistep_equals_single_steps_for_unseeded_rows_beside_a_constraint():
    """k single steps in one ``step(n_tokens=k)`` call draw the engine
    generator as k ``step()`` calls do, also when a sampled constrained row
    is co-batched (its DFA mask updates between the k steps): a burst that
    held that row out and stepped it once more would draw the generator
    once more and shift every unseeded row's stream."""
    one_seeded, one = _sampled_run(3, 1, True, constrained=True)
    four_seeded, four = _sampled_run(3, 4, True, constrained=True)
    assert four_seeded == one_seeded and four == one
    assert one[-1] in ([3, 4, 5, 6, 0], [3, 7, 0], [8, 0])  # a sampled choice, then EOS
    assert len(set(one[0])) > 2
