"""``SpecDecodeEngine(cuda_graph=True)`` on the CPU, where no CUDA graph can
be captured (the refusals are in ``test_torch_graph_engines.py``).

With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly over
the same static buffers, the form a replay computes; no host read in it):
the round over the device lengths (``DeviceMirror``: written where host
control changed a slot, advanced by the round; held equal to the host
lengths of the live slots after every step) against the eager engine token
for token, with equal drafts proposed and accepted and engine steps (gamma
1 and 3, a distinct draft and the target as its own draft, the window's
edge, logprobs, the prefix cache and buckets); and against JAX's engine up
to each row's first near tie, in as many engine steps.
"""

import numpy as np
import pytest

from mop_tpu.serving import SpecDecodeEngine as JaxSpec
from mop_tpu_torch.serving import SpecDecodeEngine
from mop_tpu_torch.serving import engine as E

from _torch_decode_common import lift_graphs
from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair)

JOBS = [([5, 17, 3, 21], 8), ([1, 2], 7), ([30, 31, 32, 33, 34, 35], 5), ([9], 8),
        ([25, 24, 23], 5)]


@pytest.fixture
def lifted(monkeypatch):
    """The graphed engine on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, E)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


@pytest.fixture(scope="module")
def pair():
    """(target, draft) JAX / port pairs: the 2-layer Quartet LM and a
    1-layer, 16-wide one."""
    return lm_pair("quartet", scale=3.0), lm_pair("quartet", seed=7, scale=3.0, n_layer=1,
                                                  n_embd=16)


def _run(eng, jobs=JOBS):
    """Every request's tokens; after each step the live slots' device
    lengths equal the host's."""
    rids = [eng.submit(p, n) for p, n in jobs]
    while eng.n_queued or eng.n_active:
        eng.step()
        live = np.asarray([r >= 0 for r in eng._slot_rid])
        assert (eng._dlens.dev.numpy()[live] == eng._lens[live]).all()
    return [eng.results[r] for r in rids]


def _both(target, draft, jobs=JOBS, **kw):
    out = []
    for graphed in (False, True):
        eng = SpecDecodeEngine(target, None, draft, None, cuda_graph=graphed, **kw)
        got = _run(eng, jobs)
        out.append((got, eng.drafts_proposed, eng.drafts_accepted, eng.engine_steps,
                    eng.tokens_generated, {r: eng.logprobs.get(r) for r in eng.results}))
        assert (eng._graph is not None) == graphed
    return out


@pytest.mark.parametrize("gamma", [1, 3])
def test_graphed_spec_is_the_eager_engine(pair, gamma, lifted):
    (_, _, pm), (_, _, pd) = pair
    want, got = _both(pm, pd, max_batch=3, gamma=gamma)
    assert got == want and want[2] < want[1]
    want, got = _both(pm, pm, max_batch=3, gamma=gamma)  # the target as its own draft
    assert got == want and want[2] == want[1]


def test_graphed_spec_window_edge_logprobs_prefix_cache(pair, lifted):
    """Requests that reach the window's edge (block 16), logprobs tracked, a
    prefix cache and buckets: the eager engine's tokens, logprobs and
    counts."""
    (_, _, pm), (_, _, pd) = pair
    jobs = JOBS + [([2, 3, 5, 7, 11, 13, 17, 19, 23], 12), ([5, 17, 3, 21, 8], 6)]
    want, got = _both(pm, pd, jobs, max_batch=3, gamma=3, logprobs_topk=2,
                      prefix_cache_entries=2, prefill_buckets=[8, 16])
    assert got == want and len(got[0][-2]) < 12


def test_graphed_spec_equals_jax(pair, lifted):
    (jm, jp, pm), (jd, jdp, pd) = pair
    gamma = 3
    # the bucket bounds JAX's compiles; the tokens are those without it
    jeng = JaxSpec(jm, jp, jd, jdp, max_batch=3, gamma=gamma, prefill_buckets=[16])
    rids = [jeng.submit(p, n) for p, n in JOBS]
    res = jeng.run()
    want = [res[r] for r in rids]
    eng = SpecDecodeEngine(pm, None, pd, None, max_batch=3, gamma=gamma, prefill_buckets=[16],
                           cuda_graph=True)
    got = _run(eng)
    for i, (p, n) in enumerate(JOBS):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")
    assert eng.engine_steps == jeng.engine_steps and eng._graph.calls > 2
