"""The port's ``SpecDecodeEngine`` against JAX's over the same target and
draft weights: a mixed batch of more requests than slots with a distinct
draft gives JAX's tokens (up to each row's first near tie of the
single-stream reference) in as many engine steps, so the acceptance of
each round is JAX's."""

from mop_tpu.serving import SpecDecodeEngine as JaxSpec
from mop_tpu_torch.serving import SpecDecodeEngine

from _torch_serving_common import (_one_torch_thread, assert_stream, cached_ref,  # noqa: F401
                                   lm_pair)

JOBS = [([5, 17, 3, 21], 8), ([1, 2], 7), ([30, 31, 32, 33, 34, 35], 5), ([9], 8),
        ([25, 24, 23], 5)]


def test_spec_engine_equals_jax():
    gamma = 3
    jm, jp, pm = lm_pair("quartet", scale=3.0)
    jd, jdp, pd = lm_pair("quartet", seed=7, scale=3.0, n_layer=1, n_embd=16)

    def run(eng):
        rids = [eng.submit(p, n) for p, n in JOBS]
        res = eng.run()
        return [res[r] for r in rids]

    # the bucket bounds JAX's compiles; the tokens are those without it
    jeng = JaxSpec(jm, jp, jd, jdp, max_batch=3, gamma=gamma, prefill_buckets=[16])
    want = run(jeng)
    eng = SpecDecodeEngine(pm, None, pd, None, max_batch=3, gamma=gamma, prefill_buckets=[16])
    got = run(eng)
    for i, (p, n) in enumerate(JOBS):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")
    assert eng.engine_steps == jeng.engine_steps < sum(n for _, n in JOBS)
    assert eng.tokens_generated == jeng.tokens_generated
