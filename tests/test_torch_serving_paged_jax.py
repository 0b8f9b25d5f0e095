"""The port's paged serving against the JAX package's on the same inputs:
``paged_decode_step_rows`` (logits and the written pages, through a shuffled
page table) against ``mop_tpu.serving.paged_decode_step_rows`` for Quartet
and GPT-MoP; and ``PagedDecodeEngine`` on greedy mixed traffic under forced
preemption against JAX's, its tokens (up to the first near tie), its
``preemptions`` and its ``peak_pages_in_use``, which show the allocation
order and the re-admission ported as JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.serving import PagedDecodeEngine as JaxPaged
from mop_tpu.serving import init_paged_pool as jax_pool
from mop_tpu.serving import paged_decode_step_rows as jax_step
from mop_tpu_torch.serving import PagedDecodeEngine, init_paged_pool, paged_decode_step_rows

from _torch_serving_common import (ATOL, RTOL, VOCAB, _one_torch_thread,  # noqa: F401
                                   assert_stream, cached_ref, lm_pair, prompts_of)


@pytest.mark.parametrize("kind", ["quartet", "mop"])
def test_paged_step_equals_jax(kind):
    jm, jp, pm = lm_pair(kind, scale=3.0)
    cfg = pm.config
    n_pages, ps, b = 12, 4, 3
    nv = getattr(pm, "n_views", 0) or 0
    rng = np.random.default_rng(0)
    pool = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in init_paged_pool(cfg, n_pages, ps, n_views=nv, device="cpu").items()}
    jpool = {k: jnp.asarray(v.numpy()) for k, v in pool.items()}
    assert {k: v.shape for k, v in jpool.items()} == \
        {k: v.shape for k, v in jax_pool(jm.config, n_pages, ps, n_views=nv).items()}
    table = np.zeros((b, cfg.block_size // ps), np.int64)
    table[0, :2] = [7, 3]
    table[1, :3] = [1, 12, 5]
    table[2, :1] = [9]
    lens = np.asarray([5, 9, 2])
    tokens = rng.integers(0, VOCAB, b)
    want, jnew = jax.jit(lambda *a: jax_step(jm, *a))(  # one compile, not op by op
        jp, jpool, jnp.asarray(table, jnp.int32), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(lens, jnp.int32))
    got, new = paged_decode_step_rows(pm, None, pool, torch.from_numpy(table),
                                      torch.from_numpy(tokens), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for k in pool:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_engine_under_preemption_equals_jax():
    jm, jp, pm = lm_pair("quartet", scale=3.0)
    prompts = prompts_of([6, 5, 3, 7], seed=3)
    budgets = [9, 10, 8, 6]

    def run(eng):
        rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        res = eng.run()
        return [res[r] for r in rids]

    # the bucket bounds JAX's compiles; the tokens are those without it
    jeng = JaxPaged(jm, jp, max_batch=2, n_pages=5, page_size=4, prefill_buckets=[16])
    want = run(jeng)
    eng = PagedDecodeEngine(pm, None, max_batch=2, n_pages=5, page_size=4, prefill_buckets=[16])
    got = run(eng)
    assert eng.preemptions == jeng.preemptions > 0
    assert eng.peak_pages_in_use == jeng.peak_pages_in_use == 5
    assert eng.pages_in_use == jeng.pages_in_use == 0
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        _, margins = cached_ref(pm, None, p, n)
        assert_stream(got[i], want[i], margins, f"request {i}")
