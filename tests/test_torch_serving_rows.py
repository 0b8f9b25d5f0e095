"""The serving engine's batched decode in the port against the JAX package:
``decode_step_rows`` and ``decode_chunk_rows`` over a slot pool whose rows
sit at different lengths, for the four GPT kinds, with fp32 and bf16 pools
(JAX's ``decode_step_rows`` / ``decode_chunk_rows`` on the same pool):
logits and the written rows at rtol 2e-4 / atol 2e-5 (bf16: see
``BF16_ROWS``). The int8 pools and per-row LoRA factors are in
``test_torch_serving_rows_int8.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.serving import engine as JE
from mop_tpu_torch.serving import engine as PE

from _torch_serving_common import ATOL, RTOL, G, _one_torch_thread, lm_pair, to_torch  # noqa: F401

LENS = [3, 9, 6]  # the rows' live lengths before the step
KINDS = ["quartet", "baseline", "mop", "mop_causal"]


def _pool(pm, params, kv_dtype, seed=0):
    """A 3-slot pool (the port's cache dict, ``len`` dropped) whose row r
    holds a prefill of LENS[r] tokens, and the tokens fed next."""
    rng = np.random.default_rng(seed)
    cfg = pm.config
    pool = G.init_decode_cache(cfg, len(LENS), kv_dtype, n_views=G.model_n_views(pm),
                               device="cpu")
    del pool["len"]
    for r, n in enumerate(LENS):
        _, pc = G.prefill(pm, params, torch.from_numpy(rng.integers(0, 40, (1, n))),
                          kv_dtype=kv_dtype)
        for key in pool:
            pool[key][:, r] = pc[key][:, 0]
    return pool, torch.from_numpy(rng.integers(0, 40, (len(LENS), 3)))


def _to_jax(cache):
    return {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy(),
                           dtype=jnp.bfloat16 if v.dtype == torch.bfloat16 else None)
            for k, v in cache.items()}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# A bf16 pool stores rows rounded to 8 mantissa bits: a 1e-7 difference in
# fp32 flips a stored element by one bf16 ulp (2**-8 relative), which moves
# the later logits by up to about 1e-4 at this width.
BF16_ROWS = dict(rtol=2.0 ** -7, atol=ATOL)
BF16_LOGITS = dict(rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("kv", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_rows_equal_jax(kind, kv):
    kv_dtype = torch.float32 if kv == "fp32" else torch.bfloat16
    rows_tol = dict(rtol=RTOL, atol=ATOL) if kv == "fp32" else BF16_ROWS
    logits_tol = dict(rtol=RTOL, atol=ATOL) if kv == "fp32" else BF16_LOGITS
    jm, jp, pm = lm_pair(kind, scale=3.0)
    pp = to_torch(jax.device_get(jp))
    pool, toks = _pool(pm, pp, kv_dtype)
    lens = torch.tensor(LENS)
    jpool = _to_jax(pool)
    jpool["len"] = jnp.asarray(LENS, jnp.int32)
    want, jc = JE.decode_step_rows(jm, jp, dict(jpool), jnp.asarray(toks[:, 0].numpy()),
                                   jnp.asarray(LENS, jnp.int32))
    got, pc = PE.decode_step_rows(pm, pp, dict(pool), toks[:, 0], lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **logits_tol)
    assert pc["len"].tolist() == [n + 1 for n in LENS]
    for key in pool:
        np.testing.assert_allclose(pool[key].float().numpy(), _np(jc[key]), err_msg=key,
                                   **rows_tol)
    # then a chunk of 2 from the advanced lengths
    want_c, jc2 = JE.decode_chunk_rows(jm, jp, jc, jnp.asarray(toks[:, 1:].numpy()),
                                       jnp.asarray(LENS, jnp.int32) + 1)
    got_c, _ = PE.decode_chunk_rows(pm, pp, pool, toks[:, 1:], lens + 1)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **logits_tol)
    for key in pool:
        np.testing.assert_allclose(pool[key].float().numpy(), _np(jc2[key]), err_msg=key,
                                   **rows_tol)
