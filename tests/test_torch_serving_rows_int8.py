"""The serving engine's batched decode in the port against the JAX package,
the int8 and LoRA cases: int8 pools with per-row scales (JAX's engine has
no int8 pool, so each row is held to JAX's single-stream ``decode_step`` /
``decode_chunk`` over its int8 row) and per-row LoRA factors
(``lora_params_view`` read by ``_lin``'s per-row branch) against JAX's
``decode_step_rows``: logits and rows at rtol 2e-4 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mop_tpu.models.generate import decode_chunk as jax_chunk
from mop_tpu.models.generate import decode_step as jax_step
from mop_tpu.serving import engine as JE
from mop_tpu_torch.serving import engine as PE

from _torch_serving_common import ATOL, RTOL, _one_torch_thread, lm_pair, to_torch  # noqa: F401
from test_torch_serving_rows import LENS, _np, _pool, _to_jax


@pytest.mark.parametrize("kind", ["quartet", "mop_causal"])
def test_int8_rows_equal_jax_single_stream(kind):
    """JAX's engine has no int8 pool; each int8 row is held to JAX's
    single-stream int8 decode over that row."""
    jm, jp, pm = lm_pair(kind, scale=3.0)
    pp = to_torch(jax.device_get(jp))
    pool, toks = _pool(pm, pp, torch.int8, seed=1)
    rows = [{k: v[:, r:r + 1].clone() for k, v in pool.items()} for r in range(len(LENS))]
    got, _ = PE.decode_step_rows(pm, pp, pool, toks[:, 0], torch.tensor(LENS))
    got_c, _ = PE.decode_chunk_rows(pm, pp, pool, toks[:, 1:], torch.tensor(LENS) + 1)
    for r, n in enumerate(LENS):
        jc = _to_jax(rows[r])
        jc["len"] = jnp.asarray(n, jnp.int32)
        want, jc = jax_step(jm, jp, jc, jnp.asarray(toks[r:r + 1, 0].numpy()))
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
        want_c, jc = jax_chunk(jm, jp, jc, jnp.asarray(toks[r:r + 1, 1:].numpy()))
        np.testing.assert_allclose(got_c[r].numpy(), np.asarray(want_c[0]), rtol=RTOL,
                                   atol=ATOL)
        for key in ("k", "k_s", "v", "v_s"):
            np.testing.assert_allclose(pool[key][:, r:r + 1].float().numpy(), _np(jc[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def test_lora_rows_equal_jax():
    """Per-row LoRA factors (row 0 none, rows 1 and 2 two adapters) through
    ``lora_params_view`` and ``_lin``'s per-row branch."""
    jm, jp, pm = lm_pair("quartet", scale=3.0)
    pp = to_torch(jax.device_get(jp))
    rng = np.random.default_rng(5)
    rows = {}
    for path, (din, dout) in {"params/blocks_0/attn/q_proj/kernel": (32, 32),
                              "params/blocks_1/mlp/fc/kernel": (32, 128)}.items():
        a = rng.standard_normal((3, din, 2)).astype(np.float32) * 0.3
        b = rng.standard_normal((3, 2, dout)).astype(np.float32) * 0.3
        a[0] = 0.0
        rows[path] = (a, b)
    pool, toks = _pool(pm, pp, torch.float32, seed=2)
    jpool = _to_jax(pool)
    jpool["len"] = jnp.asarray(LENS, jnp.int32)
    jview = JE.lora_params_view(jp, {k: (jnp.asarray(a), jnp.asarray(b))
                                     for k, (a, b) in rows.items()})
    pview = PE.lora_params_view(pp, {k: (torch.from_numpy(a), torch.from_numpy(b))
                                     for k, (a, b) in rows.items()})
    assert "lora_a" not in pp["params"]["blocks_0"]["attn"]["q_proj"]  # a view, not an edit
    want, _ = JE.decode_step_rows(jm, jview, jpool, jnp.asarray(toks[:, 0].numpy()),
                                  jnp.asarray(LENS, jnp.int32))
    got, _ = PE.decode_step_rows(pm, pview, pool, toks[:, 0], torch.tensor(LENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    base, _ = PE.decode_step_rows(pm, pp, _pool(pm, pp, torch.float32, seed=2)[0], toks[:, 0],
                                  torch.tensor(LENS))
    np.testing.assert_allclose(got[0].numpy(), base[0].numpy(), rtol=1e-6, atol=1e-6)
    assert not np.allclose(got[1].numpy(), base[1].numpy(), atol=1e-3)
