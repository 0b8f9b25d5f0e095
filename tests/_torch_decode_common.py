"""Shared set-up of the decode tests (``test_torch_generate.py``,
``test_torch_quant.py``, ``test_torch_beam.py``, ``test_torch_speculative.py``):
the same GPT from the JAX package and the port, with the JAX weights loaded
into the port's model, at the golden tests' size; the JAX tree as torch
tensors; and the token-stream comparison up to the first near tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu_torch.utils.jax_weights import load_jax_params

RTOL, ATOL = 2e-4, 2e-5  # tests/test_golden_numerics.py:33
TIE = 1e-4  # a top-two logit margin below this is a near tie
VOCAB = 40
CFG = dict(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=16, bias=False)
# kind -> (JAX factory, port factory, config overrides, factory kwargs)
KINDS = {
    "quartet": (J.create_gpt_quartet, PM.create_gpt_quartet, {}, {}),
    "baseline": (J.create_gpt_baseline, PM.create_gpt_baseline, {}, {}),
    "mop": (J.create_gpt_mop, PM.create_gpt_mop, {}, dict(n_views=2, n_kernels=1)),
    "mop_causal": (J.create_gpt_mop_causal, PM.create_gpt_mop_causal, {},
                   dict(n_views=3, n_kernels=2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lm_pair(kind="quartet", seed=1, vocab=VOCAB, scale=1.0, **cfg):
    """(JAX model, JAX params, port model) of one GPT kind, the port's
    weights the JAX init's (every 2-D kernel times ``scale``, so that the
    logits spread)."""
    jfac, pfac, over, kw = KINDS[kind]
    c = {**CFG, **over, **cfg}
    jm = jfac(vocab, J.TransformerConfig(**c), **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
    if scale != 1.0:
        params = jax.tree_util.tree_map_with_path(
            lambda path, w: w * scale if jax.tree_util.keystr(path).endswith("['kernel']")
            and w.ndim == 2 else w, params)
    pm = load_jax_params(pfac(vocab, PM.TransformerConfig(**c), device="cpu", **kw), params)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm.eval()


def to_torch(tree):
    """A JAX tree (nested dicts of arrays, ``QTensor`` / ``Q4Tensor`` leaves
    too) as the port's: nested dicts of CPU tensors."""
    from mop_tpu.ops import quant as JQ
    from mop_tpu_torch.ops import quant as PQ

    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, JQ.QTensor):
        return PQ.QTensor(q=to_torch(tree.q), scale=to_torch(tree.scale))
    if isinstance(tree, JQ.Q4Tensor):
        return PQ.Q4Tensor(q=to_torch(tree.q), scale=to_torch(tree.scale), group=tree.group)
    return torch.tensor(np.asarray(tree))


def prompt_of(shape, seed=0, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def assert_tokens_up_to_tie(got, want, margins):
    """``got`` equals ``want`` (B, T) in every row up to that row's first
    step whose top-two margin (B, T) is below ``TIE``, and the rows hold at
    least one step before any tie."""
    got, want, margins = (np.asarray(a) for a in (got, want, margins))
    for r in range(want.shape[0]):
        ties = np.nonzero(margins[r] < TIE)[0]
        stop = ties[0] if len(ties) else want.shape[1]
        assert stop > 0, f"row {r}: a near tie at the first step"
        np.testing.assert_array_equal(got[r, :stop], want[r, :stop], err_msg=f"row {r}")


def margin(logits):
    """Top-two margins of (..., V) logits."""
    top = np.sort(np.asarray(logits), -1)
    return top[..., -1] - top[..., -2]
