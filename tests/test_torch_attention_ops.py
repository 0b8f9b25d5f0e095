"""The PyTorch port's score algebra (``mop_tpu_torch.ops.attention``) and the
E-mode helpers against their JAX twins, fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models.attention_variants as jav
import mop_tpu.ops.attention as ja
import mop_tpu_torch.models.attention_variants as tav
import mop_tpu_torch.ops.attention as ta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
N = 12


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _softmaxes(seed, count):
    return [np.array(jax.nn.softmax(jnp.asarray(a), -1))
            for a in _arrays(seed, *[(2, 3, N, N)] * count)]


def _gates(seed):
    return [1.0 / (1.0 + np.exp(-a)) for a in _arrays(seed, *[(2, 3, N, N)] * 4)]


def _mask():
    rng = np.random.default_rng(7)
    m = (rng.random((1, 1, N, N)) > 0.3).astype(np.float32)
    m[..., 0] = 1.0  # every row keeps one key
    return m


# name -> (JAX fn, port fn, inputs); both functions take the same numpy-made
# inputs, converted to each framework's arrays.
CASES = {
    "apply_mask": (ja.apply_mask, ta.apply_mask,
                   lambda: _arrays(0, (2, 3, N, N)) + [_mask()]),
    "masked_softmax": (ja.masked_softmax, ta.masked_softmax,
                       lambda: _arrays(1, (2, 3, N, N)) + [_mask()]),
    "scaled_scores": (ja.scaled_scores, ta.scaled_scores,
                      lambda: _arrays(2, (2, 3, N, 8), (2, 3, N, 8))),
    "lse_pair": (ja.lse_pair, ta.lse_pair, lambda: _arrays(3, (2, 3, N, N), (2, 3, N, N))),
    "lse_stack": (lambda *s: ja.lse_stack(list(s)), lambda *s: ta.lse_stack(list(s)),
                  lambda: _arrays(4, *[(2, 3, N, N)] * 4)),
    "chain_product": (lambda *a: ja.chain_product(list(a)),
                      lambda *a: ta.chain_product(list(a)), lambda: _softmaxes(5, 4)),
    "multihop_logit_mix": (
        lambda s1, s2, c: ja.multihop_logit_mix(
            s1, s2, c, dict(and_=0.7, or_=0.4, not_=0.3, chain=0.6), 0.5),
        lambda s1, s2, c: ta.multihop_logit_mix(
            s1, s2, c, dict(and_=0.7, or_=0.4, not_=0.3, chain=0.6), 0.5),
        lambda: _arrays(6, (2, 3, N, N), (2, 3, N, N)) + _softmaxes(7, 1)),
    "edgewise_logit_mix": (
        lambda s1, s2, s3, g0, g1, g2, g3, lc: ja.edgewise_logit_mix(
            [s1, s2, s3], g0, g1, g2, g3, lc, 0.7),
        lambda s1, s2, s3, g0, g1, g2, g3, lc: ta.edgewise_logit_mix(
            [s1, s2, s3], g0, g1, g2, g3, lc, 0.7),
        lambda: _arrays(8, *[(2, 3, N, N)] * 3) + _gates(9) + _arrays(10, (2, 3, N, N))),
    "standardize_scores": (ja.standardize_scores, ta.standardize_scores,
                           lambda: _arrays(11, (2, 3, N, N))),
    "standardize_scores_causal": (ja.standardize_scores_causal,
                                  ta.standardize_scores_causal,
                                  lambda: _arrays(12, (2, 3, N, N))),
    "attend": (ja.attend, ta.attend, lambda: _arrays(13, *[(2, 3, N, 8)] * 3)),
    "attend_masked": (lambda q, k, v: ja.attend(q, k, v, ja.causal_mask(N)),
                      lambda q, k, v: ta.attend(q, k, v, ta.causal_mask(N)),
                      lambda: _arrays(14, *[(2, 3, N, 8)] * 3)),
    "causal_mask": (lambda: ja.causal_mask(N), lambda: ta.causal_mask(N), lambda: []),
    "split_heads": (lambda x: jav._split_heads(x, 4), lambda x: tav._split_heads(x, 4),
                    lambda: _arrays(15, (2, N, 32))),
    "merge_heads": (jav._merge_heads, tav._merge_heads, lambda: _arrays(16, (2, 4, N, 8))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    jfn, tfn, make = CASES[name]
    ins = make()
    want = np.asarray(jfn(*[jnp.asarray(a) for a in ins]))
    got = tfn(*[torch.from_numpy(a) for a in ins]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gate_init", ["neutral", "and", "or", "not", "chain", "nor",
                                       "xor", "mix5"])
@pytest.mark.parametrize("rank", [1, 4])
def test_gate_bias_presets_match_jax(gate_init, rank):
    np.testing.assert_array_equal(
        tav._preset_block_bias(gate_init, rank, 4 * rank).numpy(),
        np.asarray(jav._preset_block_bias(gate_init, rank, 4 * rank)))
    np.testing.assert_array_equal(tav._dense_head_bias(gate_init).numpy(),
                                  np.asarray(jav._dense_head_bias(gate_init)))
