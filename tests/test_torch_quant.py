"""Weight-only int8 / int4 quantization in the port against the JAX package
(``mop_tpu.ops.quant``): the int8 bytes and scales and the nibble-packed
int4 bytes and scales exactly (the clip ratios JAX's float32 values), the
unpack and dequant, ``qmatmul`` / ``q4matmul`` within the golden tolerance,
the same leaves quantized by ``quantize_params`` over ``decode_params``,
``quantized_bytes`` and ``dequantize_params`` equal, and the cached decode
(``prefill``, ``decode_step``, ``decode_chunk``, ``generate_cached``) with
int8 and int4 weights against JAX's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.ops.quant as JQ
import mop_tpu_torch.ops.quant as PQ
from _torch_decode_common import (ATOL, RTOL, _one_torch_thread,  # noqa: F401
                                  assert_tokens_up_to_tie, lm_pair, margin, prompt_of,
                                  to_torch)

JG = importlib.import_module("mop_tpu.models.generate")
G = importlib.import_module("mop_tpu_torch.models.generate")


def _w(shape, seed=0, scale=0.05, outliers=False):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if outliers:  # one row a group at 8x, where the clip search moves the scale
        w[::16] *= 8.0
    return w


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,axis", [((64, 96), -1), ((33, 20), -1), ((48, 24), 0),
                                        ((4, 6, 10), 1)])
def test_quantize_int8_equals_jax(shape, axis):
    w = _w(shape, seed=1)
    w.flat[3] = 0.0
    got, want = PQ.quantize(torch.from_numpy(w), axis), JQ.quantize(jnp.asarray(w), axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    _eq(got.q, want.q)
    _eq(got.scale, want.scale)
    _eq(got.dequant(), want.dequant())


def test_clip_ratios_are_jax_float32_values():
    _eq(PQ._clip_ratios(16, "cpu"), jnp.linspace(0.65, 1.0, 16))
    np.testing.assert_allclose(PQ._clip_ratios(7, "cpu").numpy(), np.asarray(
        jnp.linspace(0.65, 1.0, 7)), rtol=1e-7, atol=0)


@pytest.mark.parametrize("shape,group,clip", [((128, 48), 32, 16), ((256, 64), 64, 16),
                                              ((128, 48), 32, 0), ((10, 4), 64, 16),
                                              ((96, 40), 16, 16)])
def test_quantize4_bytes_and_scales_equal_jax(shape, group, clip):
    w = _w(shape, seed=2, outliers=True)
    got = PQ.quantize4(torch.from_numpy(w), group=group, clip_search=clip)
    want = JQ.quantize4(jnp.asarray(w), group=group, clip_search=clip)
    assert got.q.dtype == torch.int8 and got.group == want.group
    _eq(got.q, want.q)
    _eq(got.scale, want.scale)
    _eq(got.unpack(), want.unpack())
    _eq(got.dequant(), want.dequant())


def test_quantize4_rejects_odd_dims():
    with pytest.raises(ValueError, match="even input dim"):
        PQ.quantize4(torch.ones(9, 4))
    with pytest.raises(ValueError, match="group must be even"):
        PQ.quantize4(torch.ones(18, 4), group=9)


@pytest.mark.parametrize("bits", [8, 4])
def test_matmuls_equal_jax(bits):
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    w = _w((64, 32), seed=4, scale=0.1)
    if bits == 8:
        got = PQ.qmatmul(torch.from_numpy(x), PQ.quantize(torch.from_numpy(w)))
        want = JQ.qmatmul(jnp.asarray(x), JQ.quantize(jnp.asarray(w)))
    else:
        got = PQ.q4matmul(torch.from_numpy(x), PQ.quantize4(torch.from_numpy(w), group=16))
        want = JQ.q4matmul(jnp.asarray(x), JQ.quantize4(jnp.asarray(w), group=16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _leaf_kinds(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or (hasattr(v, "items") and not hasattr(v, "dequant")):
            out.update(_leaf_kinds(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = type(v).__name__ if hasattr(v, "dequant") else "dense"
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or (hasattr(v, "items") and not hasattr(v, "dequant")):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("kind", ["quartet", "mop"])
@pytest.mark.parametrize("bits,min_size", [(8, 4096), (8, 0), (4, 0), (4, 2048)])
def test_quantize_params_equals_jax(kind, bits, min_size):
    """At 64 wide every linear kernel but GPT-MoP's views (64 x 2) has at
    least 4096 elements: the same leaves quantized at each threshold, each
    with JAX's bytes and scales; embeddings, LayerNorms, convs and the
    Quartet scalars dense."""
    _, params, pm = lm_pair(kind, n_embd=64)
    got = PQ.quantize_params(G.decode_params(pm), min_size=min_size, bits=bits, group=16)
    want = JQ.quantize_params(params, min_size=min_size, bits=bits, group=16)
    kinds = _leaf_kinds(got)
    assert kinds == _leaf_kinds(want)
    assert kinds["params.blocks_0.mlp.fc.kernel"] == ("QTensor" if bits == 8 else "Q4Tensor")
    assert kinds["params.wte.embedding"] == kinds["params.blocks_0.ln1.scale"] == "dense"
    wl = dict(_leaves(want))
    for k, v in _leaves(got):
        if hasattr(v, "dequant"):
            _eq(v.q, wl[k].q)
            _eq(v.scale, wl[k].scale)
        else:
            _eq(v, wl[k])
    assert PQ.quantized_bytes(got) == JQ.quantized_bytes(want)
    dq, wdq = dict(_leaves(PQ.dequantize_params(got))), dict(_leaves(JQ.dequantize_params(want)))
    for k in wdq:
        _eq(dq[k], wdq[k])
    with pytest.raises(ValueError, match="bits"):
        PQ.quantize_params(got, bits=2)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decode_equals_jax(bits):
    """``prefill``, two ``decode_step``s and a ``decode_chunk`` with int8 or
    int4 weights (every kernel) against JAX's, and ``generate_cached``'s
    tokens up to the first near tie."""
    jm, params, pm = lm_pair("quartet", scale=3.0, n_embd=64, block_size=32)
    jq = JQ.quantize_params(params, min_size=0, bits=bits, group=16)
    pq = PQ.quantize_params(G.decode_params(pm), min_size=0, bits=bits, group=16)
    prompt, toks = prompt_of((2, 6), seed=5), prompt_of((2, 5), seed=6)
    jl, jc = JG.prefill(jm, jq, jnp.asarray(prompt))
    pl, pc = G.prefill(pm, pq, torch.from_numpy(prompt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for i in range(2):
        jl, jc = JG.decode_step(jm, jq, jc, jnp.asarray(toks[:, i]))
        pl, pc = G.decode_step(pm, pq, pc, torch.from_numpy(toks[:, i]).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    jl, jc = JG.decode_chunk(jm, jq, jc, jnp.asarray(toks[:, 2:]))
    pl, pc = G.decode_chunk(pm, pq, pc, torch.from_numpy(toks[:, 2:]).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    # the quantized JAX tree itself, converted, decodes alike
    np.testing.assert_allclose(G.prefill(pm, to_torch(jq), torch.from_numpy(prompt))[0].numpy(),
                               G.prefill(pm, pq, torch.from_numpy(prompt))[0].numpy(),
                               rtol=0, atol=0)
    want = np.asarray(JG.generate_cached(jm, jq, jnp.asarray(prompt), 8))
    got = G.generate_cached(pm, pq, torch.from_numpy(prompt), 8)
    jl, jc = JG.prefill(jm, jq, jnp.asarray(prompt))
    logits = [jl]
    for i in range(7):
        jl, jc = JG.decode_step(jm, jq, jc, jnp.asarray(want[:, 6 + i]))
        logits.append(jl)
    assert_tokens_up_to_tie(got[:, 6:], want[:, 6:], margin(np.stack(logits, 1)))
