"""LoRA in the port against the JAX package: ``training.lora``'s
``lora_init`` (the JAX tree's paths and shapes, ``b`` zero) and
``lora_merge`` (equal to JAX's over the same adapters, carried by
``load_jax_adapters``); ``make_lora_lm_train_step`` with ``torch.optim.AdamW``
equal to JAX's with ``optax.adamw`` over three steps; and the engine's
adapter bank: a mixed batch (two adapters and the base model) equal to
JAX's ``DecodeEngine`` and to each request served alone, each adapter
request equal to ``generate_cached`` over ``lora_merge``'d weights (the
scale applied), and the prefix cache keyed by adapter."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu.training import lora as JL
from mop_tpu_torch.models.generate import decode_params
from mop_tpu_torch.serving import DecodeEngine
from mop_tpu_torch.training import lora as PL
from mop_tpu_torch.utils.jax_weights import _flatten, load_jax_adapters

from _torch_serving_common import (ATOL, RTOL, G, _one_torch_thread, lm_pair,  # noqa: F401
                                   prompts_of, to_torch)


def _adapter(jp, seed, rank=2, b_std=0.3):
    """JAX ``lora_init`` factors with a nonzero ``b`` (a zero ``b`` would make
    the delta vanish), as numpy."""
    ad = JL.lora_init(jax.random.PRNGKey(seed), jp, rank=rank)
    rng = np.random.default_rng(seed)
    return {p: {"a": np.asarray(f["a"]) * 10.0,
                "b": rng.standard_normal(f["b"].shape).astype(np.float32) * b_std}
            for p, f in ad.items()}


def test_init_and_merge_equal_jax():
    _, jp, pm = lm_pair("mop", scale=3.0)
    want_init = JL.lora_init(jax.random.PRNGKey(0), jp, rank=3)
    got_init = PL.lora_init(torch.Generator().manual_seed(0), decode_params(pm), rank=3)
    assert sorted(got_init) == sorted(want_init)
    for p in want_init:
        assert tuple(got_init[p]["a"].shape) == want_init[p]["a"].shape
        assert not got_init[p]["b"].any() and not np.asarray(want_init[p]["b"]).any()
    a = torch.cat([f["a"].flatten() for f in got_init.values()])
    assert abs(float(a.std()) - 0.02) < 0.004
    assert PL.lora_param_count(got_init) == JL.lora_param_count(want_init)
    ad = _adapter(jp, 1)
    want = _flatten(jax.device_get(JL.lora_merge(jp, ad, scale=0.5)))
    got = _flatten(PL.lora_merge(to_torch(jax.device_get(jp)), load_jax_adapters(ad), scale=0.5))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    with pytest.raises(ValueError, match="matched no kernels"):
        PL.lora_init(torch.Generator(), decode_params(pm), 2, match=lambda p, w: False)


def test_lm_train_step_equals_jax():
    jm, jp, pm = lm_pair("quartet", scale=1.0)
    ad = _adapter(jp, 2, b_std=0.05)
    idx = prompts_of([12, 12], seed=130)
    idx_j = jnp.asarray(idx)
    tgt_j = jnp.roll(idx_j, -1, axis=1)
    tx = optax.adamw(1e-2, weight_decay=1e-4)
    jstep = JL.make_lora_lm_train_step(jm, jp, tx)
    jad, ost = jax.tree_util.tree_map(jnp.asarray, ad), tx.init(jax.tree_util.tree_map(
        jnp.asarray, ad))
    pad = load_jax_adapters(ad)
    base = decode_params(pm)
    opt = torch.optim.AdamW(PL.lora_parameters(pad), lr=1e-2, weight_decay=1e-4)
    pstep = PL.make_lora_lm_train_step(pm, base, opt)
    snapshot = {k: v.clone() for k, v in pm.state_dict().items()}
    for _ in range(3):
        jad, ost, jloss = jstep(jad, ost, idx_j, tgt_j)
        ploss = pstep(pad, torch.tensor(idx), torch.tensor(np.asarray(tgt_j)))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL, atol=ATOL)
    for p in ad:
        for k in ("a", "b"):
            np.testing.assert_allclose(pad[p][k].detach().numpy(), np.asarray(jad[p][k]),
                                       rtol=1e-3, atol=1e-5, err_msg=f"{p}/{k}")
    for k, v in pm.state_dict().items():  # the base weights never move
        assert torch.equal(v, snapshot[k]), k


def _mixed(eng, prompts, names):
    rids = [eng.submit(p, 8, adapter=nm) for p, nm in zip(prompts, names)]
    res = eng.run()
    return [res[r] for r in rids]


def test_adapter_bank_equals_jax_merge_and_solo():
    jm, jp, pm = lm_pair("quartet", scale=2.0)
    pp = to_torch(jax.device_get(jp))
    bank = {"x": _adapter(jp, 3), "y": _adapter(jp, 4)}
    prompts = prompts_of([3, 2, 4], seed=131)
    names = ["x", None, "y"]
    want = _mixed(JaxEngine(jm, jp, max_batch=4, prefill_buckets=[16],
                            adapters={k: jax.tree_util.tree_map(jnp.asarray, v)
                                      for k, v in bank.items()}), prompts, names)
    pbank = {k: load_jax_adapters(v) for k, v in bank.items()}
    got = _mixed(DecodeEngine(pm, pp, max_batch=4, adapters=pbank), prompts, names)
    assert got == want and len({tuple(g) for g in got}) == 3
    for i, (p, nm) in enumerate(zip(prompts, names)):
        solo = DecodeEngine(pm, pp, max_batch=4, adapters=pbank)
        assert _mixed(solo, [p], [nm]) == [got[i]]
        merged = pp if nm is None else PL.lora_merge(pp, pbank[nm])
        assert got[i] == G.generate_cached(pm, merged, torch.tensor([p]), 8)[0, len(p):].tolist()


def test_adapter_scale_prefix_keying_and_checks():
    _, jp, pm = lm_pair("mop_causal", scale=2.0)
    pp = to_torch(jax.device_get(jp))
    ad = load_jax_adapters(_adapter(jp, 5))
    assert any("views" in p for p in ad)  # GPT-MoP's views projection is adapted too
    eng = DecodeEngine(pm, pp, max_batch=2, adapters={"x": ad}, adapter_scale={"x": 2.5},
                       prefix_cache_entries=4)
    prompt = prompts_of([6], seed=132)[0]

    def ref(params, p):
        return G.generate_cached(pm, params, torch.tensor([p]), 6)[0, len(p):].tolist()

    merged = PL.lora_merge(pp, ad, scale=2.5)
    r1 = eng.submit(prompt, 6, adapter="x")
    assert eng.run()[r1] == ref(merged, prompt)
    r2 = eng.submit(prompt, 6)  # the base model must not reuse x's rows
    assert eng.run()[r2] == ref(pp, prompt) and eng.prefix_cache_hits == 0
    r3 = eng.submit(prompt + [2], 6, adapter="x")  # the same adapter does
    assert eng.run()[r3] == ref(merged, prompt + [2]) and eng.prefix_cache_hits == 1
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit([1, 2], 4, adapter="nope")
    with pytest.raises(ValueError, match="rank"):
        DecodeEngine(pm, pp, adapters={"x": ad, "y": load_jax_adapters(_adapter(jp, 6, rank=4))})
    with pytest.raises(ValueError, match="not found"):
        DecodeEngine(pm, pp, adapters={"x": {"params/nope/kernel": {
            "a": torch.zeros(4, 2), "b": torch.zeros(2, 4)}}})
