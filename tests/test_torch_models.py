"""The port's ViT models A (ViT_Baseline), B (ViT_MoP) and E (ViTEdgewise)
against the JAX models from the same init, and A/B against the torch
reference goldens (``tests/golden/*.npz``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.utils.torch_port import load_golden
from mop_tpu_torch.models import EdgewiseMSA
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL, ATOL = 2e-4, 2e-5  # tests/test_golden_numerics.py

SMALL = dict(dim=32, depth=2, heads=4, n_classes=10, drop_path=0.0)
E_KW = dict(n_views=5, gate_mode="lowrank", gate_rank=4, gate_init="mix5", share_qkv=False)
MODELS = {
    "A": (lambda: J.ViT_Baseline(**SMALL), lambda **d: P.ViT_Baseline(**SMALL, **d)),
    "B": (lambda: J.ViT_MoP(**SMALL, n_views=3, n_kernels=2),
          lambda **d: P.ViT_MoP(**SMALL, n_views=3, n_kernels=2, **d)),
    "E": (lambda: J.ViTEdgewise(**SMALL, **E_KW),
          lambda **d: P.ViTEdgewise(**SMALL, **E_KW, **d)),
    "E_shared": (lambda: J.ViTEdgewise(**SMALL, n_views=3, gate_mode="lowrank", gate_rank=2,
                                       gate_init="and", share_qkv=True),
                 lambda **d: P.ViTEdgewise(**SMALL, n_views=3, gate_mode="lowrank",
                                           gate_rank=2, gate_init="and", share_qkv=True, **d)),
    "E_dense": (lambda: J.ViTEdgewise(**SMALL, n_views=3, gate_mode="dense", gate_init="and"),
                lambda **d: P.ViTEdgewise(**SMALL, n_views=3, gate_mode="dense",
                                          gate_init="and", **d)),
}


def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 3, 32, 32)).astype(np.float32)


def _pair(name, seed=1):
    jctor, pctor = MODELS[name]
    jm = jctor()
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(_images()))
    pm = load_jax_params(pctor(device="cpu"), jax.device_get(params)).eval()
    return jm, params, pm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_match_jax(name):
    jm, params, pm = _pair(name)
    x = _images(seed=2)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trainable_param_counts_match_jax(name):
    jm, params, pm = _pair(name)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in pm.parameters() if p.requires_grad) == n_jax


def test_gate_maps_match_jax():
    jm, params, pm = _pair("B")
    x = _images(seed=3)
    want = jm.apply(params, jnp.asarray(x), method=jm.get_gate_maps)
    with torch.no_grad():
        got = pm.get_gate_maps(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,ctor", [
    ("vit_baseline", lambda: P.ViT_Baseline(**SMALL, device="cpu")),
    ("vit_mop", lambda: P.ViT_MoP(**SMALL, n_views=3, n_kernels=2, device="cpu")),
])
def test_reference_golden(name, ctor):
    """The torch reference's own state dict loads by name and reproduces its outputs."""
    ins, ws, outs = load_golden(os.path.join(GOLDEN, f"{name}.npz"))
    model = ctor().eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ws.items()},
                          strict=True)
    x = torch.from_numpy(ins["x"])
    with torch.no_grad():
        got = {"y": model(x)}
        if name == "vit_mop":
            got["gate"], got["views"], got["kernels"] = model.get_gate_maps(x)
    assert set(got) == set(outs)
    for k, expect in outs.items():
        np.testing.assert_allclose(got[k].numpy(), expect, rtol=RTOL, atol=ATOL, err_msg=k)


# The full-width 5M-parameter configs of the ab5 comparison (and bench.py's B).
FULL = {
    "A": (lambda: J.ViT_Baseline(dim=224, depth=8, heads=4, n_classes=100),
          lambda: P.ViT_Baseline(dim=224, depth=8, heads=4, n_classes=100, device="cpu"),
          4_872_000),
    "B": (lambda: J.ViT_MoP(dim=216, depth=8, heads=4, n_classes=100, n_views=5, n_kernels=3),
          lambda: P.ViT_MoP(dim=216, depth=8, heads=4, n_classes=100, n_views=5, n_kernels=3,
                            device="cpu"),
          4_534_044),
    "B_bench": (lambda: J.ViT_MoP(dim=224, depth=6, heads=4, n_classes=100, n_views=5,
                                  n_kernels=3),
                lambda: P.ViT_MoP(dim=224, depth=6, heads=4, n_classes=100, n_views=5,
                                  n_kernels=3, device="cpu"),
                3_667_956),
    "E": (lambda: J.ViTEdgewise(dim=224, depth=4, heads=4, n_classes=100, **E_KW),
          lambda: P.ViTEdgewise(dim=224, depth=4, heads=4, n_classes=100, **E_KW,
                                device="cpu"),
          4_870_084),
    # The reference's default E head: E_KW with gate_mode="dense", neutral init.
    "E_dense": (lambda: J.ViTEdgewise(dim=224, depth=4, heads=4, n_classes=100, n_views=5,
                                      gate_mode="dense"),
                lambda: P.ViTEdgewise(dim=224, depth=4, heads=4, n_classes=100, n_views=5,
                                      gate_mode="dense", device="cpu"),
                4_869_524),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_config_param_counts(name):
    jctor, pctor, expect = FULL[name]
    jm = jctor()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))))
    assert sum(a.size for a in jax.tree_util.tree_leaves(shapes)) == expect
    assert sum(p.numel() for p in pctor().parameters()) == expect


@pytest.mark.parametrize("name", sorted(MODELS))
def test_generator_seeds_the_init(name):
    _, pctor = MODELS[name]
    a = pctor(device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    b = pctor(device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    c = pctor(device="cpu", generator=torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_init_follows_reference_distributions():
    m = P.ViTEdgewise(dim=64, depth=1, heads=4, n_classes=10, **E_KW, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    sd = m.state_dict()
    w = sd["blocks.0.mlp.fc1.weight"]
    bound = 1.0 / np.sqrt(64)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert abs(sd["pos"].std().item() - 0.02) < 0.002
    assert torch.equal(sd["blocks.0.ln1.weight"], torch.ones(64))
    assert sd["blocks.0.attn.chain_value_logit"].item() == -2.0
    c = float(np.sqrt(2.0 / 4))  # mix5: sqrt(2/r) on the and/or/not rank blocks
    torch.testing.assert_close(sd["blocks.0.attn.edge_head.row_proj.bias"],
                               torch.tensor([c] * 12 + [0.0] * 4))


@pytest.mark.parametrize("ctor", [
    lambda: P.ViT_Baseline(**SMALL),
    lambda: P.ViT_MoP(**SMALL),
    lambda: P.ViTEdgewise(**SMALL, **E_KW),
])
def test_entry_points_default_to_the_gpu(ctor, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctor()


def test_drop_path_drops_whole_samples_in_training_only():
    from mop_tpu_torch.models import DropPath

    dp = DropPath(0.5)
    dp.generator = torch.Generator().manual_seed(0)  # never the global RNG
    x = torch.ones(64, 4, 8)
    y = dp.train()(x)
    per_sample = y.reshape(64, -1)
    assert set(per_sample.min(1).values.tolist()) <= {0.0, 2.0}
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    assert 0 < int((per_sample[:, 0] == 0).sum()) < 64
    assert torch.equal(dp.eval()(x), x)


@pytest.mark.parametrize("ctor", [
    lambda: P.ViT_MoP(**SMALL, use_moe=True, device="cpu"),
    lambda: P.models.MSA(32, 4, attn_drop=0.1),
    lambda: EdgewiseMSA(32, 4, attn_drop=0.1),
], ids=["ctor0", "ctor1", "ctor2"])
def test_unported_options_raise(ctor):
    """Each option that raised here when it was not ported is ported since.
    The MoE encoder builds, and its routed impl at a capacity that holds
    every token gives the dense impl's logits (test_torch_moe.py holds both
    against the JAX model). Attention dropout in MSA and EdgewiseMSA builds,
    and in eval mode it computes what the same weights compute at rate 0
    (test_torch_attention_dropout.py holds its training mode against the
    JAX module's definition)."""
    m = ctor().eval()
    if isinstance(m, P.ViT_MoP):
        x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
        got = m(x)
        for mlp in m.enc.blocks:
            mlp.mlp.impl, mlp.mlp.capacity_factor = "routed", 4.0
        torch.testing.assert_close(got, m(x), rtol=2e-4, atol=2e-5)
        assert got.shape == (2, SMALL["n_classes"])
        return
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(0))
    got = m(x)
    m.attn_drop.p = 0.0
    torch.testing.assert_close(got, m(x), rtol=0, atol=0)


def test_jax_weights_fail_loudly():
    jm, params, _ = _pair("A")
    tree = jax.device_get(params)["params"]
    extra = {**tree, "stray": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(P.ViT_Baseline(**SMALL, device="cpu"), extra)
    missing = {k: v for k, v in tree.items() if k != "cls"}
    with pytest.raises(KeyError, match="cls.weight"):
        load_jax_params(P.ViT_Baseline(**SMALL, device="cpu"), missing)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(P.ViT_Baseline(**{**SMALL, "n_classes": 9}, device="cpu"), tree)
