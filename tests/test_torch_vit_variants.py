"""The C, D and two-hop gated ViTs of the port (``ViTCrossView``,
``ViTMultiHop``, ``ViTGated``) against the JAX models with transplanted
weights: logits and the eval step's counts (D and Gated through K4's plain
version, one call a block), one train step's loss and grads (composed, no
kernel), and the parameter counts at the experiments' full width."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.ops.preprocess as jpp
import mop_tpu_torch as P
import mop_tpu_torch.ops.fused as TF
from mop_tpu.parallel import make_classifier_eval_step as jax_eval_step
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_mesh
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G_ATOL, G_RTOL = 1e-4, 1e-3
MEAN, STD = jpp.CIFAR100_MEAN, jpp.CIFAR100_STD
SMALL = dict(dim=32, depth=2, heads=4, n_classes=10, drop_path=0.0)
GATES = dict(base=0.9, and_=1.0, or_=0.5, not_=0.25, chain=0.75)
# name -> (JAX class, port class, kwargs, K4 calls per eval forward)
VITS = {
    "D": (J.ViTMultiHop, P.ViTMultiHop, dict(gates=GATES, hops=3), 2),
    "Gated": (J.ViTGated, P.ViTGated, dict(gates=GATES, beta_not=0.6), 2),
    "C": (J.ViTCrossView, P.ViTCrossView,
          dict(use_transpose_cues=True, t1=0.1, enable_per_key_prior=True,
               anchor_mode="fixed", fixed_k_star=3), 0),
}


def _batch(seed, b=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 3, 32, 32), dtype=np.uint8),
            rng.integers(0, 10, (b,)).astype(np.int32))


def _vit_pair(name):
    jcls, pcls, kw, _ = VITS[name]
    jm = jcls(**SMALL, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 3, 32, 32))))
    rng = np.random.default_rng(1)
    for key, leaf in params["params"].items():  # move the scalar leaves off their init
        if "chain_value_logit" in leaf:
            leaf["chain_value_logit"] = np.float32(rng.uniform(-1.0, 1.0))
        if "mix" in leaf:
            leaf["mix"] = (np.eye(2) + 0.3 * rng.standard_normal((2, 2))).astype(np.float32)
    return jm, params, load_jax_params(pcls(**SMALL, **kw, device="cpu"), params)


@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_eval_matches_jax(name):
    jm, params, pm = _vit_pair(name)
    x, y = _batch(1)
    xt = P.ops.preprocess.cifar_eval_transform(torch.from_numpy(x), MEAN, STD)
    plain = TF.fused_multihop_attention_plain
    calls = []
    TF.fused_multihop_attention_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        with torch.no_grad():
            logits = pm.eval()(xt)
    finally:
        TF.fused_multihop_attention_plain = plain
    assert len(calls) == VITS[name][3]  # D and Gated: K4 once a block
    want = jm.apply(params, jnp.asarray(xt.numpy()), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    y[::2] = logits.argmax(-1).numpy()[::2]  # the count is neither 0 nor the batch
    mask = np.ones(16, np.float32)
    want_counts = [float(v) for v in jax_eval_step(jm, make_mesh(n_devices=1), MEAN, STD)(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))]
    got = [float(v) for v in P.make_classifier_eval_step(pm, MEAN, STD, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(mask))]
    assert got == want_counts and 0 < got[0] < got[1]


@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_train_step_matches_jax(name):
    jm, params, pm = _vit_pair(name)
    x, y = _batch(2)
    jstep = jax_train_step(jm, optax.identity(), make_mesh(n_devices=1), MEAN, STD,
                           augment=False, compute_dtype=None)
    p1, _, m = jstep(params, optax.identity().init(params), jnp.asarray(x), jnp.asarray(y),
                     jax.random.PRNGKey(0))
    want = jax_state_dict(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), jax.device_get(p1), params))
    step = P.make_classifier_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0), MEAN, STD,
                                        augment=False, compute_dtype=None, device="cpu")
    before = TF.fused_multihop_attention.launches
    got_loss = float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
    assert TF.fused_multihop_attention.launches == before
    np.testing.assert_allclose(got_loss, float(m["loss"]), rtol=2e-4)
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], atol=G_ATOL, rtol=G_RTOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(VITS))
def test_full_width_param_counts_match_jax(name):
    """The experiments' 256/8/4 CIFAR-100 config (built on the meta device)."""
    jcls, pcls, kw, _ = VITS[name]
    full = dict(dim=256, depth=8, heads=4, n_classes=100)
    shapes = jax.eval_shape(lambda: jcls(**full, **kw).init(jax.random.PRNGKey(0),
                                                             jnp.zeros((1, 3, 32, 32))))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = pcls(**full, **kw, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("name", sorted(VITS))
def test_entry_points_default_to_the_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VITS[name][1](**SMALL, **VITS[name][2])
