"""The port's CIFAR eval transform and eval step against the JAX ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.ops.preprocess as jpp
import mop_tpu_torch as P
import mop_tpu_torch.ops.preprocess as tpp
from mop_tpu.parallel import make_mesh
from mop_tpu.parallel import make_classifier_eval_step as jax_eval_step
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(dim=32, depth=2, heads=4, n_classes=10, drop_path=0.0)


def _batch(seed=0, b=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, 3, 32, 32), dtype=np.uint8)
    y = rng.integers(0, 10, (b,)).astype(np.int32)
    mask = (rng.random(b) > 0.25).astype(np.float32)
    return x, y, mask


@pytest.mark.parametrize("mean,std", [(jpp.CIFAR10_MEAN, jpp.CIFAR10_STD),
                                      (jpp.CIFAR100_MEAN, jpp.CIFAR100_STD)])
def test_eval_transform_matches_jax(mean, std):
    x, _, _ = _batch()
    want = np.asarray(jpp.cifar_eval_transform(jnp.asarray(x), mean, std))
    got = tpp.cifar_eval_transform(torch.from_numpy(x), mean, std).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cifar_constants_are_the_jax_ones():
    assert (tpp.CIFAR10_MEAN, tpp.CIFAR10_STD) == (jpp.CIFAR10_MEAN, jpp.CIFAR10_STD)
    assert (tpp.CIFAR100_MEAN, tpp.CIFAR100_STD) == (jpp.CIFAR100_MEAN, jpp.CIFAR100_STD)


MODELS = {
    "A": (lambda: J.ViT_Baseline(**SMALL), lambda: P.ViT_Baseline(**SMALL, device="cpu")),
    "B": (lambda: J.ViT_MoP(**SMALL, n_views=3, n_kernels=2),
          lambda: P.ViT_MoP(**SMALL, n_views=3, n_kernels=2, device="cpu")),
    "E": (lambda: J.ViTEdgewise(**SMALL, n_views=5, gate_mode="lowrank", gate_rank=4,
                                gate_init="mix5"),
          lambda: P.ViTEdgewise(**SMALL, n_views=5, gate_mode="lowrank", gate_rank=4,
                                gate_init="mix5", device="cpu")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_eval_step_counts_match_jax(name, compute_dtype):
    jctor, pctor = MODELS[name]
    x, y, mask = _batch(seed=1)
    jm = jctor()
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))
    # Label half the batch with the model's own prediction so the count is
    # neither 0 nor the batch.
    logits = np.asarray(jm.apply(params, jpp.cifar_eval_transform(
        jnp.asarray(x), jpp.CIFAR10_MEAN, jpp.CIFAR10_STD)))
    y[::2] = logits.argmax(-1)[::2]
    jdt = None if compute_dtype is None else jnp.bfloat16
    tdt = None if compute_dtype is None else torch.bfloat16
    jstep = jax_eval_step(jm, make_mesh(n_devices=1), jpp.CIFAR10_MEAN, jpp.CIFAR10_STD,
                          compute_dtype=jdt)
    want = [float(v) for v in jstep(params, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(mask))]
    pm = load_jax_params(pctor(), jax.device_get(params))
    pstep = P.make_classifier_eval_step(pm, tpp.CIFAR10_MEAN, tpp.CIFAR10_STD,
                                        compute_dtype=tdt, device="cpu")
    got = [float(v) for v in pstep(torch.from_numpy(x), torch.from_numpy(y).long(),
                                   torch.from_numpy(mask))]
    assert got == want
    assert 0 < got[0] < got[1] == float(mask.sum())


def test_cast_floats_casts_only_floats():
    tree = {"w": torch.ones(2), "n": torch.arange(3), "sub": [torch.zeros(1), 4]}
    out = P.cast_floats(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["sub"][0].dtype == torch.bfloat16
    assert out["n"].dtype == torch.int64 and out["sub"][1] == 4


def test_eval_step_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = P.ViT_Baseline(**SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_classifier_eval_step(model, tpp.CIFAR10_MEAN, tpp.CIFAR10_STD)
