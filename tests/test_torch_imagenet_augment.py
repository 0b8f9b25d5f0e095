"""The ImageNet augment suite of the port (``mop_tpu_torch.ops.preprocess``)
against the JAX package's ops given the JAX ops' own draws: each of the
eight RandAugment ops, ``rand_augment``, ``random_erasing``, ``mixup`` and
``cutmix`` (each port op is its draws and a deterministic transform of them;
the test recomputes the JAX draws from the same split keys and feeds them to
the transform). Also the port's own draws (Beta's moments, determinism from
the generator) and the ImageNet data: ``synthetic_imagenet``,
``val_test_split`` and a written ImageFolder, byte for byte."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.data.imagenet as jdata
import mop_tpu.ops.preprocess as jpp
import mop_tpu_torch.data.imagenet as tdata
import mop_tpu_torch.ops.preprocess as tpp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, C, H, W = 8, 3, 24, 20


def _images(seed, b=B):
    """uint8 images as the pipeline sees them: float32 in [0, 1]."""
    x = np.random.RandomState(seed).randint(0, 256, (b, C, H, W), dtype=np.uint8)
    return (x.astype(np.float32) / 255.0)


def _targets(seed, n_classes=10):
    y = np.random.RandomState(seed).randint(0, n_classes, B)
    return np.asarray(jpp.label_smoothing_onehot(jnp.asarray(y), n_classes, 0.1))


@pytest.mark.parametrize("op", range(8))
def test_each_rand_augment_op_matches_jax(op):
    """Every op at both signs of magnitude 9/30 and at 0.05 and -0.95 (past
    posterize's and solarize's clamps), one per sample."""
    x = _images(op)
    mags = np.array([0.3, -0.3, 0.05, -0.95, 0.3, -0.3, 0.6, -0.6], np.float32)
    want = jax.vmap(jpp._RANDAUG_OPS[op])(jnp.asarray(x), jnp.asarray(mags))
    got = tpp.RANDAUG_OPS[op](torch.from_numpy(x), torch.from_numpy(mags).reshape(-1, 1, 1, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert tpp.RANDAUG_OPS[op].__name__ == jpp._RANDAUG_OPS[op].__name__


def _jax_rand_augment_draws(key, b, n):
    """The op indices and signs ``mop_tpu``'s ``rand_augment`` draws, (B, n)."""
    def one(k):
        ops, signs = [], []
        for _ in range(n):
            k, k_op, k_sign = jax.random.split(k, 3)
            ops.append(jax.random.randint(k_op, (), 0, 8))
            signs.append(jnp.where(jax.random.bernoulli(k_sign), 1.0, -1.0))
        return jnp.stack(ops), jnp.stack(signs)

    ops, signs = jax.vmap(one)(jax.random.split(key, b))
    return torch.tensor(np.asarray(ops)).long(), torch.tensor(np.asarray(signs))


@pytest.mark.parametrize("n,m", [(2, 9), (3, 15)])
def test_rand_augment_matches_jax_given_its_draws(n, m):
    key = jax.random.PRNGKey(10 + n)
    x = _images(n, b=16)
    want = jpp.rand_augment(key, jnp.asarray(x), n, m)
    ops, signs = _jax_rand_augment_draws(key, 16, n)
    assert len(set(ops.flatten().tolist())) >= 6  # most ops are drawn
    got = tpp.apply_rand_augment(torch.from_numpy(x), ops, signs, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_random_erasing_matches_jax_given_its_draws():
    x = _images(3, b=32)
    for seed, p in ((0, 0.25), (1, 1.0), (2, 0.0)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jpp.random_erasing(key, jnp.asarray(x), p=p))
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        draws = (jax.random.uniform(k1, (32,), minval=0.02, maxval=0.33),
                 jax.random.uniform(k2, (32,), minval=jnp.log(0.3), maxval=jnp.log(3.3)),
                 jax.random.uniform(k3, (32,)), jax.random.uniform(k4, (32,)),
                 jax.random.bernoulli(k5, p, (32, 1, 1, 1)).reshape(32))
        got = tpp.erase(torch.from_numpy(x), *(torch.tensor(np.asarray(d)) for d in draws))
        np.testing.assert_array_equal(got.numpy(), want)
        erased = (want != x).any(axis=(1, 2, 3))
        assert erased.any() == (p > 0) and (erased.all() or p < 1)


def test_mixup_matches_jax_given_its_draws():
    x, tgt = _images(4), _targets(4)
    for alpha in (0.8, 0.2):
        key = jax.random.PRNGKey(int(alpha * 10))
        wx, wy = jpp.mixup(key, jnp.asarray(x), jnp.asarray(tgt), alpha=alpha)
        lam = jax.random.beta(jax.random.split(key)[0], alpha, alpha)
        gx, gy = tpp.mix(torch.from_numpy(x), torch.from_numpy(tgt),
                         torch.tensor(np.asarray(lam)))
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_cutmix_matches_jax_given_its_draws(seed):
    x, tgt = _images(5 + seed), _targets(5 + seed)
    key = jax.random.PRNGKey(20 + seed)
    wx, wy = jpp.cutmix(key, jnp.asarray(x), jnp.asarray(tgt), alpha=1.0)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.beta(k1, 1.0, 1.0), jax.random.randint(k2, (), 0, H),
             jax.random.randint(k3, (), 0, W))
    gx, gy = tpp.paste_box(torch.from_numpy(x), torch.from_numpy(tgt),
                           *(torch.tensor(np.asarray(d)) for d in draws))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("alpha", [0.8, 1.0, 0.2])
def test_beta_draws_have_beta_moments_and_follow_the_generator(alpha):
    g = torch.Generator().manual_seed(0)
    lam = torch.stack([tpp.beta_draw(g, alpha, "cpu") for _ in range(2000)]).double()
    assert lam.min() >= 0 and lam.max() <= 1
    var = 1.0 / (4.0 * (2.0 * alpha + 1.0))  # Beta(a, a): mean 1/2
    assert abs(lam.mean().item() - 0.5) < 4 * (var / 2000) ** 0.5
    assert abs(lam.var().item() - var) < 0.1 * var
    again = tpp.beta_draw(torch.Generator().manual_seed(0), alpha, "cpu")
    assert again.item() == lam[0].item()


def test_augment_ops_draw_only_from_their_generator():
    x = torch.from_numpy(_images(6))
    y = torch.from_numpy(_targets(6))
    torch.manual_seed(123)
    state = torch.get_rng_state()
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        outs.append((tpp.rand_augment(g, x), tpp.random_erasing(g, x, p=0.5),
                     *tpp.mixup(g, x, y, 0.8), *tpp.cutmix(g, x, y, 1.0)))
    assert torch.equal(torch.get_rng_state(), state)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_synthetic_imagenet_and_split_equal_jax_bytes():
    got = tdata.synthetic_imagenet(6, 5, n_classes=4, img_size=48, seed=3)
    want = jdata.synthetic_imagenet(6, 5, n_classes=4, img_size=48, seed=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for frac in (0.2, 0.0, 1.0):
        for a, b in zip(tdata.val_test_split(got[2], got[3], frac),
                        jdata.val_test_split(want[2], want[3], frac)):
            assert a.tobytes() == b.tobytes()


def test_load_imagefolder_on_a_written_folder(tmp_path):
    from PIL import Image

    root = str(tmp_path)
    assert not tdata.has_imagefolder(root, "train")
    rs = np.random.RandomState(0)
    for cls, n in (("n01", 3), ("n00", 2)):
        os.makedirs(os.path.join(root, "train", cls))
        for i in range(n):
            Image.fromarray(rs.randint(0, 256, (20 + i, 30, 3), dtype=np.uint8)).save(
                os.path.join(root, "train", cls, f"{i}.jpg"))
    assert tdata.has_imagefolder(root, "train") and not tdata.has_imagefolder(root, "val")
    x, y, classes = tdata.load_imagefolder(root, "train", img_size=16, limit_per_class=2)
    jx, jy, jclasses = jdata.load_imagefolder(root, "train", img_size=16, limit_per_class=2)
    assert classes == jclasses == ["n00", "n01"] and x.shape == (4, 3, 16, 16)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    np.testing.assert_array_equal(y, [0, 0, 1, 1])
