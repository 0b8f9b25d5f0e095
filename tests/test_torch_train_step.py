"""The port's train steps against the JAX ones and the torch-reference
trajectory goldens, the random augment's invariants, and the explicit-
generator and mode-switch rules of the steps."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.ops.preprocess as jpp
import mop_tpu_torch as P
import mop_tpu_torch.ops.preprocess as tpp
from mop_tpu.parallel import make_classifier_eval_step as jax_eval_step
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_mesh
from mop_tpu.utils.torch_port import port_torch_state_dict
from mop_tpu_torch.models import DropPath, EdgewiseMSA
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params
from tools.trajectory_parity import (CONFIGS, LR, MSA_CONFIG, MSA_KWARGS, WD, make_batches,
                                     make_msa_batches)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_trajectory_parity.py: fp32 reduction-order drift compounds
# through the optimizer state.
RTOL_EARLY, RTOL_LATE, SPLIT = 2e-4, 5e-3, 10
MEAN, STD = tpp.CIFAR100_MEAN, tpp.CIFAR100_STD

SMALL = dict(dim=32, depth=2, heads=4, n_classes=10)
MODELS = {
    "A": (lambda **k: J.ViT_Baseline(**SMALL, **k),
          lambda **k: P.ViT_Baseline(**SMALL, device="cpu", **k)),
    "B": (lambda **k: J.ViT_MoP(**SMALL, n_views=3, n_kernels=2, **k),
          lambda **k: P.ViT_MoP(**SMALL, n_views=3, n_kernels=2, device="cpu", **k)),
    "E": (lambda **k: J.ViTEdgewise(**SMALL, n_views=3, gate_mode="lowrank", gate_rank=2,
                                    gate_init="mix5", **k),
          lambda **k: P.ViTEdgewise(**SMALL, n_views=3, gate_mode="lowrank", gate_rank=2,
                                    gate_init="mix5", device="cpu", **k)),
}


def _batches(n, b=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, b, 3, 32, 32), dtype=np.uint8)
    y = rng.integers(0, 10, (n, b)).astype(np.int32)
    return x, y


def _jax_run(jm, params, tx, xs, ys, **kw):
    step = jax_train_step(jm, tx, make_mesh(n_devices=1), MEAN, STD, augment=False,
                          compute_dtype=None, **kw)
    opt = tx.init(params)
    losses = []
    for x, y in zip(xs, ys):
        params, opt, m = step(params, opt, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.parametrize("name,opts", [
    ("A", dict(accum_steps=2)),
    ("B", dict(grad_clip=0.5)),
    ("E", dict(label_smoothing=0.1)),
    ("A", dict(grad_clip=0.0)),  # the JAX step's clip of 0 zeroes the grads
])
def test_train_step_matches_jax(name, opts):
    jctor, pctor = MODELS[name]
    jm = jctor(drop_path=0.0)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32))))
    xs, ys = _batches(3, seed=2)
    _, want_losses = _jax_run(jm, params, optax.adamw(1e-3, weight_decay=0.05), xs, ys,
                              **opts)
    # The JAX step's update with the identity transform is its grads.
    p1, _ = _jax_run(jm, params, optax.identity(), xs[:1], ys[:1], **opts)
    want_grads = jax_state_dict(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), jax.device_get(p1), params))

    pm = load_jax_params(pctor(drop_path=0.0), params)
    opt = torch.optim.AdamW(pm.parameters(), lr=1e-3, weight_decay=0.05)
    step = P.make_classifier_train_step(pm, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, device="cpu", **opts)
    losses = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        m = step(torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {k: p.grad.numpy().copy() for k, p in pm.named_parameters()}
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    assert sorted(grads) == sorted(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, want_grads[k], atol=1e-4, rtol=1e-3, err_msg=k)
    if "grad_clip" in opts:  # the clip was active: the grads' norm is the clip
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        assert norm == pytest.approx(opts["grad_clip"], rel=1e-4)


def _replay(model, xs, ys, loss_fn):
    """Lockstep replay of a golden: AdamW + cosine, as the reference's run."""
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    sch = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=xs.shape[0])
    losses = []
    for x, y in zip(xs, ys):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        opt.step()
        sch.step()
        losses.append(loss.item())
    return np.asarray(losses)


def _golden(prefix, name):
    data = np.load(os.path.join(GOLDEN, f"{prefix}_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("w__")}
    return sd, data["out__losses"]


@pytest.mark.parametrize("name", ["A", "B"])
def test_lockstep_trajectory_matches_torch_reference(name):
    cfg = CONFIGS["small"]
    sd, golden = _golden("trajectory", name)
    kw = dict(dim=cfg["dim"], depth=cfg["depth"], heads=cfg["heads"], n_classes=10,
              drop_path=0.0, device="cpu")
    model = (P.ViT_Baseline(**kw) if name == "A" else
             P.ViT_MoP(**kw, n_views=cfg["views"], n_kernels=cfg["kernels"]))
    model.load_state_dict(sd, strict=True)
    xs, ys = make_batches(cfg["steps"], cfg["batch"])
    # The golden run is deterministic (eval mode: no drop-path), grads flow.
    ours = _replay(model.eval(), xs, ys, torch.nn.functional.cross_entropy)
    np.testing.assert_allclose(ours[:SPLIT], golden[:SPLIT], rtol=RTOL_EARLY)
    np.testing.assert_allclose(ours[SPLIT:], golden[SPLIT:], rtol=RTOL_LATE)


def test_msa_e_lowrank_trajectory_matches_torch_reference():
    sd, golden = _golden("trajectory_msa", "E_lowrank")
    model = EdgewiseMSA(dim=MSA_CONFIG["dim"], heads=MSA_CONFIG["heads"],
                        **MSA_KWARGS["E_lowrank"])
    model.load_state_dict(sd, strict=True)
    xs, ys = make_msa_batches(MSA_CONFIG)
    ours = _replay(model.train(), xs, ys, torch.nn.functional.mse_loss)
    np.testing.assert_allclose(ours[:SPLIT], golden[:SPLIT], rtol=RTOL_EARLY)
    np.testing.assert_allclose(ours[SPLIT:], golden[SPLIT:], rtol=RTOL_LATE)


def _images(seed=0, b=16):
    return torch.from_numpy(np.random.default_rng(seed).random((b, 3, 32, 32), np.float32))


def test_random_crop_is_a_window_of_the_padded_image():
    x = _images()
    out = tpp.random_crop(torch.Generator().manual_seed(0), x, padding=4)
    assert out.shape == x.shape
    xp = torch.nn.functional.pad(x, (4, 4, 4, 4))
    offsets = set()
    for b in range(x.shape[0]):
        hits = [(i, j) for i in range(9) for j in range(9)
                if torch.equal(xp[b, :, i:i + 32, j:j + 32], out[b])]
        assert hits, f"sample {b} is no 32x32 window of its padded image"
        offsets.add(hits[0])
    assert len(offsets) > 1  # the offsets are drawn per sample


def test_random_hflip_twice_with_one_draw_is_the_identity():
    x = _images(1)
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    once = tpp.random_hflip(g, x)
    for b in range(x.shape[0]):
        assert torch.equal(once[b], x[b]) or torch.equal(once[b], x[b].flip(-1))
    g.set_state(state)
    assert torch.equal(tpp.random_hflip(g, once), x)
    assert not torch.equal(once, x)


def test_train_augment_is_fixed_by_its_generator():
    x = torch.from_numpy(_batches(1, seed=3)[0][0])
    a = tpp.cifar_train_augment(torch.Generator().manual_seed(7), x, MEAN, STD)
    b = tpp.cifar_train_augment(torch.Generator().manual_seed(7), x, MEAN, STD)
    c = tpp.cifar_train_augment(torch.Generator().manual_seed(8), x, MEAN, STD)
    assert a.dtype == torch.float32 and torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_onehot_matches_jax(smoothing):
    y = np.array([0, 3, 9, 3], np.int32)
    want = np.asarray(jpp.label_smoothing_onehot(jnp.asarray(y), 10, smoothing))
    got = tpp.label_smoothing_onehot(torch.from_numpy(y).long(), 10, smoothing).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


def test_eval_after_a_train_step_gives_the_jax_eval_counts():
    """drop_path 0.1 by default: a train step leaves the model in train mode,
    and the eval step must switch DropPath off again on its own."""
    jm = J.ViT_Baseline(**SMALL)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, 32, 32))))
    pm = load_jax_params(P.ViT_Baseline(**SMALL, device="cpu"), params)
    xs, ys = _batches(2, seed=4)
    train = P.make_classifier_train_step(pm, torch.optim.AdamW(pm.parameters(), 1e-2),
                                         MEAN, STD, compute_dtype=None, device="cpu")
    train(torch.from_numpy(xs[0]), torch.from_numpy(ys[0]), torch.Generator().manual_seed(0))
    assert pm.training
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    jparams = port_torch_state_dict(sd, params)
    x, y = xs[1], ys[1].copy()
    logits = np.asarray(jm.apply(jparams, jpp.cifar_eval_transform(jnp.asarray(x), MEAN, STD)))
    y[::2] = logits.argmax(-1)[::2]
    mask = np.ones(16, np.float32)
    want = [float(v) for v in jax_eval_step(jm, make_mesh(n_devices=1), MEAN, STD)(
        jparams, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))]
    evaluate = P.make_classifier_eval_step(pm, MEAN, STD, device="cpu")
    for _ in range(2):
        got = [float(v) for v in evaluate(torch.from_numpy(x), torch.from_numpy(y).long(),
                                          torch.from_numpy(mask))]
        assert got == want and not pm.training
    assert 0 < got[0] < got[1]
    train(torch.from_numpy(xs[0]), torch.from_numpy(ys[0]), torch.Generator().manual_seed(0))
    assert pm.training


def _e_model(seed=0, **kw):
    return MODELS["E"][1](generator=torch.Generator().manual_seed(seed), **kw)


def test_train_step_draws_only_from_its_generator():
    """Augment, drop-path and dropout draw from the step's generator: the same
    seed gives the same run, and the global RNG is never touched."""
    runs = []
    for _ in range(2):
        model = _e_model(drop=0.1)
        step = P.make_classifier_train_step(model, torch.optim.AdamW(model.parameters(), 1e-3),
                                            MEAN, STD, compute_dtype=None, device="cpu")
        g = torch.Generator().manual_seed(3)
        xs, ys = _batches(2, seed=5)
        before = torch.get_rng_state()
        runs.append([float(step(torch.from_numpy(x), torch.from_numpy(y), g)["loss"])
                     for x, y in zip(xs, ys)])
        assert torch.equal(torch.get_rng_state(), before)
    assert runs[0] == runs[1]


def test_training_without_a_generator_raises():
    dp = DropPath(0.1).train()
    with pytest.raises(RuntimeError, match="set_generator"):
        dp(torch.ones(4, 3))
    model = _e_model(drop=0.1)
    step = P.make_classifier_train_step(model, torch.optim.SGD(model.parameters(), 0.1),
                                        MEAN, STD, augment=False, device="cpu")
    x, y = _batches(1)
    with pytest.raises(RuntimeError, match="set_generator"):
        step(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    with pytest.raises(ValueError, match="Generator"):
        P.make_classifier_train_step(model, torch.optim.SGD(model.parameters(), 0.1),
                                     MEAN, STD, device="cpu")(torch.from_numpy(x[0]),
                                                              torch.from_numpy(y[0]))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_scanned_step_is_k_single_steps(remat):
    """K scanned steps equal K calls of the single step, with bf16 compute,
    the augment and drop-path on; remat='full' recomputes the forward with
    the same drop masks, so it changes nothing either."""
    xs, ys = _batches(3, b=8, seed=6)
    out = {}
    for kind in ("single", "scanned"):
        model = _e_model(seed=1)
        opt = torch.optim.AdamW(model.parameters(), 3e-3, weight_decay=0.05)
        g = torch.Generator().manual_seed(9)
        if kind == "single":
            step = P.make_classifier_train_step(model, opt, MEAN, STD, device="cpu")
            losses = [float(step(torch.from_numpy(x), torch.from_numpy(y), g)["loss"])
                      for x, y in zip(xs, ys)]
        else:
            step = P.make_scanned_classifier_train_step(model, opt, MEAN, STD, unroll_steps=3,
                                                        remat=remat, device="cpu")
            m = step(torch.from_numpy(xs), torch.from_numpy(ys), g)
            assert m["loss"].shape == m["acc"].shape == (3,)
            losses = m["loss"].tolist()
        out[kind] = (losses, copy.deepcopy(model.state_dict()))
    assert out["single"][0] == out["scanned"][0]
    for k, v in out["single"][1].items():
        assert torch.equal(v, out["scanned"][1][k]), k


def test_scanned_step_options():
    model = _e_model()
    opt = torch.optim.SGD(model.parameters(), 0.1)
    with pytest.raises(ValueError, match="remat"):
        P.make_scanned_classifier_train_step(model, opt, MEAN, STD, 2, remat="some",
                                             device="cpu")
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        accum_steps=3, device="cpu")
    x, y = _batches(1)
    with pytest.raises(ValueError, match="divisible"):
        step(torch.from_numpy(x[0]), torch.from_numpy(y[0]))


@pytest.mark.parametrize("drop_path", [0.0, 0.1])
def test_remat_dots_matches_no_remat(drop_path):
    """remat="dots" (the matmul outputs saved, the rest recomputed) gives the
    loss and fp32 grads of remat="none": one scanned step of a small ViT,
    with drop-path drawn from the step's generator (the recompute rewinds
    it) and without."""
    xs, ys = _batches(1, b=8, seed=7)
    out = {}
    for remat in ("none", "dots"):
        model = P.ViT_MoP(**SMALL, n_views=3, n_kernels=2, drop_path=drop_path, device="cpu",
                          generator=torch.Generator().manual_seed(2))
        step = P.make_scanned_classifier_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0), MEAN, STD, unroll_steps=1,
            augment=False, compute_dtype=None, remat=remat, device="cpu")
        g = torch.Generator().manual_seed(4) if drop_path else None
        loss = step(torch.from_numpy(xs), torch.from_numpy(ys), g)["loss"]
        out[remat] = (loss, {k: p.grad.clone() for k, p in model.named_parameters()})
    torch.testing.assert_close(out["dots"][0], out["none"][0], rtol=2e-4, atol=2e-5)
    assert sorted(out["dots"][1]) == sorted(out["none"][1])
    for k, g in out["none"][1].items():
        torch.testing.assert_close(out["dots"][1][k], g, rtol=2e-4, atol=2e-5, msg=k)


def test_remat_dots_saves_only_the_matmuls():
    """The policy keeps mm / bmm / addmm outputs and recomputes everything
    else, as JAX's checkpoint_dots keeps the dot outputs."""
    from torch.utils.checkpoint import CheckpointPolicy

    from mop_tpu_torch.parallel.train_step import _save_dots

    aten = torch.ops.aten
    for op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        assert _save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.gelu.default, aten.add.Tensor, aten._softmax.default):
        assert _save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
