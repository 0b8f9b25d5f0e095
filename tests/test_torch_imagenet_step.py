"""``make_imagenet_train_step`` of the port against ``mop_tpu``'s: three steps'
losses and the first step's grads with crop and flip made the identity on
both sides and the other augments off; a clip of 0 leaves the grads
unclipped (the other steps zero them); the four remat modes agree, and
"dots_nb" recomputes every batched product (``bmm``) and no linear; the
Mixup/CutMix arbitration; ``ema_update`` against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mop_tpu.models as J
import mop_tpu.parallel.train_step as jts
from mop_tpu.parallel import make_mesh
import mop_tpu_torch as P
import mop_tpu_torch.parallel.train_step as tts
from mop_tpu.training.utils import ema_update as jax_ema_update
from mop_tpu_torch.training.utils import ema_update
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MEAN, STD = P.IMAGENET_MEAN, P.IMAGENET_STD
SMALL = dict(dim=32, depth=2, heads=2, n_classes=10, patch=16, img_size=32, drop_path=0.0)
NO_AUG = dict(use_randaug=False, random_erasing=0.0, mixup_alpha=0.0, cutmix_alpha=0.0)


def _batch(seed, b=8):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (b, 3, 32, 32), dtype=np.uint8),
            rs.randint(0, 10, (b,)).astype(np.int32))


def _pair():
    jm = J.ViT_Baseline(**SMALL)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))))
    return jm, params, load_jax_params(P.ViT_Baseline(**SMALL, device="cpu"), params)


@pytest.fixture
def no_crop_flip(monkeypatch):
    """Crop and flip as the identity in both packages' steps."""
    monkeypatch.setattr(jts.pp, "random_crop", lambda key, x, padding=4: x)
    monkeypatch.setattr(jts.pp, "random_hflip", lambda key, x, p=0.5: x)
    monkeypatch.setattr(tts.pp, "random_crop", lambda g, x, padding=4: x)
    monkeypatch.setattr(tts.pp, "random_hflip", lambda g, x, p=0.5: x)


def _jax_step(jm, tx, **kw):
    return jts.make_imagenet_train_step(jm, tx, make_mesh(n_devices=1), MEAN, STD, 10,
                                        compute_dtype=None, **kw)


def test_three_steps_match_jax(no_crop_flip):
    """AdamW (optax's defaults: weight decay 1e-4), label smoothing 0.1,
    the clip at 1.0, fp32: the losses of three steps and the first step's
    grads (from an identity optimizer)."""
    jm, params, pm = _pair()
    tx = optax.adamw(1e-3)
    jstep = _jax_step(jm, tx, **NO_AUG)
    opt = torch.optim.AdamW(pm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    step = P.make_imagenet_train_step(pm, opt, MEAN, STD, 10, **NO_AUG, compute_dtype=None,
                                      device="cpu")
    p, o = params, tx.init(params)
    for i in range(3):
        x, y = _batch(i)
        p, o, m = jstep(p, o, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i))
        got = step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator().manual_seed(i))
        np.testing.assert_allclose(got["loss"].item(), float(m["loss"]), rtol=2e-4)
    np.testing.assert_allclose(pm.cls.weight.detach().numpy(),
                               jax_state_dict(jax.device_get(p))["cls.weight"],
                               rtol=2e-3, atol=2e-5)


def _jax_grads(jm, params, x, y, **kw):
    """The JAX step's grads: an identity optimizer adds them to the params."""
    tx = optax.identity()
    p1, _, _ = _jax_step(jm, tx, **kw)(params, tx.init(params), jnp.asarray(x), jnp.asarray(y),
                                       jax.random.PRNGKey(0))
    return jax_state_dict(jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                 jax.device_get(p1), params))


def _port_grads(pm, x, y, **kw):
    step = P.make_imagenet_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0), MEAN, STD,
                                      10, compute_dtype=None, device="cpu", **kw)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator().manual_seed(0))
    return loss["loss"].item(), {k: p.grad.clone() for k, p in pm.named_parameters()}


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_first_step_grads_match_jax_and_a_clip_of_0_is_off(no_crop_flip, grad_clip):
    """At clip 1.0 the grads are clipped (their norm is above 1 here); at 0
    they come out whole, in both packages, where the classifier and LM steps
    of both zero them."""
    jm, params, pm = _pair()
    x, y = _batch(5)
    want = _jax_grads(jm, params, x, y, **NO_AUG, grad_clip=grad_clip)
    _, got = _port_grads(pm, x, y, **NO_AUG, grad_clip=grad_clip)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=2e-3, atol=2e-5, err_msg=k)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in got.values())).item()
    assert (abs(norm - 1.0) < 1e-4) if grad_clip else norm > 1.5
    if not grad_clip:
        _, unclipped = _port_grads(pm, x, y, **NO_AUG, grad_clip=None)
        assert all(torch.equal(unclipped[k], g) for k, g in got.items())
        classifier = P.make_classifier_train_step(
            pm, torch.optim.SGD(pm.parameters(), lr=0.0), MEAN, STD, augment=False,
            grad_clip=0.0, compute_dtype=None, device="cpu")
        classifier(torch.from_numpy(x), torch.from_numpy(y))
        assert not any(p.grad.any() for p in pm.parameters())


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_modes_agree_and_dots_nb_recomputes_only_the_batched_products(no_crop_flip):
    """Each mode's loss and grads equal "none"'s. Counted over a whole step:
    "dots_nb" runs every ``bmm`` of the forward once more (it saved none of
    them, so the backward recomputes them) and no more ``mm``/``addmm``
    than "none" (it saved them all); "dots" saves both; "full" recomputes
    both."""
    _, params, _ = _pair()
    x, y = _batch(6)
    runs = {}
    for remat in ("none", "full", "dots", "dots_nb"):
        pm = load_jax_params(P.ViT_Baseline(**SMALL, device="cpu"), params)
        with _CountOps() as counter:
            loss, grads = _port_grads(pm, x, y, **NO_AUG, remat=remat)
        runs[remat] = (loss, grads, counter.counts)
    loss0, grads0, c0 = runs["none"]
    bmm, mm = torch.ops.aten.bmm.default, torch.ops.aten.mm.default
    fwd_bmm = 2 * SMALL["depth"]  # scores and values per block
    for remat, (loss, grads, counts) in runs.items():
        assert loss == loss0, remat
        for k, g in grads.items():
            torch.testing.assert_close(g, grads0[k], rtol=1e-5, atol=1e-7, msg=k)
        extra_bmm = counts.get(bmm, 0) - c0.get(bmm, 0)
        extra_mm = (counts.get(mm, 0) + counts.get(torch.ops.aten.addmm.default, 0)
                    - c0.get(mm, 0) - c0.get(torch.ops.aten.addmm.default, 0))
        want = {"none": (0, 0), "dots": (0, 0), "dots_nb": (fwd_bmm, 0)}.get(remat)
        if want is not None:
            assert (extra_bmm, extra_mm) == want, remat
        else:  # full
            assert extra_bmm == fwd_bmm and extra_mm > 0
    with pytest.raises(ValueError):
        P.make_imagenet_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0), MEAN, STD, 10,
                                   remat="dots_all", device="cpu")


@pytest.mark.parametrize("remat", ["full", "dots", "dots_nb"])
def test_remat_checkpoints_each_block(remat):
    """Each mode checkpoints every block on its own: beside what the
    checkpoints keep (each block's input and what the policy saves), the
    forward's graph saves only what lies outside the blocks, under a quarter
    of what "none" saves at depth 4; and the blocks' forwards are their own
    again once the forward returns."""
    x = torch.from_numpy(_batch(7)[0]).float() / 255
    pm = P.ViT_Baseline(**dict(SMALL, depth=4, patch=8), device="cpu",
                        generator=torch.Generator().manual_seed(0)).train()
    saved = {}
    for mode in ("none", remat):
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        forward = tts._remat_forward(pm, None, mode)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            forward(x, None).sum()
        saved[mode] = sum(nbytes)
    assert saved[remat] < saved["none"] / 4, saved
    assert all("forward" not in vars(blk) for blk in tts._blocks(pm))


@pytest.mark.parametrize("mixup_alpha,cutmix_alpha,mix_prob,want", [
    (0.8, 1.0, 1.0, "mixup"), (0.8, 1.0, 0.0, "cutmix"), (0.8, 0.0, 0.0, "mixup"),
    (0.0, 1.0, 1.0, "cutmix"), (0.0, 0.0, 0.5, None)])
def test_mix_arbitration(monkeypatch, mixup_alpha, cutmix_alpha, mix_prob, want):
    """Both alphas on: Mixup with probability ``mix_prob``, else CutMix; one
    on: that one; none: neither. Only the chosen op runs (and draws)."""
    calls = []
    for name in ("mixup", "cutmix"):
        op = getattr(tts.pp, name)
        monkeypatch.setattr(tts.pp, name, lambda *a, _n=name, _op=op, **k: calls.append(_n)
                            or _op(*a, **k))
    pm = P.ViT_Baseline(**SMALL, device="cpu", generator=torch.Generator().manual_seed(0))
    step = P.make_imagenet_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0), MEAN, STD,
                                      10, use_randaug=True, random_erasing=0.5,
                                      mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                                      mix_prob=mix_prob, device="cpu")
    x, y = _batch(7)
    m = step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator().manual_seed(1))
    assert np.isfinite(m["loss"].item())
    assert calls == ([want] if want else [])


def test_whole_suite_step_is_deterministic_in_its_generator():
    """Every augment on and drop-path 0.1 in bf16: the same generator seed
    gives the same losses and params, and the steps draw nothing from the
    global RNG."""
    steps = []
    for _ in range(2):
        pm = P.ViT_Baseline(**{**SMALL, "drop_path": 0.1}, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        opt = torch.optim.AdamW(pm.parameters(), lr=1e-3)
        steps.append((pm, P.make_imagenet_train_step(pm, opt, MEAN, STD, 10, use_randaug=True,
                                                     device="cpu")))
    state = torch.get_rng_state()
    runs = []
    for pm, step in steps:
        g = torch.Generator().manual_seed(3)
        losses = [step(*map(torch.from_numpy, _batch(i)), g)["loss"].item() for i in range(2)]
        runs.append((losses, pm.cls.weight.detach()))
    assert torch.equal(torch.get_rng_state(), state)
    (l1, w1), (l2, w2) = runs
    assert l1 == l2 and all(np.isfinite(l1)) and torch.equal(w1, w2)
    with pytest.raises(ValueError):
        steps[0][1](*map(torch.from_numpy, _batch(0)), None)


def test_ema_update_matches_jax():
    rs = np.random.RandomState(0)
    ema = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    params = {k: rs.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    want = jax.device_get(jax_ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                                         {k: jnp.asarray(v) for k, v in params.items()}, 0.9))
    shadow = [torch.tensor(ema[k]) for k in ema]
    out = ema_update(shadow, [torch.tensor(params[k]) for k in ema], 0.9)
    for t, k in zip(shadow, ema):  # in place on the shadow copy
        np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6, atol=1e-7)
    assert all(a is b for a, b in zip(out, shadow))
