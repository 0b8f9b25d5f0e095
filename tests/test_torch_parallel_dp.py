"""Data parallelism on the port, over gloo on the CPU: the steps under a 2-
and a 4-process data axis (one 4-process group, started once for the file)
against the port's one-device steps on the whole batch, and the one-device
and data-parallel steps against JAX's ``make_classifier_train_step`` and
``make_lm_train_step`` at the same init, with ``tests/test_parallel.py``'s
tolerances (rtol 2e-4, atol 2e-5 after 3 fp32 steps). The augment, drop-path
and dropout draws are the global batch's on every process, so even the
random steps equal the one-device step; the JAX steps draw from JAX keys, so
they are compared with the augment off and dropout 0. Also: the mesh's
shortfall raise, the collectives of one step, and the device rule of
``utils/device.py`` under a process group."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_lm_train_step as jax_lm_step
from mop_tpu.parallel import make_mesh as jax_make_mesh
from mop_tpu.parallel import replicate as jax_replicate
from mop_tpu.parallel import shard_batch as jax_shard_batch
from mop_tpu_torch.ops.preprocess import CIFAR100_MEAN as MEAN, CIFAR100_STD as STD
from mop_tpu_torch.parallel.mesh import make_mesh
from mop_tpu_torch.utils.collectives import collective_summary, record_collectives
from mop_tpu_torch.utils.jax_weights import load_jax_params
from tests._torch_parallel_common import assert_params_close, jax_init, run_ranks
from tests._torch_parallel_worker import DP_CASES

RTOL, ATOL = 2e-4, 2e-5
VIT_KW = dict(dim=32, depth=2, heads=2, n_classes=10, n_views=2, n_kernels=1, drop_path=0.0)
GPT_CFG = dict(n_layer=2, n_head=4, n_embd=64, dropout=0.0, block_size=16)
GPT_KW = dict(n_views=3, n_kernels=2)
INET_KW = dict(dim=32, depth=1, heads=2, n_classes=10, drop_path=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """The inputs (JAX inits in the port's layout, seeded batches) and the
    JAX steps' results."""
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, (3, 16, 3, 32, 32), dtype=np.uint8)
    ys = rng.integers(0, 10, (3, 16)).astype(np.int64)
    jm = J.ViT_MoP(**VIT_KW)
    vit_params = jax_init(jm, 0, jnp.zeros((1, 3, 32, 32)))
    vit_sd = load_jax_params(P.ViT_MoP(**VIT_KW, device="cpu"), vit_params).state_dict()
    jg = J.create_gpt_mop(64, J.TransformerConfig(**GPT_CFG), **GPT_KW)
    idx = rng.integers(0, 64, (3, 8, 16)).astype(np.int64)
    tgt = np.roll(idx, -1, axis=-1)
    gpt_params = jax_init(jg, 1, jnp.asarray(idx[0], jnp.int32))
    gpt_sd = load_jax_params(P.create_gpt_mop(64, P.TransformerConfig(**GPT_CFG), device="cpu",
                                              **GPT_KW), gpt_params).state_dict()
    inet = P.ViT_Baseline(**INET_KW, device="cpu", generator=torch.Generator().manual_seed(2))
    mask = np.ones(16, np.float32)
    mask[-3:] = 0.0
    inputs = dict(
        xs=torch.from_numpy(xs), ys=torch.from_numpy(ys), mask=torch.from_numpy(mask),
        vit_kw=VIT_KW, vit_sd=vit_sd, gpt_cfg=GPT_CFG, gpt_kw=GPT_KW, gpt_vocab=64,
        gpt_sd=gpt_sd, idx=torch.from_numpy(idx), tgt=torch.from_numpy(tgt),
        inet_kw=INET_KW, inet_sd=inet.state_dict(),
        inet_x=torch.from_numpy(rng.integers(0, 256, (4, 8, 3, 32, 32), dtype=np.uint8)),
        inet_y=torch.from_numpy(rng.integers(0, 10, (4, 8)).astype(np.int64)))
    # JAX's steps on one device: its data-parallel steps equal them
    # (tests/test_parallel.py), and each device count compiles anew.
    jax_res = {}
    mesh = jax_make_mesh(n_devices=1)
    for kind, jmodel, params, wd, data in (
            ("cls", jm, vit_params, 0.05, (xs, ys)), ("lm", jg, gpt_params, 0.01, (idx, tgt))):
        tx = optax.adamw(1e-3, weight_decay=wd)
        with mesh:
            p, o = jax_replicate(params, mesh), jax_replicate(tx.init(params), mesh)
            step = (jax_train_step(jmodel, tx, mesh, MEAN, STD, augment=False,
                                   compute_dtype=None) if kind == "cls"
                    else jax_lm_step(jmodel, tx, mesh, compute_dtype=None))
            losses = []
            for i in range(3):
                a, b = jax_shard_batch((data[0][i].astype(np.int32) if kind == "lm"
                                        else data[0][i], data[1][i].astype(np.int32)), mesh)
                p, o, m = step(p, o, a, b, jax.random.PRNGKey(i))
                losses.append(float(m["loss"]))
        jax_res[kind] = (losses, jax.device_get(p))
    return inputs, jax_res


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks("dp", case[0], tmp_path_factory.mktemp("dp"))


_ONE_DEVICE = {}


def _one_device(inputs, kind, **opts):
    """The port's one-device step on the whole batch: (losses, params), once
    for each set of arguments."""
    key = (kind, repr(sorted(opts.items())))
    if key not in _ONE_DEVICE:
        _ONE_DEVICE[key] = _run_one_device(inputs, kind, **opts)
    return _ONE_DEVICE[key]


def _run_one_device(inputs, kind, **opts):
    g = torch.Generator().manual_seed({"cls": 7, "lm": 11, "imagenet": 13}[kind])
    if kind == "cls":
        model = P.ViT_MoP(**{**VIT_KW, **opts.pop("model", {})}, device="cpu")
        model.load_state_dict(inputs["vit_sd"])
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
        step = P.make_classifier_train_step(model, opt, MEAN, STD, compute_dtype=None,
                                            device="cpu", **opts)
        data, n = (inputs["xs"], inputs["ys"]), 3
    elif kind == "lm":
        model = P.create_gpt_mop(64, P.TransformerConfig(**{**GPT_CFG, **opts}), device="cpu",
                                 **GPT_KW)
        model.load_state_dict(inputs["gpt_sd"])
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        step = P.make_lm_train_step(model, opt, compute_dtype=None, device="cpu")
        data, n = (inputs["idx"], inputs["tgt"]), 3
    else:
        model = P.ViT_Baseline(**INET_KW, device="cpu")
        model.load_state_dict(inputs["inet_sd"])
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        step = P.make_imagenet_train_step(model, opt, MEAN, STD, 10, use_randaug=True,
                                          compute_dtype=None, device="cpu")
        data, n = (inputs["inet_x"], inputs["inet_y"]), 4
    losses = [step(data[0][i], data[1][i], generator=g)["loss"].item() for i in range(n)]
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


def _jax_sd(model_ctor, params):
    return load_jax_params(model_ctor(), params).state_dict()


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("name", sorted(DP_CASES))
def test_dp_classifier_equals_one_device(case, ranks, name, dp):
    inputs, _ = case
    mkw, skw = DP_CASES[name]
    want_l, want_p = _one_device(inputs, "cls", model=dict(mkw), **skw)
    for r in ranks:  # every process holds the same model
        got_l, got_p = r[("cls", name, dp)]
        np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
        assert_params_close(got_p, want_p, RTOL, ATOL)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_classifier_step_equals_jax(case, ranks, dp):
    """The one-device (dp 1) and data-parallel steps against JAX's, augment
    off."""
    inputs, jax_res = case
    want_l, want_params = jax_res["cls"]
    want_p = _jax_sd(lambda: P.ViT_MoP(**VIT_KW, device="cpu"), want_params)
    got_l, got_p = (_one_device(inputs, "cls", augment=False) if dp == 1
                    else ranks[0][("cls", "jax", dp)])
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
    assert_params_close(got_p, want_p, RTOL, ATOL)


def test_dp_scanned_step_equals_one_device(case, ranks):
    inputs, _ = case
    model = P.ViT_MoP(**VIT_KW, device="cpu")
    model.load_state_dict(inputs["vit_sd"])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.05)
    step = P.make_scanned_classifier_train_step(model, opt, MEAN, STD, 3, augment=True,
                                                compute_dtype=None, device="cpu")
    m = step(inputs["xs"], inputs["ys"], torch.Generator().manual_seed(7))
    got_l, got_p = ranks[0]["scanned"]
    np.testing.assert_allclose(got_l, m["loss"].tolist(), rtol=RTOL, atol=ATOL)
    assert_params_close(got_p, model.state_dict(), RTOL, ATOL)


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_eval_counts_equal_one_device(case, ranks, dp):
    """The eval step's counts, summed over the data axis, over a padded tail."""
    inputs, _ = case
    model = P.ViT_MoP(**VIT_KW, device="cpu")
    model.load_state_dict(inputs["vit_sd"])
    ev = P.make_classifier_eval_step(model, MEAN, STD, device="cpu")
    c, t = ev(inputs["xs"][0], inputs["ys"][0], inputs["mask"])
    for r in ranks:
        assert r[("eval", dp)] == (float(c), float(t)) and float(t) == 13.0


@pytest.mark.parametrize("drop,dp", [(0.0, 2), (0.0, 4), (0.1, 4)])
def test_dp_lm_step_equals_one_device(case, ranks, drop, dp):
    inputs, _ = case
    want_l, want_p = _one_device(inputs, "lm", dropout=drop)
    got_l, got_p = ranks[dp - 1][("lm", drop, dp)]
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
    assert_params_close(got_p, want_p, RTOL, ATOL)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_lm_step_equals_jax(case, ranks, dp):
    inputs, jax_res = case
    want_l, want_params = jax_res["lm"]
    want_p = _jax_sd(lambda: P.create_gpt_mop(64, P.TransformerConfig(**GPT_CFG),
                                              device="cpu", **GPT_KW), want_params)
    got_l, got_p = (_one_device(inputs, "lm", dropout=0.0) if dp == 1
                    else ranks[0][("lm", 0.0, dp)])
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
    assert_params_close(got_p, want_p, RTOL, 5e-5)


def test_dp_imagenet_step_equals_one_device(case, ranks):
    """RandAugment, RandomErasing and Mixup / CutMix (which pair rows across
    processes) under the data axis: the one-device step's draws and pairs."""
    inputs, _ = case
    want_l, want_p = _one_device(inputs, "imagenet")
    got_l, got_p = ranks[1]["imagenet"]
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL, atol=ATOL)
    assert_params_close(got_p, want_p, RTOL, ATOL)


def test_dp_step_collectives(ranks):
    """One data-parallel step's only traffic is the gradient all-reduce (plus
    the loss and accuracy): its bytes are the fp32 param bytes, no gather and
    no all-to-all."""
    s = ranks[0]["dp_collectives"]
    grad_bytes = 4 * ranks[0]["n_params"]
    assert s["all-reduce"]["count"] == 2, s
    assert grad_bytes <= s["all-reduce"]["bytes"] <= int(1.25 * grad_bytes) + 16384, s
    assert set(s) == {"all-reduce"}, s


def test_one_device_step_runs_no_collective(case):
    """A world-1 step with no process group calls no collective."""
    inputs, _ = case
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is None
    model = P.ViT_MoP(**VIT_KW, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, mesh=mesh)
    with record_collectives() as rec:
        step(inputs["xs"][0], inputs["ys"][0])
    assert collective_summary(rec) == {}


def test_only_the_main_process_writes(ranks):
    for r in ranks:
        assert r["written"] == ["written_by_0.csv"]


def test_mesh_shortfall_raises(ranks):
    with pytest.raises(ValueError, match="n_devices=16"):
        make_mesh(n_devices=16, device="cpu")
    for r in ranks:
        assert "n_devices=8" in r["shortfall"] and "only 4" in r["shortfall"]
        assert r[("mesh", 2)][0] == {"data": 2, "model": 2}
    assert sorted(tuple(r[("mesh", 2)][1].values()) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_resolve_device_names_the_process_card(ranks, monkeypatch):
    """Under a process group the GPU branch names ``cuda:LOCAL_RANK``; with no
    group it stays the current card."""
    for r in ranks:
        assert r["resolve_device"] == f"cuda:{r['local_rank']}"
        assert r["resolve_bare_cuda"] == f"cuda:{r['local_rank']}"
    assert sorted(r["local_rank"] for r in ranks) == [0, 1, 2, 3]
    from mop_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert str(resolve_device()) == "cuda" and str(resolve_device("cuda:1")) == "cuda:1"
