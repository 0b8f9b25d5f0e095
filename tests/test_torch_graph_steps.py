"""The train steps' ``cuda_graph=True`` form on the CPU, where no CUDA graph can
be captured.

- The refusals: a CPU device, a mesh, an optimizer that is not capturable,
  a scanned step with remat, ``ModelRun`` asked for a graph on the CPU.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): each step
  against its eager form bit for bit over three calls, with augment,
  drop-path and dropout drawing from the generator; the outputs are clones;
  the guards (the captured generator, the lr, the batch shape).
- ``ModelRun``'s graphed form (its lr a tensor filled in place before each
  update) against JAX's scanned step (K = 3) with ``make_opt``'s optax
  schedule: the lr step by step, the losses and the parameters at rtol 2e-4
  / atol 2e-5 (fp32 compute on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.common as JC
import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.parallel import make_mesh as jax_mesh
from mop_tpu.parallel import make_scanned_classifier_train_step as jax_scanned_step
from mop_tpu_torch.experiments import common as TC
from mop_tpu_torch.ops import fused as F
from mop_tpu_torch.parallel import train_step as TS
from mop_tpu_torch.parallel.mesh import make_mesh
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MEAN, STD = P.CIFAR100_MEAN, P.CIFAR100_STD
SMALL = dict(dim=32, depth=2, heads=4, n_classes=10)
K = 3
LM_CFG = dict(n_layer=2, n_head=2, n_embd=32, dropout=0.1, block_size=16, bias=False)


def _vit(seed=0):
    return P.ViT_MoP(**SMALL, n_views=5, n_kernels=3, drop_path=0.1, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _lm(seed=0):
    return P.create_gpt_quartet(40, P.TransformerConfig(**LM_CFG), device="cpu",
                                generator=torch.Generator().manual_seed(seed))


def _batch(kind, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "lm":
        ids = torch.from_numpy(rs.randint(0, 40, (4, 17)))
        return ids[:, :-1], ids[:, 1:]
    lead = (K,) if kind == "scanned" else ()
    return (torch.from_numpy(rs.randint(0, 256, lead + (8, 3, 32, 32)).astype(np.uint8)),
            torch.from_numpy(rs.randint(0, 10, lead + (8,))))


STEPS = {
    "one": (_vit, lambda m, opt, **kw: P.make_classifier_train_step(
        m, opt, MEAN, STD, grad_clip=1.0, device="cpu", **kw)),
    "scanned": (_vit, lambda m, opt, **kw: P.make_scanned_classifier_train_step(
        m, opt, MEAN, STD, K, grad_clip=1.0, device="cpu", **kw)),
    "lm": (_lm, lambda m, opt, **kw: P.make_lm_train_step(m, opt, grad_clip=1.0, device="cpu",
                                                          **kw)),
}


def _adamw(model, capturable=False):
    return torch.optim.AdamW(model.parameters(), lr=torch.tensor(1e-3), weight_decay=0.05,
                             capturable=capturable)


@pytest.mark.parametrize("kind", list(STEPS))
def test_cuda_graph_refuses_the_cpu(kind):
    make_model, build = STEPS[kind]
    model = make_model()
    with pytest.raises(ValueError, match="needs a CUDA device, not cpu"):
        build(model, _adamw(model, capturable=True), cuda_graph=True)


@pytest.mark.parametrize("kind", list(STEPS))
def test_cuda_graph_refuses_a_mesh(kind):
    make_model, build = STEPS[kind]
    model = make_model()
    with pytest.raises(ValueError, match="does not take a mesh"):
        build(model, _adamw(model, capturable=True), mesh=make_mesh(device="cpu"),
              cuda_graph=True)


@pytest.mark.parametrize("kind", list(STEPS))
@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_cuda_graph_refuses_a_non_capturable_optimizer(kind, opt):
    make_model, build = STEPS[kind]
    model = make_model()
    optimizer = (_adamw(model) if opt == "adamw"
                 else torch.optim.SGD(model.parameters(), lr=1e-3))
    with pytest.raises(ValueError, match="capturable optimizer"):
        build(model, optimizer, cuda_graph=True)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_scanned_cuda_graph_refuses_remat(remat):
    model = _vit()
    with pytest.raises(ValueError, match="remat"):
        P.make_scanned_classifier_train_step(model, _adamw(model, capturable=True), MEAN, STD,
                                             K, remat=remat, device="cpu", cuda_graph=True)


def test_model_run_graphs_by_the_device_and_refuses_the_cpu():
    run = TC.ModelRun("A", _vit(), 3e-3, MEAN, STD, 10, 0.1, 0.05, seed=0, device="cpu")
    assert not run.graphed and isinstance(run.opt.param_groups[0]["lr"], float)
    assert run.train_step.graph is None
    with pytest.raises(ValueError, match="CUDA device"):
        TC.ModelRun("A", _vit(), 3e-3, MEAN, STD, 10, 0.1, 0.05, seed=0, device="cpu",
                    cuda_graph=True)


@pytest.fixture
def lifted(monkeypatch):
    """The graphed steps on the CPU: ``require_graph`` accepts any device."""
    for mod in (TS, TC):
        monkeypatch.setattr(mod, "require_graph", lambda *a, **k: None)


@pytest.mark.parametrize("kind", list(STEPS))
def test_static_form_is_the_eager_step(kind, lifted):
    """Three calls of each form from the same weights and generator seeds:
    losses (and accuracies) and every parameter bit-equal; an output kept
    from the first call is not overwritten by the next."""
    make_model, build = STEPS[kind]
    x, y = _batch(kind)
    out, params = {}, {}
    for graphed in (False, True):
        model = make_model()
        step = build(model, _adamw(model), cuda_graph=graphed)
        gen = torch.Generator()
        seen = []
        for i in range(3):
            gen.manual_seed(10 + i)
            seen.append(step(x, y, gen))
        first = {k: v.clone() for k, v in seen[0].items()}
        assert all(torch.equal(first[k], seen[0][k]) for k in first)
        if graphed:
            assert step.graph.calls == 3 and len(step.graph.static) == 2
        out[graphed] = seen
        params[graphed] = [p.detach().clone() for p in model.parameters()]
    for a, b in zip(out[False], out[True]):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)
    for a, b in zip(params[False], params[True]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("kind", list(STEPS))
def test_graphed_step_guards(kind, lifted):
    """A captured step refuses another generator, a changed lr (a number,
    or another tensor in its place) and another batch shape."""
    make_model, build = STEPS[kind]
    model = make_model()
    opt = _adamw(model)
    step = build(model, opt, cuda_graph=True)
    x, y = _batch(kind)
    gen = torch.Generator().manual_seed(0)
    step(x, y, gen)
    with pytest.raises(ValueError, match="generator it was captured with"):
        step(x, y, torch.Generator().manual_seed(0))
    lr = opt.param_groups[0]["lr"]
    lr.fill_(2e-3)  # in place: the graph reads it
    step(x, y, gen)
    opt.param_groups[0]["lr"] = torch.tensor(2e-3)
    with pytest.raises(ValueError, match="lr changed"):
        step(x, y, gen)
    opt.param_groups[0]["lr"] = lr
    with pytest.raises(ValueError, match="one shape"):
        step(x[..., :4, :, :, :] if kind != "lm" else x[:2], y[..., :4] if kind != "lm"
             else y[:2], gen)


def test_a_float_lr_is_held_to_its_captured_value(lifted):
    model = _vit()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = STEPS["one"][1](model, opt, cuda_graph=True)
    x, y = _batch("one")
    gen = torch.Generator().manual_seed(0)
    step(x, y, gen)
    step(x, y, gen)  # the same number: fine
    opt.param_groups[0]["lr"] = 5e-4
    with pytest.raises(ValueError, match="lr changed"):
        step(x, y, gen)


def test_replays_add_the_captured_launches():
    before = F.launch_counts()
    F.add_launches({"flash_attention": 3, "fused_quartet_attention": 2})
    after = F.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 3
    assert after["fused_quartet_attention"] == before["fused_quartet_attention"] + 2
    F.add_launches({k: -v for k, v in {"flash_attention": 3,
                                       "fused_quartet_attention": 2}.items()})
    assert F.launch_counts() == before


def test_model_run_tensor_lr_follows_optax_through_jax_scanned_step(monkeypatch, lifted):
    """K = 3 updates by warmup (one step) + cosine: the graphed ModelRun's lr
    tensor (the same object every step) holds optax's schedule value before
    each update, and the losses and parameters follow JAX's scanned step,
    fp32 compute on both sides."""
    lr, steps, warmup, wd = 3e-3, 4, 0.25, 0.05
    jm = J.ViT_Baseline(**SMALL, drop_path=0.0)
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                       jnp.zeros((2, 3, 32, 32)), train=True))(key)
    host = jax.device_get(params)  # the scanned step donates its params
    tx = JC.make_opt(lr, steps, warmup, wd)
    mesh = jax_mesh()
    x, y = _batch("scanned", seed=3)
    jstep = jax_scanned_step(jm, tx, mesh, MEAN, STD, K, augment=False,
                             compute_dtype=jnp.float32)
    jparams, _, jm_out = jstep(params, tx.init(params), jnp.asarray(x.numpy()),
                               jnp.asarray(y.numpy().astype(np.int32)), key)

    monkeypatch.setattr(TC, "make_classifier_train_step",
                        functools.partial(P.make_classifier_train_step, compute_dtype=None))
    model = load_jax_params(P.ViT_Baseline(**SMALL, drop_path=0.0, device="cpu"), host)
    run = TC.ModelRun("A", model, lr, MEAN, STD, steps, warmup, wd, seed=0, augment=False,
                      device="cpu", cuda_graph=True)
    lr_t = run.opt.param_groups[0]["lr"]
    assert isinstance(lr_t, torch.Tensor) and run.train_step.graph is not None
    seen, losses = [], []
    for i in range(K):
        run.step(x[i].numpy(), y[i].numpy(), i)
        assert run.opt.param_groups[0]["lr"] is lr_t
        seen.append(float(lr_t))
        losses.append(float(run.loss_handle))
    want = JC.make_lr_schedule(lr, steps, warmup)
    np.testing.assert_allclose(seen, [float(want(i)) for i in range(K)], rtol=1e-6)
    assert seen == [run.schedule(i) for i in range(K)]
    np.testing.assert_allclose(losses, np.asarray(jm_out["loss"]), rtol=2e-4, atol=2e-5)
    ref = load_jax_params(P.ViT_Baseline(**SMALL, drop_path=0.0, device="cpu"),
                          jax.device_get(jparams))
    got = dict(run.model.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), p.detach().numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
