"""``Trainer`` and ``train_model`` with their steps as CUDA graphs, on the CPU,
where no CUDA graph can be captured.

- The refusals: ``Trainer(cuda_graph=True)`` on the CPU; ``cuda_graph=None``
  stays eager there (a float lr, no graph).
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): the graphed
  ``Trainer.step`` (its lr an fp32 tensor filled in place) bit-equal to the
  eager step over 3 steps with a warmup and cosine schedule, augment and
  drop-path drawing from the generator; the lr tensor equal to
  ``cosine_lr`` step by step; ``evaluate`` through the eval graph;
  ``init()`` after a capture makes the steps anew; ``train_model``'s
  resume under the graph (``restore_capturable``, the step made again)
  bit-equal to the uninterrupted run; the graphed trainer's losses against
  JAX's ``Trainer`` (its jitted classifier step) at rtol 2e-4 / atol 2e-5,
  fp32 compute on both sides.
"""

import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.parallel import make_mesh
from mop_tpu.training import Trainer as JaxTrainer
from mop_tpu.training import cosine_lr as jax_cosine_lr
from mop_tpu_torch.parallel import train_step as TS
from mop_tpu_torch.training import PREEMPTED_EXIT_CODE, Trainer, cosine_lr, train_model
from mop_tpu_torch.training import trainer as TR
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lifted(monkeypatch):
    """The graphed trainer on the CPU: ``require_graph`` accepts any device."""
    for mod in (TS, TR):
        monkeypatch.setattr(mod, "require_graph", lambda *a, **k: None)


MEAN, STD = P.CIFAR100_MEAN, P.CIFAR100_STD
SMALL = dict(dim=32, depth=2, heads=4, n_classes=10)
STEPS, B = 3, 8


def _mop(seed=0, drop_path=0.1):
    return P.ViT_MoP(**SMALL, n_views=3, n_kernels=3, drop_path=drop_path, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _data(seed=0, n=STEPS):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, B, 3, 32, 32), dtype=np.uint8)
    y = rng.integers(0, 10, (n, B)).astype(np.int64)
    mask = np.ones(B, np.float32)
    mask[B - 3:] = 0.0  # a padded val batch
    return x, y, [(x[0], y[0], np.ones(B, np.float32)), (x[1], y[1], mask)]


def test_cuda_graph_refuses_the_cpu():
    with pytest.raises(ValueError, match="Trainer: cuda_graph=True needs a CUDA device"):
        Trainer(_mop(), device="cpu", cuda_graph=True)


def test_cuda_graph_none_stays_eager_on_the_cpu():
    tt = Trainer(_mop(), device="cpu", mean=MEAN, std=STD)
    opt = tt.setup_optimizer(cosine_lr(1e-3, 1, STEPS))
    assert not tt.graphed and tt._eval_step.graphs is None and tt._train_step.graph is None
    assert isinstance(opt.param_groups[0]["lr"], float) and not opt.param_groups[0]["capturable"]


def _trained(graphed, steps=STEPS):
    """A trainer of ``_mop()`` (bf16 compute, augment on, drop-path 0.1) after
    ``steps`` steps of warmup (one step) and cosine decay: (trainer, each
    step's loss and accuracy, the lr before each step)."""
    tt = Trainer(_mop(), device="cpu", mean=MEAN, std=STD, cuda_graph=graphed)
    opt = tt.setup_optimizer(cosine_lr(3e-3, 1, steps), weight_decay=0.05)
    x, y, _ = _data()
    out, lrs = [], []
    step = tt._train_step
    tt._train_step = lambda *a: (lrs.append(opt.param_groups[0]["lr"]), step(*a))[1]
    for i in range(steps):
        out.append(tt.step(x[i], y[i], seed=5, step_i=i))
    tt._train_step = step
    return tt, out, lrs


def test_static_trainer_step_is_the_eager_step(lifted):
    """Losses, accuracies and every parameter bit-equal over 3 steps; the
    graphed trainer's lr is one fp32 tensor, filled with ``cosine_lr``'s
    value before each update (the eager one's a float of that value)."""
    eager, e_out, e_lrs = _trained(False)
    graphed, g_out, g_lrs = _trained(True)
    assert graphed._train_step.graph is not None and graphed._train_step.graph.calls == STEPS
    for a, b in zip(e_out, g_out):
        for k in ("loss", "acc"):
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)
    for a, b in zip(eager.model.parameters(), graphed.model.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    lr = graphed._lr
    assert lr.dtype == torch.float32 and all(t is lr for t in g_lrs)
    sched = cosine_lr(3e-3, 1, STEPS)
    assert e_lrs == [sched(i) for i in range(STEPS)]
    assert float(lr) == sched(STEPS - 1)
    _, _, val = _data()
    assert graphed.evaluate(val) == eager.evaluate(val)
    (eval_graph,) = graphed._eval_step.graphs.graphs.values()
    assert eval_graph.calls == len(val)


def test_the_lr_tensor_follows_cosine_lr_step_by_step(lifted):
    tt = Trainer(_mop(drop_path=0.0), device="cpu", mean=MEAN, std=STD, augment=False,
                 cuda_graph=True)
    sched = cosine_lr(3e-3, 3, 8)
    opt = tt.setup_optimizer(sched, weight_decay=0.05)
    x, y, _ = _data()
    seen = []
    step = tt._train_step
    tt._train_step = lambda *a: (seen.append(float(opt.param_groups[0]["lr"])), step(*a))[1]
    for i in range(8):
        tt.step(x[0], y[0], seed=0, step_i=i)
    jsched = jax_cosine_lr(3e-3, 3, 8)
    assert seen == [float(np.float32(jsched(i))) for i in range(8)]
    assert opt.param_groups[0]["lr"] is tt._lr


def test_init_after_a_capture_makes_the_steps_anew(lifted):
    """``init()`` moves the parameters to the CPU and back (new storage):
    the train and eval graphs are dropped and made again, and the next step
    runs over the redrawn parameters."""
    tt = Trainer(_mop(), device="cpu", mean=MEAN, std=STD, cuda_graph=True)
    tt.setup_optimizer(cosine_lr(1e-3, 1, 5))
    x, y, val = _data()
    for i in range(2):
        tt.step(x[i], y[i], seed=0, step_i=i)
    tt.evaluate(val)
    old_train, old_eval = tt._train_step.graph, tt._eval_step.graphs
    assert old_train.calls == 2 and old_eval.graphs
    tt.init(torch.Generator().manual_seed(4))
    assert tt._train_step.graph is not old_train and tt._train_step.graph.calls == 0
    assert tt._eval_step.graphs is not old_eval and not tt._eval_step.graphs.graphs
    fresh = Trainer(_mop(), device="cpu", mean=MEAN, std=STD, cuda_graph=True)
    fresh.init(torch.Generator().manual_seed(4))
    for a, b in zip(tt.model.parameters(), fresh.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tt.step(x[2], y[2], seed=0, step_i=2)["loss"].isfinite()


def _batches(kill_at=None):
    """A constant batch; SIGTERM to this process before the batch of step
    ``kill_at``."""
    rs = np.random.RandomState(0)
    xb = rs.randint(0, 256, (8, 3, 32, 32)).astype(np.uint8)
    yb = rs.randint(0, 4, (8,)).astype(np.int64)
    step = 0
    while True:
        if kill_at is not None and step == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        step += 1
        yield xb, yb


def _model(seed):
    return P.ViT_Baseline(dim=32, depth=1, heads=2, n_classes=4, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def test_graphed_train_model_resumes_bit_equal(tmp_path, monkeypatch, lifted):
    """Preempted after step 3's batch, resumed from step 4 (the checkpoint's
    tensor lr replaced by the trainer's, the step made again over the loaded
    state): the losses and parameters of the uninterrupted graphed run, and
    the evals through the eval graph."""
    made = []

    def graphed_trainer(*a, **kw):
        made.append(Trainer(*a, cuda_graph=True, **kw))
        return made[-1]

    monkeypatch.setattr(TR, "Trainer", graphed_trainer)
    steps, ckpt = 6, str(tmp_path / "ck")
    _, _, val = _data()
    kw = dict(device="cpu", mean=MEAN, std=STD, verbose=False, seed=1, eval_every=2)
    with pytest.raises(SystemExit) as e:
        train_model(_model(0), _batches(kill_at=3), lambda: iter(val), steps, ckpt_dir=ckpt,
                    ckpt_every=100, **kw)
    assert e.value.code == PREEMPTED_EXIT_CODE
    resumed, hist = train_model(_model(0), _batches(), lambda: iter(val), steps, ckpt_dir=ckpt,
                                resume=True, **kw)
    trainer = made[-1]
    assert trainer.count == steps and trainer.optimizer.param_groups[0]["lr"] is trainer._lr
    assert trainer._train_step.graph.calls == steps - 4
    solo, hist_solo = train_model(_model(0), _batches(), lambda: iter(val), steps, **kw)
    assert all(t.graphed for t in made) and made[-1]._train_step.graph.calls == steps
    assert hist["train_loss"] == hist_solo["train_loss"][4:]
    assert hist["val_acc"] == hist_solo["val_acc"][2:]
    for a, b in zip(resumed.state_dict().values(), solo.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_graphed_trainer_losses_follow_jax(lifted):
    """The JAX trainer's params carried over, augment off, drop-path 0, fp32
    compute, AdamW with ``cosine_lr``: each of 3 steps' loss within the fp32
    step tests' tolerance, ``evaluate``'s counts equal, padding masked out."""
    x, y, val = _data(seed=2)
    cfg = dict(SMALL, drop_path=0.0)
    jm = J.ViT_Baseline(**cfg)
    jt = JaxTrainer(jm, mesh=make_mesh(n_devices=1), use_amp=False, mean=MEAN, std=STD,
                    augment=False)
    params = jt.init(jax.random.PRNGKey(1))
    init = jax.device_get(params)  # a host copy: the JAX step donates its params
    opt = jt.setup_optimizer(optax.adamw(jax_cosine_lr(1e-3, 1, STEPS), weight_decay=0.05),
                             params)
    want = []
    for e in range(STEPS):
        params, opt, m = jt.train_epoch(params, opt, [(x[e], y[e].astype(np.int32))],
                                        jax.random.PRNGKey(0), 1, epoch=e, log_interval=0)
        want.append(m["loss"])
    want_eval = jt.evaluate(params, [(a, b.astype(np.int32), c) for a, b, c in val])

    pm = load_jax_params(P.ViT_Baseline(**cfg, device="cpu"), init)
    tt = Trainer(pm, device="cpu", use_amp=False, mean=MEAN, std=STD, augment=False,
                 cuda_graph=True)
    tt.setup_optimizer(cosine_lr(1e-3, 1, STEPS), weight_decay=0.05)
    got = [float(tt.step(x[e], y[e], seed=0, step_i=e)["loss"]) for e in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    got_eval = tt.evaluate(val)
    assert got_eval["total"] == want_eval["total"] == 2 * B - 3
    assert got_eval == pytest.approx(want_eval)


def test_graphed_trainer_builds_a_tensor_lr_and_graphs(lifted):
    """``Trainer(cuda_graph=True)``: the eval step's per-shape graphs at
    once; after ``setup_optimizer`` a tensor lr in every group (the AdamW
    capturable only on a CUDA device) and the train step's ``StepGraph``."""
    tt = Trainer(_mop(), device="cpu", mean=MEAN, std=STD, cuda_graph=True)
    assert tt._train_step is None and tt._eval_step.graphs is not None
    opt = tt.setup_optimizer(1e-3)
    assert opt.param_groups[0]["lr"] is tt._lr and not opt.param_groups[0]["capturable"]
    assert float(tt._lr) == np.float32(1e-3)
    assert tt._train_step.graph is not None and not tt._train_step.graph.captured
