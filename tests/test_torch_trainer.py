"""The port's ``Trainer`` and ``train_model`` against the JAX package's, on
the CPU.

- ``Trainer``: the JAX trainer's params carried over by
  ``load_jax_params``, augment off, drop-path 0, fp32 compute, AdamW with
  ``cosine_lr`` (warmup then decay within the run): each of 5 steps' loss
  (``train_epoch`` over one batch an epoch) within rtol 2e-4, the fp32
  step test's tolerance (``tests/test_torch_train_step.py``), and
  ``evaluate``'s counts equal, padding masked out.
- ``train_model``: JAX's history keys; the params redrawn from ``seed``
  (two runs from differently initialised models end equal); eval every
  ``eval_every`` steps; background checkpoints every ``ckpt_every`` steps;
  SIGTERM in the run checkpoints and exits 75, and ``resume=True`` ends
  bit-equal to an uninterrupted run, as ``tests/test_preemption.py``'s
  in-process test (the killed child process is in
  ``test_torch_trainer_preemption.py``).
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
from mop_tpu_torch.training import (PREEMPTED_EXIT_CODE, AsyncCheckpointManager, Trainer,
                                    cosine_lr, train_model)
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
MEAN, STD = P.CIFAR100_MEAN, P.CIFAR100_STD
STEPS, B = 5, 16


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (STEPS, B, 3, 32, 32), dtype=np.uint8)
    y = rng.integers(0, 10, (STEPS, B)).astype(np.int32)
    vx = rng.integers(0, 256, (2, B, 3, 32, 32), dtype=np.uint8)
    vy = rng.integers(0, 10, (2, B)).astype(np.int32)
    vm = np.ones((2, B), np.float32)
    vm[1, 11:] = 0.0  # a padded last batch
    return x, y, list(zip(vx, vy, vm))


def test_trainer_matches_jax(name="ViT_MoP"):
    x, y, val = _data()
    jm = getattr(J, name)(**SMALL)
    jt = JaxTrainer(jm, mesh=make_mesh(n_devices=1), use_amp=False, mean=MEAN, std=STD,
                    augment=False)
    params = jt.init(jax.random.PRNGKey(1))
    init = jax.device_get(params)  # a host copy: the JAX step donates its params
    opt = jt.setup_optimizer(optax.adamw(jax_cosine_lr(1e-3, 2, STEPS), weight_decay=0.05),
                             params)
    want = []
    for e in range(STEPS):
        params, opt, m = jt.train_epoch(params, opt, [(x[e], y[e])], jax.random.PRNGKey(0), 1,
                                        epoch=e, log_interval=0)
        want.append(m)
    want_eval = jt.evaluate(params, val)

    pm = load_jax_params(getattr(P, name)(**SMALL, device="cpu"), init)
    tt = Trainer(pm, device="cpu", use_amp=False, mean=MEAN, std=STD, augment=False)
    tt.setup_optimizer(cosine_lr(1e-3, 2, STEPS), weight_decay=0.05)
    got = [tt.train_epoch([(x[e], y[e])], seed=0, steps_per_epoch=1, epoch=e, log_interval=0)
           for e in range(STEPS)]
    assert tt.count == STEPS
    assert [sorted(m) for m in got] == [sorted(m) for m in want] == [["accuracy", "loss"]] * 5
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in want], rtol=2e-4)
    np.testing.assert_allclose([m["accuracy"] for m in got], [m["accuracy"] for m in want])
    got_eval = tt.evaluate(val)
    assert sorted(got_eval) == sorted(want_eval) == ["accuracy", "correct", "total"]
    assert got_eval["total"] == want_eval["total"] == 2 * B - 5
    assert got_eval == pytest.approx(want_eval)


def test_trainer_schedule_steps_where_optax_does():
    """The lr of update ``count`` is ``schedule(count)``, as optax's adamw."""
    model = P.ViT_Baseline(dim=16, depth=1, heads=2, n_classes=10, device="cpu")
    tt = Trainer(model, device="cpu", augment=True)
    tt.init(torch.Generator().manual_seed(0))
    sched = cosine_lr(3e-3, 3, 10)
    opt = tt.setup_optimizer(sched, weight_decay=0.05)
    seen = []
    step = tt._train_step
    tt._train_step = lambda *a: (seen.append(opt.param_groups[0]["lr"]), step(*a))[1]
    x, y, _ = _data()
    for i in range(10):
        tt.step(x[0, :4], y[0, :4], seed=0, step_i=i)
    jsched = jax_cosine_lr(3e-3, 3, 10)
    assert seen == [float(jsched(i)) for i in range(10)]
    with pytest.raises(RuntimeError, match="setup_optimizer"):
        Trainer(model, device="cpu").step(x[0], y[0], 0, 0)


def _model(seed):
    return P.ViT_Baseline(dim=32, depth=1, heads=2, n_classes=4, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _batches(kill_at=None):
    """A constant batch, as tests/test_preemption.py's; SIGTERM to this
    process before the batch of step ``kill_at``."""
    rs = np.random.RandomState(0)
    xb = rs.randint(0, 256, (8, 3, 32, 32)).astype(np.uint8)
    yb = rs.randint(0, 4, (8,)).astype(np.int64)
    step = 0
    while True:
        if kill_at is not None and step == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        step += 1
        yield xb, yb


def _equal_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def test_train_model_history_eval_and_checkpoints(tmp_path, capsys):
    x, y, val = _data()
    model, hist = train_model(_model(0), _batches(), lambda: iter(val), 6, eval_every=3,
                              seed=3, device="cpu", mean=MEAN, std=STD,
                              ckpt_dir=str(tmp_path), ckpt_every=2)
    assert sorted(hist) == ["time_min", "train_loss", "val_acc"]
    assert len(hist["train_loss"]) == 6 and len(hist["val_acc"]) == 2
    assert len(hist["time_min"]) == 1 and all(np.isfinite(hist["train_loss"]))
    assert "step 0/6 loss" in capsys.readouterr().out
    with AsyncCheckpointManager(str(tmp_path)) as mgr:
        assert mgr.all_steps() == [4, 6]  # keep=2
        saved = mgr.restore()["params"]
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())
    # The params are redrawn from ``seed``: another initial model, the same run.
    other, _ = train_model(_model(1), _batches(), lambda: iter(val), 6, eval_every=3, seed=3,
                           device="cpu", mean=MEAN, std=STD, verbose=False)
    assert _equal_params(model, other)


def test_train_model_preemption_and_resume(tmp_path):
    steps, ckpt = 6, str(tmp_path / "ck")
    kw = dict(device="cpu", mean=MEAN, std=STD, verbose=False, seed=1)
    prev_handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as e:
        train_model(_model(0), _batches(kill_at=3), lambda: [], steps, ckpt_dir=ckpt,
                    ckpt_every=100, **kw)
    assert e.value.code == PREEMPTED_EXIT_CODE
    assert signal.getsignal(signal.SIGTERM) == prev_handler  # uninstalled
    with AsyncCheckpointManager(ckpt, keep=2) as mgr:
        saved = mgr.latest_step()
    assert saved == 4  # the signal came with step 3's batch: saved after that step
    resumed, hist = train_model(_model(0), _batches(), lambda: [], steps, ckpt_dir=ckpt,
                                resume=True, **kw)
    assert len(hist["train_loss"]) == steps - saved  # no step repeated
    solo, hist_solo = train_model(_model(0), _batches(), lambda: [], steps, **kw)
    assert hist["train_loss"] == hist_solo["train_loss"][saved:]
    assert _equal_params(resumed, solo)


def test_train_model_raises_without_a_gpu_or_device(monkeypatch):
    model = _model(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_model(model, _batches(), lambda: [], 2, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
