"""The port's training utilities against the JAX package's, on the CPU.

- ``cosine_lr``: the JAX schedule's value at every step 0 .. total + 2
  (both in float32, so equal, not close); ``format_time``,
  ``print_model_info``, ``AverageMeter`` and ``EarlyStopping`` over the same
  sequences.
- ``AsyncCheckpointManager``, the claims of ``tests/test_async_checkpoint.py``
  on one device: a save is in flight while train steps run and the bytes
  written are the snapshot passed to ``save``; retention; the latest step
  restored and trained on equal to an uninterrupted run; an empty directory
  raises. ``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` round trip.
- ``PreemptionGuard`` with a manager and ``resume_latest``, the claims of
  ``tests/test_preemption.py``: a signal sets the flag, the previous
  handler is chained and restored, the guard saves and then exits 75, and an
  empty directory resumes at step 0 (``test_torch_trainer_preemption.py``
  kills a real process).
"""

import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.training.utils as JU
import mop_tpu_torch as P
import mop_tpu_torch.training as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIG = signal.SIGUSR1  # in-process tests use a harmless signal
MEAN, STD = P.CIFAR100_MEAN, P.CIFAR100_STD


@pytest.mark.parametrize("base_lr,warmup,total", [(3e-3, 50, 1000), (1e-3, 1, 7),
                                                   (0.1, 0, 10), (5e-4, 12, 12)])
def test_cosine_lr_equals_jax_at_every_step(base_lr, warmup, total):
    got = T.cosine_lr(base_lr, warmup, total)
    want = JU.cosine_lr(base_lr, warmup, total)
    for step in range(total + 3):
        assert got(step) == float(want(step)), step


def test_format_time_print_model_info_and_average_meter(capsys):
    for s in (0, 59.9, 61, 3599, 3600, 7322.5):
        assert T.format_time(s) == JU.format_time(s)
    model = P.ViT_Baseline(dim=32, depth=1, heads=4, n_classes=10, device="meta")
    T.print_model_info("A", model)
    n = T.count_params(model)
    assert capsys.readouterr().out == f"A: {n:,} trainable params ({n / 1e6:.2f}M)\n"
    rng = np.random.default_rng(0)
    vals, ns = rng.normal(size=20), rng.integers(1, 9, size=20)
    got, want = T.AverageMeter(), JU.AverageMeter()
    for v, k in zip(vals, ns):
        got.update(float(v), int(k))
        want.update(float(v), int(k))
        assert (got.val, got.sum, got.count, got.avg) == (want.val, want.sum, want.count,
                                                         want.avg)
    got.reset()
    assert (got.val, got.avg, got.sum, got.count) == (0.0, 0.0, 0.0, 0)


def test_early_stopping_follows_jax_and_keeps_the_best_weights():
    metrics = [0.1, 0.3, 0.29, 0.305, 0.31, 0.2, 0.2, 0.2, 0.5, 0.4, 0.4, 0.4]
    model = torch.nn.Linear(3, 2)
    got = T.EarlyStopping(patience=3, min_delta=0.01)
    want = JU.EarlyStopping(patience=3, min_delta=0.01)
    best_w = None
    for i, m in enumerate(metrics):
        with torch.no_grad():
            model.weight.fill_(float(i))
        stop = got.step(m, model)
        assert stop == want.step(m, {"w": jnp.full((2, 3), float(i))})
        assert (got.best, got.counter, got.should_stop) == (want.best, want.counter,
                                                            want.should_stop)
        if got.best == m:
            best_w = float(i)
    # The copy is a snapshot: later updates of the model do not reach it.
    assert torch.equal(got.best_params["weight"], torch.full((2, 3), best_w))
    assert float(want.best_params["w"][0, 0]) == best_w


def _tiny_setup():
    """ViT_MoP (32 wide, 1 deep) with AdamW and its fp32 train step, no
    augment, and one batch, as ``tests/test_async_checkpoint.py``."""
    model = P.ViT_MoP(dim=32, depth=1, heads=2, n_classes=10, n_views=2, n_kernels=2,
                      drop_path=0.0, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, device="cpu")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 256, (16, 3, 32, 32), dtype=np.uint8))
    y = torch.from_numpy(rs.randint(0, 10, (16,)))
    return model, opt, step, x, y


def _run(step, x, y, steps, start=0, save_at=(), mgr=None, model=None, opt=None):
    for k in range(start, start + steps):
        m = step(x, y)
        if k in save_at:
            mgr.save(k, model, opt_state=opt)
    return float(m["loss"])


def test_save_restore_retention_and_resume(tmp_path):
    model, opt, step, x, y = _tiny_setup()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with T.AsyncCheckpointManager(str(tmp_path / "ckpt"), keep=2) as mgr:
        _run(step, x, y, 6, save_at={1, 3, 5}, mgr=mgr, model=model, opt=opt)
        mgr.wait_until_finished()
        assert mgr.all_steps() == [3, 5]  # keep=2: only the two newest survive
        assert mgr.latest_step() == 5
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "5"]  # no temporary left
        # A fresh model and optimizer restored from the latest step, 2 more
        # steps: the same as 8 uninterrupted steps, exactly.
        model2, opt2, step2, _, _ = _tiny_setup()
        got = mgr.restore(like={"params": model2, "opt_state": opt2})
        assert got["params"] is model2 and got["opt_state"] is opt2
        loss8 = _run(step2, x, y, 2, start=6)
    model3, opt3, step3, _, _ = _tiny_setup()
    model3.load_state_dict(init)
    ref = _run(step3, x, y, 8)
    assert loss8 == ref
    for k, v in model3.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k


def test_async_overlap_and_snapshot_equality(tmp_path, monkeypatch):
    """The write runs in the background while training goes on, and what
    lands on disk is the state passed to ``save``, not a later one. The
    write is slowed here so that it is surely in flight."""
    import mop_tpu_torch.training.utils as TU

    model, opt, step, x, y = _tiny_setup()
    write = TU._write_step_dir

    def slow_write(path, payload):
        time.sleep(0.5)
        write(path, payload)

    monkeypatch.setattr(TU, "_write_step_dir", slow_write)
    with T.AsyncCheckpointManager(str(tmp_path / "ckpt"), keep=3) as mgr:
        step(x, y)
        snap = {k: v.clone() for k, v in model.state_dict().items()}
        mgr.save(0, model, opt_state=opt, extra={"ema": torch.ones(2)})
        assert mgr.is_saving()
        for _ in range(3):  # keep training while the save streams
            step(x, y)
        assert mgr.all_steps() == []  # not visible until whole
        mgr.wait_until_finished()
        assert not mgr.is_saving()
        got = mgr.restore(step=0)
    assert sorted(got) == ["extra", "opt_state", "params"]
    assert torch.equal(got["extra"]["ema"], torch.ones(2))
    for k, v in snap.items():
        assert torch.equal(got["params"][k], v), k
    assert not all(torch.equal(got["params"][k], v) for k, v in model.state_dict().items())


def test_restore_empty_raises_and_orbax_named_round_trip(tmp_path):
    with T.AsyncCheckpointManager(str(tmp_path / "ckpt")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()
    model, opt, step, x, y = _tiny_setup()
    step(x, y)
    path = str(tmp_path / "orbax_named")
    T.save_checkpoint_orbax(path, model, opt, step=7)
    got = T.load_checkpoint_orbax(path)
    assert got["step"] == 7 and sorted(got) == ["opt_state", "params", "step"]
    for k, v in model.state_dict().items():
        assert torch.equal(got["params"][k], v), k
    # ``like`` puts a state dict's tensors on its devices and dtypes.
    like = {"params": {k: v.double() for k, v in model.state_dict().items()}}
    got = T.load_checkpoint_orbax(path, like=like)
    assert all(v.dtype == torch.float64 for v in got["params"].values()
               if v.is_floating_point())


def _wait_for(cond):
    deadline = time.time() + 5
    while not cond():
        assert time.time() < deadline
        time.sleep(0.01)


def test_guard_flag_set_by_signal_and_uninstall_restores():
    prev = signal.getsignal(SIG)
    with T.PreemptionGuard(signals=(SIG,)) as guard:
        assert not guard.preempted
        os.kill(os.getpid(), SIG)
        _wait_for(lambda: guard.preempted)
    assert signal.getsignal(SIG) == prev


def test_guard_chains_previous_handler():
    hits = []
    orig = signal.getsignal(SIG)
    signal.signal(SIG, lambda s, f: hits.append(s))
    try:
        with T.PreemptionGuard(None, signals=(SIG,)) as guard:
            os.kill(os.getpid(), SIG)
            _wait_for(lambda: guard.preempted and hits)
        assert hits == [SIG]
    finally:
        signal.signal(SIG, orig)


def test_maybe_checkpoint_and_exit_saves_then_exits(tmp_path):
    model = torch.nn.Linear(4, 1)
    with torch.no_grad():
        model.weight.copy_(torch.arange(4.0))
    with T.AsyncCheckpointManager(str(tmp_path), keep=2) as mgr:
        guard = T.PreemptionGuard(mgr, signals=(SIG,))
        guard.maybe_checkpoint_and_exit(3, model)  # no signal: no-op
        assert mgr.latest_step() is None
        guard.signal_now()
        with pytest.raises(SystemExit) as e:
            guard.maybe_checkpoint_and_exit(3, model)
        assert e.value.code == T.PREEMPTED_EXIT_CODE == 75
        assert mgr.latest_step() == 3
        fresh = torch.nn.Linear(4, 1)
        step, restored, opt = T.resume_latest(mgr, fresh)
        assert step == 3 and restored is fresh and opt is None
        assert torch.equal(fresh.weight, model.weight)
        # A state dict in: the saved state dict out.
        step, sd, _ = T.resume_latest(mgr, {k: torch.zeros_like(v)
                                           for k, v in model.state_dict().items()})
        assert torch.equal(sd["weight"], model.weight)


def test_resume_latest_empty_dir_is_step_zero(tmp_path):
    model = torch.nn.Linear(2, 1)
    with T.AsyncCheckpointManager(str(tmp_path), keep=1) as mgr:
        step, p, o = T.resume_latest(mgr, model, None)
    assert step == 0 and p is model and o is None
