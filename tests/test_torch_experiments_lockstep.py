"""Lockstep training of the port's harness against the JAX harness's.

Tiny A and E (lowrank gates) runs, the JAX ``ModelRun``'s initial params
carried into the port's by ``load_jax_params``, augment off and drop-path 0,
train 5 lockstep steps on the same batches with the harness's warmup +
cosine AdamW, with an eval every step. Both sides at fp32 compute (the JAX
harness's step built with ``compute_dtype=jnp.float32`` by patching the name
it calls in this test, the port's with ``compute_dtype=None``): per-step
losses within rtol 2e-4, the fp32 step test's tolerance
(``tests/test_torch_train_step.py``), and the val accuracies equal. The bf16
default is in ``test_torch_experiments_lockstep_bf16.py``, a file of its own
so that each file's JAX compiles stay on one worker."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import experiments.common as JC
import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.data import BatchIterator, eval_batches, synthetic_cifar
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_mesh
from mop_tpu_torch.experiments import common as TC
from mop_tpu_torch.parallel import make_classifier_train_step as torch_train_step
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(dim=32, depth=2, heads=4, n_classes=100, drop_path=0.0)
E_KW = dict(n_views=5, gate_mode="lowrank", gate_rank=4, gate_init="neutral", mlp_ratio=4.0)
MODELS = {"A": ("ViT_Baseline", {}), "E": ("ViTEdgewise", E_KW)}
STEPS, WARMUP, LR, WD, BATCH = 5, 0.2, 3e-3, 0.05, 16
MEAN, STD = P.CIFAR100_MEAN, P.CIFAR100_STD


def _lockstep(runs, lockstep_train, x, y, *mesh):
    """Per-step losses of every run and the val history, over STEPS lockstep
    steps on BatchIterator(x, y) with an eval each step."""
    losses = {k: [] for k in runs}
    for k, run in runs.items():
        def step(xb, yb, i, _k=k, _step=run.step):
            m = _step(xb, yb, i)
            losses[_k].append(float(m["loss"]))
            return m

        run.step = step
    val = lambda: eval_batches(x[:40], y[:40], BATCH)  # noqa: E731
    hist = lockstep_train(runs, BatchIterator(x, y, BATCH, seed=0), val, STEPS, 1, *mesh,
                          log=lambda *_: None)
    return losses, hist


def _both(monkeypatch, fp32):
    x, y, _, _ = synthetic_cifar("cifar100", 128, 8, seed=4)
    if fp32:
        monkeypatch.setattr(JC, "make_classifier_train_step",
                            functools.partial(jax_train_step, compute_dtype=jnp.float32))
        monkeypatch.setattr(TC, "make_classifier_train_step",
                            functools.partial(torch_train_step, compute_dtype=None))
    monkeypatch.setattr(JC, "_STEP_CACHE", {})
    mesh = make_mesh()
    jruns, truns = {}, {}
    for key, (cls, kw) in MODELS.items():
        jruns[key] = JC.ModelRun(key, getattr(J, cls)(**SMALL, **kw), LR, mesh, MEAN, STD,
                                 STEPS, WARMUP, WD, seed=0, augment=False)
        model = load_jax_params(getattr(P, cls)(**SMALL, **kw, device="cpu"),
                                jax.device_get(jruns[key].params))
        truns[key] = TC.ModelRun(key, model, LR, MEAN, STD, STEPS, WARMUP, WD, seed=0,
                                 augment=False, device="cpu")
        assert truns[key].n_params == jruns[key].n_params
    return _lockstep(jruns, JC.lockstep_train, x, y, mesh), _lockstep(
        truns, TC.lockstep_train, x, y)


def test_lockstep_fp32_matches_jax(monkeypatch):
    (jl, jh), (tl, th) = _both(monkeypatch, fp32=True)
    for k in MODELS:
        assert len(tl[k]) == STEPS
        np.testing.assert_allclose(tl[k], jl[k], rtol=2e-4, err_msg=k)
        assert th[k]["steps"] == jh[k]["steps"] == list(range(1, STEPS + 1))
        assert th[k]["acc"] == jh[k]["acc"], k
        np.testing.assert_allclose(th[k]["loss"], tl[k], rtol=1e-7)  # synced per eval
