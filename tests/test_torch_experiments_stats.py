"""The harness's schedule and statistics against the JAX harness's: the LR that
``torch.optim.AdamW`` sees before each update of a ``ModelRun`` equals optax's
joined warmup + cosine schedule at that update's count, and ``mcnemar`` /
``bootstrap_delta`` equal JAX's on random correctness vectors."""

import numpy as np
import pytest
import torch

import experiments.common as JC
import mop_tpu_torch as P
from mop_tpu_torch.experiments import common as TC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("steps,warmup_frac", [(20, 0.1), (7, 0.0), (100, 0.25)])
def test_adamw_lr_follows_the_optax_schedule(steps, warmup_frac):
    lr = 3e-3
    want = JC.make_lr_schedule(lr, steps, warmup_frac)
    model = P.ViT_Baseline(dim=16, depth=1, heads=2, n_classes=10, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    run = TC.ModelRun("A", model, lr, P.CIFAR10_MEAN, P.CIFAR10_STD, steps, warmup_frac,
                      0.05, seed=0, device="cpu")
    seen = []
    train_step = run.train_step

    def recording(*a):
        seen.append(run.opt.param_groups[0]["lr"])
        return train_step(*a)

    run.train_step = recording
    x = np.random.RandomState(0).randint(0, 256, (2, 3, 32, 32)).astype(np.uint8)
    y = np.zeros(2, np.int32)
    for i in range(1, steps + 1):
        run.step(x, y, i)
    assert run.count == steps
    np.testing.assert_allclose(seen, [float(want(i)) for i in range(steps)], rtol=1e-6)
    # Past the end the cosine stays at its floor, as optax's.
    np.testing.assert_allclose([run.schedule(i) for i in range(steps, steps + 3)],
                               [float(want(i)) for i in range(steps, steps + 3)], rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 1), (1000, 2)])
def test_mcnemar_and_bootstrap_equal_jax(n, seed):
    rng = np.random.RandomState(seed)
    a, b = rng.rand(n) < 0.6, rng.rand(n) < 0.55
    assert TC.mcnemar(a, b) == JC.mcnemar(a, b)
    assert TC.bootstrap_delta(a, b, n_boot=200, seed=seed) == JC.bootstrap_delta(
        a, b, n_boot=200, seed=seed)


def test_mcnemar_without_discordant_pairs():
    a = np.array([True, False, True])
    assert TC.mcnemar(a, a) == JC.mcnemar(a, a) == {
        "mcnemar_n01": 0, "mcnemar_n10": 0, "mcnemar_chi2": 0.0}
