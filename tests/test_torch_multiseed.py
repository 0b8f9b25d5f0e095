"""Multi-seed training on the port, over gloo on the CPU (one 2-process group
for the file): 2 seeds spread one a process (no gradient collective) and 3
seeds held by both processes with each seed's batch split 2 ways, each seed
against an independent one-seed run of ``make_scanned_classifier_train_step``
from the same init, generator and batches (``tests/test_multiseed.py``'s
tolerances); the seeds' trajectories differ; the layouts are JAX's
``seed_shardings``. The one-seed scanned step against JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.parallel import make_mesh as jax_make_mesh
from mop_tpu.parallel import make_scanned_classifier_train_step as jax_scanned_step
from mop_tpu.parallel import seed_shardings as jax_seed_shardings
from mop_tpu_torch.ops.preprocess import CIFAR100_MEAN as MEAN, CIFAR100_STD as STD
from mop_tpu_torch.parallel import multiseed
from mop_tpu_torch.parallel.mesh import Mesh
from mop_tpu_torch.utils.jax_weights import load_jax_params
from tests._torch_parallel_common import assert_params_close, jax_init, run_ranks

K, B = 3, 16
VIT_KW = dict(dim=32, depth=2, heads=2, n_classes=10, n_views=2, n_kernels=1, drop_path=0.1)
SEEDS_SPREAD, SEEDS_HELD = [0, 1], [5, 6, 7]
NPROC = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(s, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (K, s, B, 3, 32, 32), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 10, (K, s, B)).astype(np.int64)))


@pytest.fixture(scope="module")
def inputs():
    (x2, y2), (x3, y3) = _batches(2, 0), _batches(3, 1)
    return dict(vit_kw=VIT_KW, seed_lists=(SEEDS_SPREAD, SEEDS_HELD), xk2=x2, yk2=y2, xk3=x3,
                yk3=y3)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks("multiseed", inputs, tmp_path_factory.mktemp("multiseed"), nproc=NPROC)


@functools.lru_cache(maxsize=None)
def _single_seed_run(seed, s, i):
    """Seed ``seed``'s independent run on column ``i`` of the S = ``s``
    super-batch."""
    xk, yk = _batches(s, 0 if s == 2 else 1)
    model = P.ViT_MoP(**VIT_KW, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_scanned_classifier_train_step(model, opt, MEAN, STD, K,
                                                compute_dtype=None, device="cpu")
    m = step(xk[:, i], yk[:, i], torch.Generator().manual_seed(100 + seed))
    return m["loss"].numpy(), model.state_dict()


@pytest.mark.parametrize("s", [2, 3], ids=["seed_sharded", "replicated_seeds"])
def test_multiseed_matches_independent_runs(ranks, s):
    seeds = SEEDS_SPREAD if s == 2 else SEEDS_HELD
    for r in ranks:
        loss, params, _, _, _ = r[("ms", s)]
        for i, seed in enumerate(seeds):
            want_l, want_p = _single_seed_run(seed, s, i)
            np.testing.assert_allclose(loss[:, i].numpy(), want_l, rtol=2e-5, atol=2e-6)
            assert_params_close(params[i], want_p, 2e-4, 2e-5)


def test_seeds_differ(ranks):
    loss = ranks[0][("ms", 3)][0].numpy()
    for i in range(1, 3):
        assert not np.allclose(loss[:, 0], loss[:, i])


def test_layout_and_collectives(ranks):
    """2 seeds on 2 processes: one seed each and no gradient collective (one
    all-reduce of the (K, S) losses and accuracies); 3 seeds: all on both
    processes, each seed's grads all-reduced."""
    for rank, r in enumerate(ranks):
        _, _, held, summ, specs = r[("ms", 2)]
        assert held == [rank] and specs == (("data",), (None, "data"), ("data",))
        assert summ == {"all-reduce": {"count": 1, "bytes": 2 * K * 2 * 4}}, summ
        _, _, held, summ, specs = r[("ms", 3)]
        assert held == [0, 1, 2] and specs == ((), (None, None, "data"), ())
        assert summ["all-reduce"]["count"] == 2 * K * 3, summ  # grads + metrics, per step


@pytest.mark.parametrize("n_seeds", [8, 3, 2])
def test_seed_shardings_equal_jax(n_seeds):
    for n in (1, 2, 4, 8):
        got = multiseed.seed_shardings(Mesh(torch.device("cpu"), ("data", "model"), (n, 1)),
                                       n_seeds)
        want = jax_seed_shardings(jax_make_mesh(n_devices=n), n_seeds)
        assert tuple(g.spec for g in got) == tuple(tuple(w.spec) for w in want)


def test_one_seed_scanned_step_equals_jax():
    """The step each seed runs, against JAX's scanned step from the same init
    (the augment off: the two draw from different generators)."""
    kw = dict(VIT_KW, drop_path=0.0)
    jm = J.ViT_MoP(**kw)
    params = jax_init(jm, 0, jnp.zeros((1, 3, 32, 32)))
    xk, yk = _batches(1, 2)
    xk, yk = xk[:, 0], yk[:, 0]
    tx = optax.adamw(1e-3, weight_decay=0.01)
    mesh = jax_make_mesh(n_devices=1)
    with mesh:
        step = jax_scanned_step(jm, tx, mesh, MEAN, STD, unroll_steps=K,
                                augment=False, compute_dtype=None)
        p, _, m = step(params, tx.init(params), jnp.asarray(xk.numpy()),
                       jnp.asarray(yk.numpy().astype(np.int32)), jax.random.PRNGKey(0))
    model = load_jax_params(P.ViT_MoP(**kw, device="cpu"), params)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    got = P.make_scanned_classifier_train_step(model, opt, MEAN, STD, K,
                                               augment=False, compute_dtype=None,
                                               device="cpu")(xk, yk)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(m["loss"]), rtol=2e-5, atol=2e-6)
    want = load_jax_params(P.ViT_MoP(**kw, device="cpu"), jax.device_get(p)).state_dict()
    assert_params_close(model.state_dict(), want, 2e-4, 2e-5)
