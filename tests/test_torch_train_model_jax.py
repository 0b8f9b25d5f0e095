"""The port's ``train_model`` against the JAX package's on the same run: the
same initial params (JAX's init from ``seed``, loaded into the port in place
of its own draw), the same batches, augment off, drop-path 0, each
package's bf16 compute default, AdamW with ``cosine_lr`` and an eval every 2
steps: each step's loss within bf16's tolerance (rtol 1e-3, as
``test_torch_experiments_lockstep_bf16.py``, where both packages round their
own products' operands to bf16) and the val accuracies equal. A file of its
own, so that JAX's train-step compile stays on one worker."""

import jax
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
import mop_tpu_torch.training.trainer as TT
from mop_tpu.parallel import make_mesh
from mop_tpu.training import Trainer as JaxTrainer
from mop_tpu.training import train_model as jax_train_model
from mop_tpu_torch.training import train_model
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
STEPS, B, SEED = 6, 16, 3


def test_train_model_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, (STEPS, B, 3, 32, 32), dtype=np.uint8)
    ys = rng.integers(0, 10, (STEPS, B)).astype(np.int32)
    val = [(rng.integers(0, 256, (B, 3, 32, 32), dtype=np.uint8),
            rng.integers(0, 10, (B,)).astype(np.int32), np.ones(B, np.float32))]
    kw = dict(batch_size=B, lr=3e-3, weight_decay=0.05, warmup_frac=0.3, eval_every=2,
              seed=SEED, mean=MEAN, std=STD, augment=False, verbose=False)
    mesh = make_mesh(n_devices=1)
    jm = J.ViT_Baseline(**SMALL)
    _, want = jax_train_model(jm, iter(zip(xs, ys)), lambda: val, STEPS, mesh=mesh, **kw)
    # JAX's train_model draws its params from PRNGKey(seed); the port's draw
    # is replaced by those same params.
    init = jax.device_get(JaxTrainer(jm, mesh=mesh).init(jax.random.PRNGKey(SEED)))
    monkeypatch.setattr(TT, "init_params", lambda model, generator: load_jax_params(model,
                                                                                    init))
    _, got = train_model(P.ViT_Baseline(**SMALL, device="cpu"), iter(zip(xs, ys)),
                         lambda: val, STEPS, device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["time_min", "train_loss", "val_acc"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-3)
    assert got["val_acc"] == pytest.approx(want["val_acc"])
    assert len(got["val_acc"]) == STEPS // 2
