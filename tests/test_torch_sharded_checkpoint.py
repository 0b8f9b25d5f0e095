"""Sharded checkpoints on the port (``torch.distributed.checkpoint``), over
gloo on the CPU (one 4-process group for the file), the counterpart of
``tests/test_sharded_checkpoint.py`` at its model (``ViT_MoP`` 64 / 2 / 4,
3 views, 2 kernels, JAX's init) and min_size 256: saved mid-training from
FSDP with the optimizer, restored into FSDP (``restore_checkpoint_sharded``,
``AsyncCheckpointManager.restore(shardings=)`` and ``resume_latest(
shardings=)``), two more steps are bit-equal to the uninterrupted run;
saved under FSDP, restored whole and into dp 2 x tp 2 (the packed qkv split
by head), and saved whole, restored into FSDP, every value is bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu_torch.utils.jax_weights import load_jax_params
from tests._torch_parallel_common import jax_init, run_ranks

VIT_KW = dict(dim=64, depth=2, heads=4, n_classes=10, n_views=3, n_kernels=2, drop_path=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init():
    params = jax_init(J.ViT_MoP(**VIT_KW), 0, jnp.zeros((16, 3, 32, 32)))
    return load_jax_params(P.ViT_MoP(**VIT_KW, device="cpu"), params).state_dict()


@pytest.fixture(scope="module")
def ranks(init, tmp_path_factory):
    x = np.random.RandomState(0).randint(0, 256, (16, 3, 32, 32), dtype=np.uint8)
    y = np.random.RandomState(1).randint(0, 10, (16,)).astype(np.int64)
    inputs = dict(vit_kw=VIT_KW, vit_sd=init, min_size=256, x=torch.from_numpy(x),
                  y=torch.from_numpy(y))
    return run_ranks("sharded_ckpt", inputs, tmp_path_factory.mktemp("sharded_ckpt"))


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("how", ["restore_checkpoint_sharded", "manager", "resume_latest"])
def test_save_fsdp_restore_fsdp_and_resume(ranks, how):
    for r in ranks:
        want_l, want_p = r["uninterrupted"]
        at, qkv_shape, got_l, got_p = r[("resumed", how)]
        assert at == 2
        assert qkv_shape == (48, 64), "restore did not land in the FSDP layout"
        assert got_l == want_l
        _equal(got_p, want_p)


def test_save_zero1_restore_and_resume(ranks):
    """ZeRO-1: each process writes its slice of every moment; restored, two
    more steps are bit-equal to the uninterrupted run."""
    for r in ranks:
        want_l, want_p = r["zero1_uninterrupted"]
        got_l, got_p = r["zero1_resumed"]
        assert got_l == want_l
        _equal(got_p, want_p)


def test_save_fsdp_restore_other_layouts(init, ranks):
    for r in ranks:
        step, rep = r["replicated"]
        assert step == 0
        _equal(rep, init)
        qkv_shape, tp_full = r["tp"]
        assert qkv_shape == (96, 64), "restore did not land in the TP layout"
        _equal(tp_full, init)


def test_whole_checkpoint_restores_into_fsdp(init, ranks):
    """A ``torch.save`` checkpoint of the whole model restores into FSDP's
    layout, each process keeping its slice."""
    for r in ranks:
        _equal(r["whole_into_fsdp"], init)


def test_manager_keeps_its_steps(ranks):
    assert ranks[0]["manager_steps"] == [2]
