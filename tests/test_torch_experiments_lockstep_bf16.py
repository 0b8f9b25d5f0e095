"""Lockstep training of the port's harness against the JAX harness's at the
harness's bf16 compute default (``mop_tpu/parallel/train_step.py``'s
``compute_dtype``): the set-up of ``test_torch_experiments_lockstep.py``
(tiny A and E lowrank, JAX params carried over, augment off, 5 steps of
warmup + cosine AdamW), per-step losses within a bf16 tolerance."""

import numpy as np
import pytest
import torch

from test_torch_experiments_lockstep import MODELS, _both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# bf16 compute on both sides: each package rounds its own products' operands
# to bf16 (XLA's dot against torch's CPU matmul, the E op's plain version
# against the JAX kernel in interpret mode), so per-step losses agree to
# about bf16's precision averaged over the batch's mean, not to fp32's:
# measured 1.3e-4 (A) and 2.8e-5 (E) relative at most over the 5 steps.
BF16_RTOL = 1e-3


def test_lockstep_bf16_matches_jax(monkeypatch):
    (jl, _), (tl, _) = _both(monkeypatch, fp32=False)
    for k in MODELS:
        np.testing.assert_allclose(tl[k], jl[k], rtol=BF16_RTOL, err_msg=k)
