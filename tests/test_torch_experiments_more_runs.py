"""The port's A/B, A/B/C and A/B/C/D budget CLIs run end to end on the CPU
(``--device cpu --synthetic --tiny``, one seed, 2 steps at batch 16, a
200,000-parameter target, over a 320 / 48 image synthetic set): each writes
the files of the JAX script, with its names and CSV headers, one row per
seed. The other CLIs' runs are in ``test_torch_experiments_more_runs_b.py``."""

import pytest
import torch

from _torch_more_clis_common import check_cpu_run, small_data  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["cifar10_ab_param_budgets", "cifar10_ab3_param_budgets",
                                  "cifar100_ab3_param_budgets", "cifar100_ab4_param_budgets"])
def test_cpu_run_writes_the_jax_files(monkeypatch, tmp_path, small_data, name):  # noqa: F811
    files = check_cpu_run(monkeypatch, tmp_path, name)
    prefix = name.replace("_param_budgets", "")
    assert list(files) == [f"{prefix}_target_200000.csv"]
