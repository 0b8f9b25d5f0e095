"""The port's two-hop budget, multi-seed, sweep and tournament CLIs run end
to end on the CPU (``--device cpu --synthetic --tiny``, one seed, 2 steps at
batch 16 over a 320 / 48 image synthetic set): each writes the files of the
JAX script, with its names and CSV headers (``summary.json`` too), one row
per seed."""

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


FILES = {
    "cifar10_twohop_param_budgets": ["cifar10_twohop_target_200000.csv"],
    "cifar100_twohop_param_budgets": ["cifar100_twohop_target_200000.csv"],
    "cifar10_multi_seed": ["cifar10_acc.csv", "summary.json"],
    "cifar100_multi_seed": ["cifar100_acc.csv", "summary.json"],
    "cifar10_mop_sweep": ["cifar10_mop_sweep.csv"],
    "ab5_tournament": [f"tournament_target_200000{s}" for s in
                       (".csv", "_summary.json", "_test.csv", "_val_summary.csv")],
}


@pytest.mark.parametrize("name", FILES)
def test_cpu_run_writes_the_jax_files(monkeypatch, tmp_path, small_data, name):  # noqa: F811
    assert list(check_cpu_run(monkeypatch, tmp_path, name)) == FILES[name]
