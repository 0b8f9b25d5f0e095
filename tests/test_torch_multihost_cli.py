"""An experiment CLI run data-parallel: ``cifar100_multihop_gates`` under
``cli/launch_multihost.py`` with two gloo processes on the CPU writes the
same results as one process alone (fp32 eval of bf16-trained models: the
accuracy agrees), and only the main process writes its files."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Run as a script: the launcher needs nothing of the package (whose import
# loads torch) in its own process.
LAUNCHER = os.path.join(REPO, "mop_tpu_torch", "cli", "launch_multihost.py")
ARGS = ["-m", "mop_tpu_torch.experiments.cifar100_multihop_gates", "--device", "cpu",
        "--synthetic", "--tiny", "--steps", "2", "--batch", "16", "--dim", "32", "--depth", "1",
        "--seeds", "0"]


def _run(cmd, out_dir):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run(cmd + ["--out", str(out_dir)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, f"stdout:\n{out.stdout[-4000:]}\nstderr:\n{out.stderr[-4000:]}"
    return out.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one, two = tmp_path_factory.mktemp("one"), tmp_path_factory.mktemp("two")
    _run([sys.executable] + ARGS, one)
    log = _run([sys.executable, LAUNCHER, "--nproc", "2",
                "--threads", "1", "--timeout", "240", "--", sys.executable] + ARGS, two)
    return one, two, log


def test_two_processes_write_one_process_results(runs):
    one, two, log = runs
    name = "cifar100_multihop_gates.csv"
    assert sorted(os.listdir(one)) == sorted(os.listdir(two)) == [name]
    assert (one / name).read_text() == (two / name).read_text()
    assert "[proc 0] Device: cpu x2" in log and "[proc 1] Device: cpu x2" in log
