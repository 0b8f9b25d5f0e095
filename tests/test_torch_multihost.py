"""The port's multi-process launch, over gloo on the CPU: two processes of
``cli/multihost_train.py`` under ``cli/launch_multihost.py`` report the same
replicated state on both, equal to one process alone (the counterpart of
``tests/test_multihost.py``: rtol 2e-4 / atol 2e-5 on the loss, 2e-5 on the
parameters' norm). The launcher's failure and timeout paths."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mop_tpu_torch.cli import launch_multihost, multihost_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Run as a script: the launcher needs nothing of the package (whose import
# loads torch) in its own process.
LAUNCHER = os.path.join(REPO, "mop_tpu_torch", "cli", "launch_multihost.py")
STEPS, GLOBAL_BATCH = 3, 16


@pytest.fixture(scope="module")
def two_process_records():
    cmd = [sys.executable, LAUNCHER, "--nproc", "2",
           "--threads", "1", "--timeout", "240", "--", sys.executable, "-m",
           "mop_tpu_torch.cli.multihost_train", "--steps", str(STEPS), "--global-batch",
           str(GLOBAL_BATCH), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, f"stdout:\n{out.stdout[-4000:]}\nstderr:\n{out.stderr[-4000:]}"
    records = [json.loads(line[line.find("{"):]) for line in out.stdout.splitlines()
               if line.startswith("[proc ") and '"param_l2"' in line]
    assert len(records) == 2, out.stdout
    return records


def test_two_processes_replicate_identically(two_process_records):
    a, b = sorted(two_process_records, key=lambda r: r["process"])
    assert (a["process"], b["process"]) == (0, 1)
    assert a["n_processes"] == b["n_processes"] == 2
    assert (a["loss"], a["acc"], a["param_l2"]) == (b["loss"], b["acc"], b["param_l2"])


def test_matches_one_process(two_process_records):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = multihost_train.run_worker(steps=STEPS, global_batch_size=GLOBAL_BATCH,
                                         device="cpu")
    finally:
        torch.set_num_threads(n)
    assert ref["n_processes"] == 1
    got = two_process_records[0]
    assert got["loss"] == pytest.approx(ref["loss"], rel=2e-4, abs=2e-5)
    assert got["param_l2"] == pytest.approx(ref["param_l2"], rel=2e-5)


def test_launcher_reports_a_failed_child():
    cmd = [sys.executable, "-c", "import os, sys; sys.exit(3 if os.environ['RANK'] == '1' else 0)"]
    assert launch_multihost.launch(2, cmd, timeout=60) == 3


def test_launcher_stops_children_past_the_timeout(capsys):
    cmd = [sys.executable, "-c", "import time; time.sleep(60)"]
    assert launch_multihost.launch(2, cmd, timeout=2) == 1
    assert "outlived --timeout" in capsys.readouterr().out
