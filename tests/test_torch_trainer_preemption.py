"""The port's ``train_model`` killed for real: a child process
(``tests/_torch_trainer_child.py``) trains with checkpoints, is sent SIGTERM
mid-run, checkpoints at the step boundary and exits 75; the same command
resumes from the saved step, repeats no step, and ends with parameters
equal, bit for bit, to an uninterrupted run's (the batches a function of the
step, the per-step generators reseeded from (seed, step), the schedule's
count and AdamW's state restored). The counterpart of
``tests/test_preemption.py``'s real-process tests."""

import os
import signal
import subprocess
import sys

import pytest
import torch

from mop_tpu_torch.training import PREEMPTED_EXIT_CODE, AsyncCheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_trainer_child.py")
TOTAL_STEPS = 8


def _run_child(ckpt_dir, out_path, sleep=0.0, sigterm_at_batch=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, CHILD, str(ckpt_dir), str(TOTAL_STEPS), str(out_path)]
    if sleep:
        cmd.append(str(sleep))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=REPO)
    lines = []
    if sigterm_at_batch is not None:
        for line in proc.stdout:
            lines.append(line.strip())
            if line.strip() == f"BATCH {sigterm_at_batch}":
                proc.send_signal(signal.SIGTERM)
                break
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    lines += out.strip().splitlines()
    return proc.returncode, lines, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_preempt")
    ckpt = tmp / "ckpt"
    killed = _run_child(ckpt, tmp / "resumed.pt", sleep=0.25, sigterm_at_batch=2)
    with AsyncCheckpointManager(str(ckpt)) as mgr:
        saved = mgr.latest_step()
    resumed = _run_child(ckpt, tmp / "resumed.pt")
    solo = _run_child(tmp / "solo_ckpt", tmp / "solo.pt")
    return tmp, saved, killed, resumed, solo


def test_sigterm_checkpoints_and_exits_75(runs):
    _, saved, (rc, lines, err), _, _ = runs
    assert rc == PREEMPTED_EXIT_CODE, f"lines={lines}\nstderr={err[-2000:]}"
    assert "DONE" not in lines
    assert saved == 3  # the signal came during step 2: saved after it


def test_resume_repeats_no_step_and_equals_uninterrupted(runs):
    tmp, saved, (_, lines1, _), (rc2, lines2, err2), (rc3, _, err3) = runs
    assert rc2 == 0, err2[-2000:]
    assert rc3 == 0, err3[-2000:]
    assert lines2[0] == f"START {saved}"
    steps1 = [ln for ln in lines1 if ln.startswith("BATCH")]
    steps2 = [ln for ln in lines2 if ln.startswith("BATCH")]
    assert steps1 + steps2 == [f"BATCH {i}" for i in range(TOTAL_STEPS)]
    resumed = torch.load(tmp / "resumed.pt", weights_only=True)
    solo = torch.load(tmp / "solo.pt", weights_only=True)
    assert sorted(resumed) == sorted(solo)
    for k, v in solo.items():
        assert torch.equal(resumed[k], v), k
