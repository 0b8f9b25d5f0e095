"""Preemption of the port's lockstep harness in a real OS process: a child
running the ab5 CLI with checkpoints on is sent SIGTERM mid-run; it
checkpoints every model at the next step boundary and exits with
PREEMPTED_EXIT_CODE (75), and the same command with ``--resume`` continues
from that step to the end (the JAX harness's contract,
``experiments/common.py``'s ``lockstep_train``). Also the guard itself:
the flag set by a signal, the chained handler, the restore."""

import os
import signal
import subprocess
import sys
import time

from mop_tpu_torch.training import PREEMPTED_EXIT_CODE, PreemptionGuard, load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_experiments_child.py")
SIG = signal.SIGUSR1  # in-process tests use a harmless signal


def test_guard_flag_set_by_signal_chains_and_restores():
    hits = []
    orig = signal.getsignal(SIG)
    signal.signal(SIG, lambda s, f: hits.append(s))
    try:
        prev = signal.getsignal(SIG)
        with PreemptionGuard(signals=(SIG,)) as guard:
            assert not guard.preempted
            os.kill(os.getpid(), SIG)
            deadline = time.time() + 5
            while not (guard.preempted and hits):
                assert time.time() < deadline
                time.sleep(0.01)
        assert hits == [SIG] and signal.getsignal(SIG) == prev
        guard = PreemptionGuard(signals=(SIG,))
        guard.signal_now()
        assert guard.preempted
    finally:
        signal.signal(SIG, orig)
    assert PREEMPTED_EXIT_CODE == 75


def _flags(out, steps):
    return ["--device", "cpu", "--synthetic", "--tiny", "--seeds", "0", "--batch", "16",
            "--targets", "200000", "--models", "A", "B", "--eval_every", "1000",
            "--steps", str(steps), "--out", str(out)]


def test_sigterm_checkpoints_exits_75_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    child = subprocess.Popen([sys.executable, "-u", CHILD, *_flags(tmp_path, 200)], cwd=REPO,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    lines = []
    try:
        for line in child.stdout:  # step 1's eval line: training is under way
            lines.append(line)
            if line.startswith("step    1 |"):
                child.send_signal(signal.SIGTERM)
                break
        lines += child.stdout.readlines()
        rc = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
    out = "".join(lines)
    assert rc == PREEMPTED_EXIT_CODE, out
    preempted = [ln for ln in lines if ln.startswith("preempted at step ")]
    assert preempted, out
    step = int(preempted[0].split()[3].rstrip(":"))
    assert 1 <= step < 200
    ckpt = tmp_path / "ckpt_t200000_s0"
    for k in ("A", "B"):
        assert load_checkpoint(str(ckpt / f"{k}.ckpt"))["step"] == step

    steps = step + 2
    r = subprocess.run([sys.executable, "-u", CHILD, *_flags(tmp_path, steps), "--resume"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"resumed from step {step}" in r.stdout
    assert (tmp_path / "cifar100_ab5_target_200000_summary.json").is_file()
