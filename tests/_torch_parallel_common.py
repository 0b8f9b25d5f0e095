"""Helpers of the port's multi-process tests: start the ranks of a scenario
of ``tests/_torch_parallel_worker.py`` under ``cli/launch_multihost.py``
(gloo on the CPU, one process group per test file) and read back what each
rank saw."""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Run as a script: the launcher needs nothing of the package (whose import
# loads torch) in its own process.
LAUNCHER = os.path.join(REPO, "mop_tpu_torch", "cli", "launch_multihost.py")
# The time each launch may take, and the join beyond it.
RANKS_TIMEOUT_S = 300


def run_ranks(scenario: str, inputs: dict, tmp, nproc: int = 4):
    """Every rank's result dict of ``scenario`` on ``inputs``."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    cmd = [sys.executable, LAUNCHER, "--nproc", str(nproc),
           "--threads", "1", "--timeout", str(RANKS_TIMEOUT_S), "--", sys.executable,
           os.path.join(REPO, "tests", "_torch_parallel_worker.py"), scenario, str(tmp)]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=RANKS_TIMEOUT_S + 60,
                         env=env, cwd=REPO)
    assert out.returncode == 0, (f"{scenario} ranks failed\nstdout:\n{out.stdout[-6000:]}\n"
                                 f"stderr:\n{out.stderr[-3000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


def jax_init(model, seed: int, example):
    """A flax model's params from ``PRNGKey(seed)``, initialised under jit (the
    eager init of a ViT takes seconds op by op), on the host."""
    import jax

    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed), example))


def assert_params_close(got: dict, want: dict, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].float()), np.asarray(want[k].float()),
                                   rtol=rtol, atol=atol, err_msg=k)
