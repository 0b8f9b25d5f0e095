"""Child process for tests/test_torch_experiments_preemption.py: the port's
ab5 CLI on the CPU over a 320 / 48 image synthetic set, pausing after each
lockstep step so that the parent can send SIGTERM mid-run.

argv: the CLI's flags. A SIGTERM checkpoints every model at the next step
boundary and exits with PREEMPTED_EXIT_CODE (75).
"""

import sys
import time

import torch

from mop_tpu_torch.data import synthetic_cifar
from mop_tpu_torch.experiments import cifar100_ab5_param_budgets as ab5
from mop_tpu_torch.experiments import common as C

torch.set_num_threads(1)
C.load_cifar = lambda name, **kw: synthetic_cifar(name, 320, 48, seed=0)
_step = C.ModelRun.step


def _slow_step(self, *args):
    m = _step(self, *args)
    time.sleep(0.05)
    return m


C.ModelRun.step = _slow_step

if __name__ == "__main__":
    ab5.main(sys.argv[1:])
