"""Child process for tests/test_torch_trainer_preemption.py: the port's
``train_model`` on the CPU with checkpoints, so that the parent can kill it.

argv: ckpt_dir total_steps out_path [sleep_per_step_seconds]
Resumes from ``ckpt_dir`` when it holds a checkpoint. Prints "START k"
(the step it starts from) and "BATCH s" as it hands out the batch of step
s, which is a function of s alone; on completion it writes the model's
state dict to ``out_path`` and prints "DONE". A SIGTERM mid-run checkpoints
at the next step boundary and exits with PREEMPTED_EXIT_CODE (75).
"""

import sys
import time

import numpy as np
import torch

from mop_tpu_torch import CIFAR10_MEAN, CIFAR10_STD, ViT_Baseline
from mop_tpu_torch.training import AsyncCheckpointManager, train_model

torch.set_num_threads(1)


def batches(start, sleep):
    for s in range(start, 1 << 30):
        rs = np.random.RandomState(s)
        print(f"BATCH {s}", flush=True)
        if sleep:
            time.sleep(sleep)
        yield (rs.randint(0, 256, (4, 3, 32, 32)).astype(np.uint8),
               rs.randint(0, 4, (4,)).astype(np.int64))


def main():
    ckpt_dir, total_steps, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    sleep = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
    with AsyncCheckpointManager(ckpt_dir) as mgr:
        start = mgr.latest_step() or 0
    print(f"START {start}", flush=True)
    # drop-path and the augment draw from the per-step generators
    model = ViT_Baseline(dim=32, depth=1, heads=2, n_classes=4, drop_path=0.1, device="cpu")
    model, _ = train_model(model, batches(start, sleep), lambda: [], total_steps, seed=0,
                           device="cpu", mean=CIFAR10_MEAN, std=CIFAR10_STD, verbose=False,
                           ckpt_dir=ckpt_dir, ckpt_every=100, resume=True)
    torch.save(model.state_dict(), out_path)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
