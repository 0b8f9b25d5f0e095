#!/usr/bin/env python
"""Local multi-process launcher: N copies of a worker command on this
machine, one process per device, wired as torchrun wires them.

Each child gets ``RANK`` 0..N-1, ``LOCAL_RANK`` (the same: one node),
``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` N, and ``MASTER_ADDR`` /
``MASTER_PORT`` at a free port of 127.0.0.1: the variables
``mop_tpu_torch.parallel.multihost.init_distributed`` reads. A child on a GPU
then drives ``cuda:LOCAL_RANK`` over NCCL; one run with ``--device cpu``
flags its CPU ranks over gloo. Each child's output is forwarded line by
line, prefixed ``[proc N]``; the exit status is non-zero if any child fails
or outlives ``--timeout`` (every child is then stopped).

    python -m mop_tpu_torch.cli.launch_multihost --nproc 2 -- \\
        python -m mop_tpu_torch.cli.multihost_train --steps 3 --device cpu

``torchrun --nproc_per_node N`` starts the same workers. The JAX package's
launcher (``tools/launch_multihost.py``) emulates many devices per process;
this one does not: one process drives one device.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(nproc: int, cmd: list, timeout: float = 600.0, threads: int = 0) -> int:
    """Run ``nproc`` copies of ``cmd``; returns the largest child exit code
    (1 if one timed out). ``threads`` > 0 sets each child's
    ``OMP_NUM_THREADS`` (CPU ranks sharing the cores)."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nproc),
                   LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if threads:
            env["OMP_NUM_THREADS"] = str(threads)
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))

    def pump(rank, p):
        for line in p.stdout:
            sys.stdout.write(f"[proc {rank}] {line}")
            sys.stdout.flush()

    pumps = [threading.Thread(target=pump, args=(i, p), daemon=True)
             for i, p in enumerate(procs)]
    for t in pumps:
        t.start()
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    except subprocess.TimeoutExpired:
        sys.stdout.write(f"launch_multihost: a child outlived --timeout {timeout} s\n")
        codes.append(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in pumps:
        t.join(timeout=5)
    return max(codes) if codes else 1


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--threads", type=int, default=0,
                    help="OMP_NUM_THREADS of each child (0: inherit)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="worker command after '--'")
    return ap


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no worker command given (append: -- python worker.py ...)")
    return launch(args.nproc, cmd, timeout=args.timeout, threads=args.threads)


if __name__ == "__main__":
    raise SystemExit(main())
