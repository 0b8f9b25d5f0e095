"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``.cu`` file under ``mop_tpu_torch/csrc/`` is compiled on first use into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). The libraries go to ``mop_tpu_torch/_build/<hash>/``,
keyed by a hash of every source and the compiler flags, so an edited source
is rebuilt and an unchanged one is reused. ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.

A failed build raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# -Xptxas=-v: the register, shared-memory and spill report lands in lib<name>.log.
FLAGS = ["-O3", "-std=c++17", ARCH, "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Kernel name -> source file in csrc/.
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "edgewise_lowrank_fwd": "edgewise_lowrank_fwd.cu",
    "edgewise_dense_fwd": "edgewise_dense_fwd.cu",
    "edgewise_bwd": "edgewise_bwd.cu",
    "edgewise_wide": "edgewise_wide.cu",
    "multihop_fwd": "multihop_fwd.cu",
    "quartet_fwd": "quartet_fwd.cu",
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _start(name: str, out: Path, nvcc: str):
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def build_all(names=None) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all at once.

    Returns kernel name -> shared-library path. Raises with the compiler's
    output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n in names if not outs[n].exists()]
    if todo:
        nvcc = nvcc_path()
        started = {n: _start(n, outs[n], nvcc) for n in todo}
        errors = []
        for n, (proc, tmp, cmd) in started.items():
            log, _ = proc.communicate()
            outs[n].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, outs[n])  # atomic: a reader never sees half a library
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib
