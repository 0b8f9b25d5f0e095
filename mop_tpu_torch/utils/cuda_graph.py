"""One dispatch per step: CUDA graphs of the port's steps and decoders, the
counterpart of the JAX package's ``jax.jit`` and ``lax.scan``.

``StepGraph`` runs a function of device tensors as one ``torch.cuda.CUDAGraph``
over static buffers. The entry points that take ``cuda_graph=True`` build
one after ``require_graph`` accepted their configuration. The rules every
captured step keeps:

- inputs are copied into static buffers and outputs cloned out of the
  graph's, so that no result aliases memory the next replay overwrites;
- a value that changes between calls reaches the graph through a device
  tensor updated in place (the optimizer's lr, a decode length); a Python
  number is baked into the capture;
- the optimizer is capturable (``torch.optim.AdamW(..., capturable=True)``),
  its step count and bias corrections on the device;
- every generator the step draws from is registered with the graph, so that
  a replay draws what the eager step draws from the generator's current
  seed and offset, and advances it as far;
- grads are allocated inside the capture (set to None first), in the
  graph's pool;
- nothing in the captured body reads a device value on the host or makes a
  tensor from host data;
- each kernel wrapper counts its launches in Python, which a replay does
  not run: a capture's launches are taken back from the counts and each
  replay adds them (``ops.fused.add_launches``).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Hashable, Iterable, Optional

import torch

from ..ops.fused import add_launches, launch_counts


def require_graph(what: str, device, mesh=None, optimizer=None, tensor_parallel=None) -> None:
    """Raise a ValueError naming what ``what`` cannot capture: a mesh (no NCCL
    collective is captured), a tensor-parallel model (``tensor_parallel``:
    its ``generate.DecodeSplit``, whose all-reduces are NCCL collectives), an
    optimizer whose groups are not all ``capturable``, a device that is not
    CUDA. Never a fallback to eager."""
    if mesh is not None:
        raise ValueError(f"{what}: cuda_graph=True does not take a mesh (no NCCL collective is "
                         "captured); build it with cuda_graph=False")
    if tensor_parallel is not None:
        raise ValueError(f"{what}: cuda_graph=True does not take a tensor-parallel model (its "
                         "step all-reduces over NCCL, which is not captured)")
    if optimizer is not None and not all(g.get("capturable", False)
                                         for g in optimizer.param_groups):
        raise ValueError(f"{what}: cuda_graph=True needs a capturable optimizer, e.g. "
                         "torch.optim.AdamW(..., capturable=True) with a tensor lr; got "
                         f"{type(optimizer).__name__} with capturable="
                         f"{[g.get('capturable') for g in optimizer.param_groups]}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what}: cuda_graph=True needs a CUDA device, not {device}")


def restore_capturable(optimizer: torch.optim.Optimizer, lr: torch.Tensor) -> None:
    """Put back, after ``optimizer.load_state_dict``, what a captured step
    reads: ``lr``, the tensor lr the caller fills in place (the load puts
    the saved one in its place), ``capturable`` where ``lr`` is on a CUDA
    device, and every parameter's step count as an fp32 tensor on ``lr``'s
    device. A step captured before the load reads the state it replaced:
    build the step again over the loaded state."""
    for group in optimizer.param_groups:
        group.update(lr=lr, capturable=lr.is_cuda)
    for state in optimizer.state.values():
        state["step"] = state["step"].to(lr.device, torch.float32)


def _reserved() -> int:
    return torch.cuda.memory_stats().get("reserved_bytes.all.current", 0)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(v) for v in out)
    return out


class HyperGuard:
    """The optimizer's lr as the capture saw it: a tensor (read by the graph
    through its address) must stay the same object, a number the same
    value, or the graph would train at the captured lr. ``check()`` raises
    otherwise."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.optimizer = optimizer
        self.seen = [g["lr"] for g in optimizer.param_groups]

    def check(self) -> None:
        for was, g in zip(self.seen, self.optimizer.param_groups):
            now = g["lr"]
            if (now is not was) if isinstance(was, torch.Tensor) else (now != was):
                raise ValueError(
                    "the optimizer's lr changed since the step was captured: a CUDA graph reads "
                    "the tensor it captured and bakes a number in; give the optimizer a tensor "
                    "lr and fill_ it in place")


class StepGraph:
    """``fn(*static) -> tensors`` as one CUDA graph replayed per call.

    Each call copies its tensor arguments into static buffers on ``device``
    (made at the first call; later calls must keep their shapes and dtypes),
    then: the first call runs ``fn`` eagerly on a side stream, a real call
    that warms up (builds the kernels, creates the optimizer's state, fills
    the cuBLAS workspace); the second captures ``fn`` in one
    ``torch.cuda.CUDAGraph`` with ``generators`` registered and replays it;
    every later call replays it. The outputs are clones. ``capture_s`` is
    the capture's host time (``torch.cuda.graph``'s synchronize and
    ``empty_cache`` and the graph's instantiation included) and
    ``pool_bytes`` the memory the capture reserved
    (``torch.cuda.memory_stats``' reserved bytes across it): the graph's
    private pool. ``pool`` (set before the capture: a
    ``torch.cuda.graph_pool_handle()``) lets graphs that are never replayed
    at once share one pool, memory one capture frees going to another. It
    holds where every output is cloned at its replay, as here, and no graph
    keeps data in the pool from one replay to the next that another's
    replay could overwrite (grads a step writes before it reads them may).
    On a CPU device, reachable only where a test lifts ``require_graph``,
    every call runs ``fn`` eagerly over the same static buffers: the form
    the graph replays.
    """

    def __init__(self, fn: Callable, device, generators: Iterable[Optional[torch.Generator]] = (),
                 capture_error_mode: str = "global", pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(g for g in generators if g is not None)
        self.capture_error_mode = capture_error_mode
        self.pool = pool
        self.static = None
        self.graph = None
        self.out = None
        self.calls = 0
        self.launches = {}
        self.capture_s = None
        self.pool_bytes = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _fill(self, args) -> None:
        if self.static is None:
            self.static = [torch.empty(a.shape, dtype=a.dtype, device=self.device) for a in args]
        for s, a in zip(self.static, args):
            if a.shape != s.shape or a.dtype != s.dtype:
                raise ValueError(f"a CUDA graph replays one shape: got {tuple(a.shape)} "
                                 f"{a.dtype} where it captured {tuple(s.shape)} {s.dtype}")
            if a is not s:
                s.copy_(a, non_blocking=True)

    def __call__(self, *args):
        self._fill(args)
        self.calls += 1
        if self.device.type != "cuda":
            return _clone(self.fn(*self.static))
        if self.calls == 1:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out = _clone(self.fn(*self.static))
            torch.cuda.current_stream(self.device).wait_stream(side)
            return out
        if self.graph is None:
            self._capture()
        self.graph.replay()
        add_launches(self.launches)
        return _clone(self.out)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.device(self.device):
            before = launch_counts()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode=self.capture_error_mode):
                # after the capture's own synchronize and empty_cache: what
                # is reserved from here on is the graph's pool
                reserved = _reserved()
                self.out = self.fn(*self.static)
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = _reserved() - reserved
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        add_launches({k: -n for k, n in self.launches.items()})  # recorded, not run
        self.graph = graph


class GraphPerShape:
    """``fn(*static)`` as one ``StepGraph`` per input signature (the
    arguments' shapes and dtypes), made at the signature's first call: a
    second shape gets a graph of its own, as ``jax.jit`` keeps one
    executable per input shape. ``graphs`` maps each signature to its
    ``StepGraph``; each is captured into ``pool`` (set before the first
    call; None: a pool of its own)."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = None
        self.graphs = {}

    def __call__(self, *args):
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(self.fn, self.device, pool=self.pool)
        return graph(*args)


class GraphPerKey:
    """``fn(key)`` as one ``StepGraph`` per hashable ``key`` (a burst size, a
    host-known form of a step), made at the key's first call, as ``jax.jit``
    keeps one executable per value of a static argument. The graphs are
    replayed one at a time, each output cloned at its replay, so all are
    captured into one shared pool (``StepGraph``'s rule): ``pool``, or a
    new one when None (an engine passes the pool its other graphs share);
    each registers ``generators``. ``calls`` counts the calls of every
    graph."""

    def __init__(self, fn: Callable, device, generators: Iterable[Optional[torch.Generator]] = (),
                 capture_error_mode: str = "global", pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.capture_error_mode = capture_error_mode
        if pool is None and self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        self.graphs = {}

    @property
    def calls(self) -> int:
        return sum(g.calls for g in self.graphs.values())

    def __call__(self, key: Hashable):
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(functools.partial(self.fn, key), self.device,
                                                 self.generators, self.capture_error_mode,
                                                 self.pool)
        return graph()
