"""Ahead-of-time model export over ``torch.export``: the port of
``mop_tpu/serving/export.py`` (``jax.export``).

A model is traced once into an ``ExportedProgram`` per device, serialized
(``torch.export.save``) into one byte artifact that a serving host replays
without the model's Python code: ``load_exported`` needs only torch and,
for a program that calls the port's kernels, ``mop_tpu_torch.ops.fused``
(imported on load, which registers them).

- Polymorphic batch: the leading axis of the chosen arguments is a symbolic
  dimension (``torch.export.Dim``), so one artifact serves any batch size;
  the example's batch must be at least 2 (an example batch of 1 would
  specialize it).
- Platforms: ``platforms=("cuda", "cpu")`` traces one program for each
  device named, from the example arguments moved there; ``load_exported``
  runs the one of its inputs' device. Params are live inputs (a name ->
  tensor dict), so one artifact serves fine-tuned variants of one structure.
- Kernels: on the card a module's fused route dispatches the port's kernels.
  While an export traces, each kernel forward is the registered op
  ``mop_tpu_torch::<name>`` (``ops.fused.EXPORT_OPS``), kept in the graph.
  As JAX's export refuses non-portable custom calls, ``export_fn`` refuses a
  program that holds one unless ``allow_custom_calls=True``; such an
  artifact replays only where the kernels exist. Export is inference only.

Usage::

    blob = export_apply(model, params, example_x)      # bytes
    fn = load_exported(blob)                           # or a path
    logits = fn(params, x)                             # any batch size
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["export_apply", "export_fn", "load_exported", "save_exported"]

_NAMESPACE = "mop_tpu_torch"


class _Fn(torch.nn.Module):
    """A function as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _device_of(args) -> str:
    leaves = [t for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor)]
    return leaves[0].device.type if leaves else "cpu"


def _custom_calls(program) -> list:
    """The ``mop_tpu_torch::`` ops a program calls, sorted."""
    names = set()
    for node in program.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "name"):
            name = node.target.name()
            if name.startswith(_NAMESPACE + "::"):
                names.add(name.split(".")[0])
    return sorted(names)


def export_fn(fn, *example_args, platforms: Optional[Sequence[str]] = None,
              poly_batch_args: Sequence[int] = (), allow_custom_calls: bool = False) -> bytes:
    """Trace ``fn`` at ``example_args`` and serialize it.

    ``poly_batch_args``: indices of positional args whose leading axis becomes
    the symbolic batch dimension ``b`` (every tensor leaf of that arg carries
    it). ``platforms``: the devices to trace for (``"cuda"``, ``"cpu"``),
    by default the example args' device. ``allow_custom_calls``: keep a
    program that calls the port's kernels (``mop_tpu_torch::`` ops); without
    it such a program raises a ``ValueError`` that names them."""
    platforms = tuple(platforms) if platforms else (_device_of(example_args),)
    b = torch.export.Dim("b")
    dyn = tuple(pytree.tree_map(
        lambda t: {0: b} if i in poly_batch_args and isinstance(t, torch.Tensor) else None, a)
        for i, a in enumerate(example_args))
    programs = {}
    for plat in platforms:
        args = pytree.tree_map(
            lambda t: t.detach().to(plat) if isinstance(t, torch.Tensor) else t, example_args)
        prog = torch.export.export(_Fn(fn), args,
                                   dynamic_shapes={"args": dyn} if poly_batch_args else None)
        calls = _custom_calls(prog)
        if calls and not allow_custom_calls:
            raise ValueError(
                f"the {plat} program calls the port's kernels {calls}, which replay only where "
                "mop_tpu_torch is installed and they are built; pass allow_custom_calls=True "
                "to keep them")
        buf = io.BytesIO()
        torch.export.save(prog, buf)
        programs[plat] = buf.getvalue()
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        z.writestr("platforms.json", json.dumps(list(platforms)))
        for plat, data in programs.items():
            z.writestr(f"{plat}.pt2", data)
    return out.getvalue()


def export_apply(model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]], example_x,
                 platforms: Optional[Sequence[str]] = None, poly_batch: bool = True,
                 train: bool = False, allow_custom_calls: bool = False,
                 **apply_kwargs) -> bytes:
    """Export a model's forward as ``(params, x) -> out``: ``params`` a name ->
    tensor dict of its parameters and buffers (None: the model's own), live
    inputs of the program; ``model(x, **apply_kwargs)`` traced in eval mode
    (``train=False``) or train mode. With ``poly_batch`` the input's leading
    axis is symbolic."""
    if params is None:
        params = dict(model.state_dict())
    params = {k: v.detach() for k, v in params.items()}
    was_training = model.training
    model.train(train)

    def fwd(p, x):
        return torch.func.functional_call(model, p, (x,), apply_kwargs)

    try:
        return export_fn(fwd, params, example_x, platforms=platforms,
                         poly_batch_args=(1,) if poly_batch else (),
                         allow_custom_calls=allow_custom_calls)
    finally:
        model.train(was_training)


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


@dataclass
class Exported:
    """An artifact's metadata: ``platforms`` and each one's
    ``ExportedProgram`` (``programs``)."""
    platforms: Tuple[str, ...]
    programs: Dict[str, "torch.export.ExportedProgram"]


def _check_shapes(program, args) -> None:
    """A ``ValueError`` for an input whose static dims differ from the
    program's (a fixed batch called at another size, say)."""
    leaves = [t for t in pytree.tree_leaves(args) if isinstance(t, torch.Tensor)]
    specs = [n.meta["val"] for n in program.graph.nodes
             if n.op == "placeholder" and n.name in program.graph_signature.user_inputs]
    for t, want in zip(leaves, specs):
        dims = tuple(want.shape)
        if t.dim() != len(dims) or any(isinstance(d, int) and d != s
                                       for d, s in zip(dims, t.shape)):
            raise ValueError(f"input of shape {tuple(t.shape)} where the exported program "
                             f"takes {dims}")


def load_exported(blob_or_path):
    """Deserialize an artifact (its bytes or a path) into a callable that runs
    the program of its inputs' device. Its ``exported`` attribute holds the
    metadata (``platforms``, ``programs``)."""
    from ..ops import fused  # noqa: F401  registers the mop_tpu_torch:: ops

    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_path)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        platforms = tuple(json.loads(z.read("platforms.json")))
        programs = {p: torch.export.load(io.BytesIO(z.read(f"{p}.pt2"))) for p in platforms}
    modules = {p: prog.module() for p, prog in programs.items()}

    def call(*args):
        plat = _device_of(args)
        if plat not in programs:
            raise ValueError(f"the artifact holds programs for {list(platforms)}, not {plat}")
        _check_shapes(programs[plat], args)
        return modules[plat](*args)

    call.exported = Exported(platforms, programs)
    return call
