"""Which collectives a step runs, and how many bytes they move — the
counterpart of ``mop_tpu/utils/hlo_inspect.py``.

The JAX package reads them from the compiled HLO of a step; the port runs
its collectives eagerly, one ``torch.distributed`` call each, so it records
the calls: ``record_collectives()`` wraps ``torch.distributed``'s collective
functions while it is open and appends one entry per call, named as XLA
names the op (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``, ``collective-permute`` for each tensor a point-to-point
exchange sends, ``broadcast``), with the bytes of its result (for a permute,
of the tensor sent). ``collective_summary`` / ``collective_count`` /
``collective_bytes`` read such a record, as the JAX functions read HLO text.

    with record_collectives() as rec:
        step(x, y, g)
    collective_count(rec, "all-reduce")
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.distributed as dist

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
               "all-to-all", "broadcast")


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


# torch.distributed function -> (XLA op name, the argument whose bytes count).
_WRAPPED = {
    "all_reduce": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather": ("all-gather", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "broadcast": ("broadcast", 0),
}


@contextlib.contextmanager
def record_collectives():
    """Record every collective called through ``torch.distributed`` while
    open; yields the record, a list of ``{"op", "bytes"}``."""
    record: List[dict] = []
    saved = {}

    def wrap(name, op, arg):
        fn = getattr(dist, name)

        def recorded(*args, **kwargs):
            record.append({"op": op, "bytes": _nbytes(args[arg] if args else
                                                      next(iter(kwargs.values())))})
            return fn(*args, **kwargs)

        return fn, recorded

    for name, (op, arg) in _WRAPPED.items():
        saved[name], recorded = wrap(name, op, arg)
        setattr(dist, name, recorded)
    saved["batch_isend_irecv"] = batch = dist.batch_isend_irecv

    def recorded_batch(p2p_ops):
        for p in p2p_ops:
            if p.op is dist.isend:
                record.append({"op": "collective-permute", "bytes": _nbytes(p.tensor)})
        return batch(p2p_ops)

    dist.batch_isend_irecv = recorded_batch
    try:
        yield record
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def collective_summary(record) -> Dict[str, dict]:
    """``{op: {"count": n, "bytes": total}}`` over the ops of a record."""
    out: Dict[str, dict] = {}
    for e in record:
        ent = out.setdefault(e["op"], {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += e["bytes"]
    return out


def collective_bytes(record, op: str) -> int:
    return collective_summary(record).get(op, {}).get("bytes", 0)


def collective_count(record, op: str) -> int:
    return collective_summary(record).get(op, {}).get("count", 0)
