"""Pipeline parallelism for the GPT family — the port of
``mop_tpu/parallel/pp.py``.

The block stack is split into S contiguous stages, one per process along a
mesh axis (``model`` for ``make_pp_lm_train_step`` and the 1F1B step, as in
JAX; ``stage`` on ``make_mesh3``'s mesh for the composed step). Each process
holds its stage's ``n_layer / S`` blocks, stacked on a leading layer axis,
and no others: the memory point of pipelining. The embedding (``wte``,
``wpe``) and the final LayerNorm are replicated on every process; the tied
head reads ``wte``.

JAX writes the schedule as one ``lax.scan`` inside a ``shard_map`` and lets
``jax.grad`` differentiate through its ``ppermute``s. Point-to-point sends
are not differentiable here, so the schedule is written by hand, tick by
tick, with the backward hand-written too: each tick ends in one
``batch_isend_irecv`` with the neighbouring stages (``comm.exchange``, a
``collective-permute`` to ``utils.collectives``) in which every send and
receive of the tick is posted at once, so that no stage waits on another's
compute. A stage runs only on real input: the fill and drain ticks that JAX
runs on a stand-in embedding (its "safe" input) do not exist here.

- **GPipe** (``make_pp_lm_train_step``): M microbatches go forward through
  the stages in M + S - 1 ticks, each stage keeping its microbatches'
  graphs; the last stage takes each microbatch's loss (``ln_f``, the tied
  head, the fp32 cross-entropy, weighted 1 / M). Then the backward runs the
  schedule in reverse, each stage sending its input's gradient to the one
  before. Dropout must be 0.
- **1F1B** (``make_pp_lm_train_step_1f1b``): one schedule of M + 2S - 2
  ticks; microbatch m runs forward on stage s at tick m + s (no graph) and
  backward at tick m + 2(S - 1) - s, recomputing the stage from its stored
  input and differentiating the recompute. At most min(M, 2S - 1) stage
  inputs are stored. The last stage's forward is its recompute: it runs its
  microbatch once, with the graph, and seeds the backward in the same tick.
  Dropout masks come from generators seeded by (base, microbatch, data
  shard, global layer) as JAX folds its keys, so the recompute replays the
  forward's masks and ``reference_1f1b_composition``, the model's own
  forward on one process, draws them too; the embedding's mask is drawn
  over the global batch and sliced.
- **dp x tp x pp** (``make_pp_tp_lm_train_step``, on ``make_mesh3``'s
  ``(data, model, stage)`` mesh): GPipe over ``stage``, each stage's blocks
  through ``tp.tp_shard_params``' Megatron layout over ``model`` (a leaf
  whose split dim does not divide stays whole, as JAX demotes it), the batch
  over ``data``. Handoffs go from (d, m, s) to (d, m, s + 1), of activations
  that are replicated over ``model``.

Every process passes the whole global batch (the data streams are seeded, so
each makes it identically) and takes the rows of its data index within each
microbatch, as JAX's ``P(None, 'data')`` places them. Every gradient is
averaged over the ``data`` axis; the tied ``wte`` sums stage 0's embedding
gradient and the last stage's head gradient over the stages; the loss is
broadcast from the last stage, so every process returns it.

A stage's blocks run as one template block (``block_module_for``, on the
``meta`` device: it holds no weights) called with each layer's slice of the
stacked tensors (``torch.func.functional_call``), as JAX applies its block
module to each slice of the stack. The optimizer is the port's: built over
the placed tensors by ``pp_init_opt_state`` and stepped in place by the
step, as ``tp_init_opt_state`` / ``make_tp_lm_train_step`` do.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.gpt_mop import GPT_MoP, MoPBlock
from ..models.layers import LayerNorm, set_generator
from ..models.quartet_attn_patch import Block, TinyTransformerLM
from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS, STAGE_AXIS, Mesh, Sharding
from .train_step import _step_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]

_MASK63 = (1 << 63) - 1
_EMBED_FOLD = 2**20  # the embedding's dropout key: fold_in(base, 2**20) in JAX
_DATA_FOLD = 2**18  # the data shard's: fold_in(., 2**18 + shard)


def block_module_for(model: nn.Module, device="meta") -> nn.Module:
    """The per-layer block module of ``model`` (GPT family), built on
    ``device`` (``meta``: a template with no storage, which the stage loop
    calls with each layer's weights)."""
    if isinstance(model, GPT_MoP):
        def make():
            return MoPBlock(model.config, n_views=model.n_views, n_kernels=model.n_kernels,
                            causal_gate=model.causal_gate)
    elif isinstance(model, TinyTransformerLM):
        def make():
            return Block(model.config)
    else:
        raise TypeError(f"no pipeline block known for {type(model).__name__}")
    with torch.device(device):
        return make()


def _state_dict(params) -> Params:
    if isinstance(params, nn.Module):
        return {k: v.detach() for k, v in params.state_dict().items()}
    return dict(params)


def split_gpt_params(params, n_layer: int) -> Tuple[Params, Params, Params]:
    """Split a GPT state dict (or model) into (stem, stacked blocks, head).

    stem: ``wte.weight`` (and ``wpe.weight``); head: ``ln_f.*``; blocks:
    every ``blocks.i.<name>`` stacked into ``<name>`` with a leading
    (n_layer, ...) axis, the stacking the stage axis splits."""
    sd = _state_dict(params)
    stem = {k: v for k, v in sd.items() if k.split(".")[0] in ("wte", "wpe")}
    head = {k: v for k, v in sd.items() if k.startswith("ln_f.")}
    names = [k[len("blocks.0."):] for k in sd if k.startswith("blocks.0.")]
    stacked = {n: torch.stack([sd[f"blocks.{i}.{n}"] for i in range(n_layer)]) for n in names}
    return stem, stacked, head


def merge_gpt_params(stem: Params, stacked: Params, head: Params, n_layer: int) -> Params:
    """Inverse of ``split_gpt_params``: a state dict ``load_state_dict``
    takes. ``stacked`` must hold all n_layer layers (``gather_stacked``)."""
    out = dict(stem)
    for n, t in stacked.items():
        if t.shape[0] != n_layer:
            raise ValueError(f"merge_gpt_params: {n} holds {t.shape[0]} of {n_layer} layers; "
                             "gather the stages first (gather_stacked)")
        for i in range(n_layer):
            out[f"blocks.{i}.{n}"] = t[i]
    out.update(head)
    return out


def _param(t: Tensor, mesh: Mesh, spec: Tuple = (), full_shape=None) -> nn.Parameter:
    p = nn.Parameter(t.detach().to(mesh.device, copy=True).contiguous())
    p.sharding = Sharding(mesh, tuple(spec))
    p.full_shape = tuple(full_shape) if full_shape is not None else tuple(t.shape)
    return p


def _stage_slice(n_layer: int, mesh: Mesh, axis: str) -> slice:
    s_size = mesh.shape[axis]
    if n_layer % s_size:
        raise ValueError(f"n_layer {n_layer} does not divide by the {s_size} stages")
    l_per = n_layer // s_size
    s = mesh.axis_index(axis)
    return slice(s * l_per, (s + 1) * l_per)


def _place(params, mesh: Mesh, n_layer: int, axis: str, split=None):
    stem, stacked, head = split_gpt_params(params, n_layer)
    sl = _stage_slice(n_layer, mesh, axis)
    out = {}
    for n, t in stacked.items():
        local, spec = t[sl], [axis] + [None] * (t.ndim - 1)
        dim = (split or {}).get(n)
        if dim is not None:  # the Megatron split inside the stage (composed step)
            size, i = mesh.shape[MODEL_AXIS], mesh.axis_index(MODEL_AXIS)
            w = local.shape[1 + dim] // size
            local, spec[1 + dim] = local.narrow(1 + dim, i * w, w), MODEL_AXIS
        out[n] = _param(local, mesh, spec, t.shape)
    return ({k: _param(v, mesh) for k, v in stem.items()}, out,
            {k: _param(v, mesh) for k, v in head.items()})


def place_pp_params(params, mesh: Mesh, n_layer: int) -> Tuple[Params, Params, Params]:
    """Split ``params`` (a GPT model or its state dict, the same on every
    process) and place this process's part on the mesh's device: its stage's
    (n_layer / S, ...) slice of every stacked block tensor, stage-major over
    ``model``, and the whole stem and head. Returns (stem, stacked, head),
    dicts of ``nn.Parameter`` whose ``sharding`` attribute is their
    ``Sharding``."""
    return _place(params, mesh, n_layer, MODEL_AXIS)


def _flat(stem: Params, stacked: Params, head: Params) -> List[Tensor]:
    return [*stem.values(), *stacked.values(), *head.values()]


def pp_init_opt_state(make_optimizer: Callable, stem: Params, stacked: Params,
                      head: Params) -> torch.optim.Optimizer:
    """The optimizer (``make_optimizer(params)``, e.g. ``lambda p:
    torch.optim.AdamW(p, 1e-3)``) over this process's tensors: each moment
    lives beside its stage slice."""
    return make_optimizer(_flat(stem, stacked, head))


def gather_stacked(stacked: Params) -> Params:
    """Every stacked tensor whole (n_layer, ...): gathered over each mesh axis
    its ``sharding`` splits (a collective over the stages, and over the model
    axis for the composed step's split weights)."""
    out = {}
    with torch.no_grad():
        for n, t in stacked.items():
            full = t.detach()
            sh = getattr(t, "sharding", None)
            for dim, axis in enumerate(sh.spec if sh is not None else ()):
                if axis is not None and sh.mesh.group(axis) is not None:
                    full = comm._gather(full, dim, sh.mesh.group(axis))
            out[n] = full.clone()
    return out


def _fold(seed: int, *data: int) -> int:
    """``seed`` with each of ``data`` mixed in (a splitmix64 step each): the
    generator seed of a (base, microbatch, data shard, layer) tuple, as
    ``jax.random.fold_in`` derives a key."""
    x = int(seed) & ((1 << 64) - 1)
    for d in data:
        x = (x + 0x9E3779B97F4A7C15 + (int(d) & ((1 << 64) - 1))) & ((1 << 64) - 1)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x ^= x >> 31
    return x & _MASK63


class _Pipeline:
    """One process's part of a pipelined step: its stage on ``axis``, its
    data index, the template block and the pieces every schedule shares."""

    def __init__(self, model, mesh: Mesh, axis: str, n_microbatches: int, compute_dtype,
                 device, block: Optional[nn.Module] = None):
        cfg = model.config
        self.cfg = cfg
        self.S, self.s = mesh.shape[axis], mesh.axis_index(axis)
        self.group = mesh.group(axis)
        self.M = int(n_microbatches)
        if cfg.n_layer % self.S:
            raise ValueError(f"n_layer {cfg.n_layer} does not divide by the {self.S} stages")
        self.l_per = cfg.n_layer // self.S
        self.d_group = mesh.group(DATA_AXIS)
        self.n_data, self.d = mesh.shape[DATA_AXIS], mesh.axis_index(DATA_AXIS)
        self.cdt = compute_dtype
        self.act_dtype = compute_dtype or torch.float32
        self.device = _step_device(device, mesh)
        self.block = block if block is not None else block_module_for(model)
        self.block.train()
        with torch.device("meta"):
            self.ln_f = LayerNorm(cfg.n_embd)
        self.peak_in_flight = 0  # 1F1B: the most stage inputs stored at once

    def _cast(self, t: Tensor) -> Tensor:
        return t.to(self.cdt) if self.cdt is not None and t.is_floating_point() else t

    def rows(self, m: int, b: int) -> slice:
        """This process's rows of microbatch m of a global batch of b rows."""
        if b % self.M or (b // self.M) % self.n_data:
            raise ValueError(f"batch {b} does not divide into {self.M} microbatches over "
                             f"{self.n_data} data shards")
        mb = b // self.M
        sl = mb // self.n_data
        return slice(m * mb + self.d * sl, m * mb + (self.d + 1) * sl)

    def embed(self, stem: Params, idx: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """The model's ``_embed`` over ``idx``: ``wte`` rows plus ``wpe``,
        in the compute dtype; ``mask`` is the embedding dropout's keep mask."""
        t = idx.shape[1]
        if t > self.cfg.block_size:
            raise ValueError(f"sequence length {t} > block size {self.cfg.block_size}")
        x = F.embedding(idx, self._cast(stem["wte.weight"]))
        if "wpe.weight" in stem:
            x = x + self._cast(stem["wpe.weight"])[:t][None]
        if mask is not None:
            keep = 1.0 - self.cfg.dropout
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return x.to(self.act_dtype)

    def embed_mask(self, b: int, t: int, rng: Optional[int]) -> Optional[Tensor]:
        """The embedding dropout's keep mask over the global (b, t, C) batch."""
        if self.cfg.dropout == 0.0:
            return None
        g = torch.Generator(device=self.device).manual_seed(_fold(rng, _EMBED_FOLD))
        return torch.rand((b, t, self.cfg.n_embd), device=self.device,
                          generator=g) < 1.0 - self.cfg.dropout

    def layer_generators(self, rng: Optional[int], m: int, d: int, first: int):
        if rng is None or self.cfg.dropout == 0.0:
            return [None] * self.l_per
        base = _fold(rng, m, _DATA_FOLD + d)
        return [torch.Generator(device=self.device).manual_seed(_fold(base, first + j))
                for j in range(self.l_per)]

    def run_layers(self, stacked: Params, x: Tensor, gens) -> Tensor:
        """The stage: each of its layers' slice of ``stacked`` through the
        template block."""
        for j in range(len(gens)):
            set_generator(self.block, gens[j])
            x = functional_call(self.block, {n: self._cast(t[j]) for n, t in stacked.items()},
                                (x,))
        return x

    def head_loss(self, stem: Params, head: Params, out: Tensor, tgt: Tensor) -> Tensor:
        """``ln_f``, the tied head and the fp32 mean cross-entropy of one
        microbatch, weighted 1 / M so that the microbatches sum to the mean."""
        h = functional_call(self.ln_f, {k[len("ln_f."):]: self._cast(v) for k, v in head.items()},
                            (out,))
        logits = h @ self._cast(stem["wte.weight"]).t()
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(-1, tgt[..., None].long()).mean() / self.M

    # ------------------------------------------------------------ ticks --

    def _valid(self, m: int) -> bool:
        return 0 <= m < self.M

    def _tick(self, sends, recvs, like: Tensor):
        """One exchange with the neighbouring stages: ``sends`` holds this
        tick's ``(tensor, stage)`` pairs, ``recvs`` the stages it receives
        from; returns the received tensors."""
        if self.S == 1:
            return []
        return comm.exchange(self.group, sends, [(like, r) for r in recvs])

    def gpipe(self, stem, stacked, head, idx, targets) -> Tensor:
        """GPipe: every microbatch forward, then every one backward in
        reverse; the grads accumulate in the tensors' ``.grad``. Returns the
        last stage's sum of the weighted microbatch losses (0 elsewhere)."""
        S, s, M = self.S, self.s, self.M
        b, t = idx.shape
        like = torch.empty((b // M // self.n_data, t, self.cfg.n_embd), dtype=self.act_dtype,
                           device=self.device)
        gens = [None] * self.l_per
        kept, recv = {}, None
        total = torch.zeros((), device=self.device)
        for tick in range(M + S - 1):
            m = tick - s
            sends = []
            if self._valid(m):
                rows = self.rows(m, b)
                inp = self.embed(stem, idx[rows]) if s == 0 else recv.requires_grad_()
                out = self.run_layers(stacked, inp, gens)
                if s == S - 1:
                    loss = self.head_loss(stem, head, out, targets[rows])
                    total += loss.detach()
                    kept[m] = (inp, loss)
                else:
                    kept[m] = (inp, out)
                    sends.append((out.detach(), s + 1))
            recvs = [s - 1] if s > 0 and self._valid(tick - (s - 1)) else []
            got = self._tick(sends, recvs, like)
            recv = got[0] if got else None
        cot = None
        for tick in range(M + S - 1):
            m = M - 1 - (tick - (S - 1 - s))
            sends = []
            if self._valid(m):
                inp, y = kept.pop(m)
                torch.autograd.backward(y, None if s == S - 1 else cot)
                if s > 0:
                    sends.append((inp.grad, s - 1))
            nxt = M - 1 - (tick - (S - 2 - s))
            recvs = [s + 1] if s < S - 1 and self._valid(nxt) else []
            got = self._tick(sends, recvs, like)
            cot = got[0] if got else None
        return total

    def one_f_one_b(self, stem, stacked, head, idx, targets, rng) -> Tensor:
        """1F1B (the module docstring); returns what ``gpipe`` returns."""
        S, s, M = self.S, self.s, self.M
        b, t = idx.shape
        like = torch.empty((b // M // self.n_data, t, self.cfg.n_embd), dtype=self.act_dtype,
                           device=self.device)
        mask = self.embed_mask(b, t, rng)
        first = s * self.l_per
        stored: Dict[int, Tensor] = {}
        recv_f = recv_b = None
        total = torch.zeros((), device=self.device)
        self.peak_in_flight = 0

        def stage_input(m, grad):
            rows = self.rows(m, b)
            if s == 0:
                with torch.set_grad_enabled(grad):
                    return self.embed(stem, idx[rows], None if mask is None else mask[rows])
            return None

        for tick in range(M + 2 * S - 2):
            m_f, m_b = tick - s, tick - 2 * (S - 1) + s
            sends = []
            if s < S - 1 and self._valid(m_f):  # forward slot, no graph
                inp = stage_input(m_f, False) if s == 0 else recv_f
                if s > 0:
                    stored[m_f] = inp
                    self.peak_in_flight = max(self.peak_in_flight, len(stored))
                with torch.no_grad():
                    out = self.run_layers(stacked, inp,
                                          self.layer_generators(rng, m_f, self.d, first))
                sends.append((out, s + 1))
            if self._valid(m_b):  # backward slot: recompute, differentiate
                gens = self.layer_generators(rng, m_b, self.d, first)
                if s == 0:
                    x = stage_input(m_b, True)
                else:
                    x = (recv_f if s == S - 1 else stored.pop(m_b)).detach().requires_grad_()
                out = self.run_layers(stacked, x, gens)
                if s == S - 1:
                    loss = self.head_loss(stem, head, out, targets[self.rows(m_b, b)])
                    total += loss.detach()
                    loss.backward()
                else:
                    torch.autograd.backward(out, recv_b)
                if s > 0:
                    sends.append((x.grad, s - 1))
            recvs = []
            if s > 0 and self._valid(tick - (s - 1)):
                recvs.append(s - 1)
            if s < S - 1 and self._valid(tick - 2 * (S - 1) + s + 1):
                recvs.append(s + 1)
            got = dict(zip(recvs, self._tick(sends, recvs, like)))
            recv_f, recv_b = got.get(s - 1), got.get(s + 1)
        return total

    def finish(self, stem, stacked, head, total: Tensor, model_partial=(), model_group=None):
        """The reductions after a schedule: the replicated stem and head grads
        summed over the stages (stage 0's embedding, the last stage's head),
        the composed step's partial grads over ``model``, every grad averaged
        over ``data``; the loss from the last stage to every process,
        averaged over ``data``."""
        rep = [*stem.values(), *head.values()]
        for p in rep + list(stacked.values()):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        comm.all_reduce_flat_([p.grad for p in rep], self.group)
        comm.all_reduce_flat_([stacked[n].grad for n in model_partial], model_group)
        comm.all_reduce_flat_([p.grad for p in _flat(stem, stacked, head)], self.d_group,
                              1.0 / self.n_data)
        if self.group is not None:
            comm.broadcast_(total, self.group, dist.get_global_rank(self.group, self.S - 1))
        comm.all_reduce_(total, self.d_group)
        return total / self.n_data


def _check_no_dropout(cfg, what: str) -> None:
    if cfg.dropout != 0.0:
        raise ValueError(f"{what} runs its stages deterministically (no dropout generators "
                         "are threaded through the schedule); use dropout 0 or the 1F1B step")


def _make_step(pipe: _Pipeline, optimizer, schedule, partial=(), model_group=None):
    def step(stem: Params, stacked: Params, head: Params, idx: Tensor, targets: Tensor,
             *rng) -> Dict[str, Tensor]:
        optimizer.zero_grad(set_to_none=True)
        idx = idx.to(pipe.device, non_blocking=True)
        targets = targets.to(pipe.device, non_blocking=True)
        total = schedule(stem, stacked, head, idx, targets, *rng)
        loss = pipe.finish(stem, stacked, head, total, partial, model_group)
        optimizer.step()
        return {"loss": loss}

    return step


def make_pp_lm_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh,
                          n_microbatches: int, compute_dtype: Optional[torch.dtype] = None,
                          device=None):
    """GPipe train step over the mesh's ``model`` axis: ``step(stem, stacked,
    head, idx (B, T), targets (B, T)) -> {"loss"}``, the tensors from
    ``place_pp_params``, ``optimizer`` from ``pp_init_opt_state`` (updated in
    place), the whole global batch on every process. B must divide by
    ``n_microbatches`` and each microbatch by the data axis; ``n_layer`` by
    the stage count; dropout must be 0. ``compute_dtype`` (None: fp32) is
    what the tensors are cast to for the forward, as JAX's ``cast_floats``."""
    _check_no_dropout(model.config, "the GPipe step")
    pipe = _Pipeline(model, mesh, MODEL_AXIS, n_microbatches, compute_dtype, device)
    return _make_step(pipe, optimizer, pipe.gpipe)


def make_pp_lm_train_step_1f1b(model: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh,
                               n_microbatches: int,
                               compute_dtype: Optional[torch.dtype] = None, device=None):
    """1F1B train step, with dropout: ``step(stem, stacked, head, idx,
    targets, rng) -> {"loss"}``, ``rng`` an integer seed (the PRNG key of
    JAX's step) from which every dropout mask of the step is derived (the
    module docstring). Otherwise as ``make_pp_lm_train_step``."""
    pipe = _Pipeline(model, mesh, MODEL_AXIS, n_microbatches, compute_dtype, device)
    step = _make_step(pipe, optimizer, pipe.one_f_one_b)
    step.pipeline = pipe
    return step


def reference_1f1b_composition(model: nn.Module, stem: Params, stacked: Params, head: Params,
                               idx: Tensor, targets: Tensor, rng: int, n_microbatches: int,
                               n_data: int = 1, compute_dtype: Optional[torch.dtype] = None
                               ) -> Tuple[Tensor, Tuple[Params, Params, Params]]:
    """One process, no pipeline: the loss and grads of the 1F1B step's
    function through the model's own forward, with the step's masks. Each
    microbatch's rows of each data shard go through ``model`` in training
    (``functional_call`` with the given tensors cast to ``compute_dtype``):
    block i's dropout draws from a generator seeded by (rng, microbatch,
    data shard, i), the embedding's from one seeded by rng over the whole
    batch, of which its ``shards`` keep those rows. It shares nothing with
    the step but the seeds (``_fold``). ``stacked`` holds all n_layer
    layers; ``n_data`` must be the data-axis size of the step it is held to.
    Returns (loss, (d stem, d stacked, d head))."""
    n_layer, dev = model.config.n_layer, stem["wte.weight"].device
    leaves = [{k: v.detach().clone().requires_grad_() for k, v in tree.items()}
              for tree in (stem, stacked, head)]
    p_stem, p_stacked, p_head = leaves

    def cast(t: Tensor) -> Tensor:
        return t.to(compute_dtype) if compute_dtype is not None and t.is_floating_point() else t

    b, M = idx.shape[0], int(n_microbatches)
    if b % (M * n_data):
        raise ValueError(f"batch {b} does not divide into {M} microbatches of {n_data} shards")
    sl = b // (M * n_data)
    was, shards = model.training, model.drop.shards
    model.train()
    total = torch.zeros((), device=dev)
    try:
        for m in range(M):
            for d in range(n_data):
                tensors = {k: cast(v) for k, v in {**p_stem, **p_head}.items()}
                tensors.update({f"blocks.{i}.{n}": cast(v[i]) for n, v in p_stacked.items()
                                for i in range(n_layer)})
                base = _fold(rng, m, _DATA_FOLD + d)
                for i, blk in enumerate(model.blocks):
                    set_generator(blk, torch.Generator(device=dev).manual_seed(_fold(base, i)))
                model.drop.generator = torch.Generator(device=dev).manual_seed(
                    _fold(rng, _EMBED_FOLD))
                k = m * n_data + d  # these rows' block of the global batch
                model.drop.shards = ((0, k, M * n_data),)
                rows = slice(k * sl, (k + 1) * sl)
                _, loss = functional_call(model, tensors, (idx[rows],),
                                          {"targets": targets[rows]})
                total = total + loss / (M * n_data)
    finally:
        model.train(was)
        model.drop.shards = shards
        set_generator(model, None)
    grads = torch.autograd.grad(total, [v for tree in leaves for v in tree.values()],
                                allow_unused=True)
    it = iter(grads)
    out = tuple({k: (lambda g, v: torch.zeros_like(v) if g is None else g)(next(it), v)
                 for k, v in tree.items()} for tree in leaves)
    return total.detach(), out


# ---------------------- composed dp x tp x pp ----------------------


def _tp_block(model: nn.Module, mesh: Mesh):
    """The composed step's template: a block through ``tp_shard_params``
    over ``model``, and for each of its tensors the dim it splits (or None)
    and whether its grad is summed over the model axis. The template's own
    weights are then dropped (moved to ``meta``)."""
    from .tp import tp_shard_params

    blk = block_module_for(model, device=mesh.device)
    tp_shard_params(blk, mesh)
    partial = {id(p) for p in blk._tp.partial}
    split = {n: getattr(p, "shard_dim", None) for n, p in blk.named_parameters()}
    part = tuple(n for n, p in blk.named_parameters() if id(p) in partial)
    blk.to("meta")
    return blk, split, part


def place_pp_tp_params(params, mesh: Mesh, n_layer: int, model: Optional[nn.Module] = None
                       ) -> Tuple[Params, Params, Params]:
    """Split and place for the composed step: the blocks stage-major over
    ``stage`` and, inside a stage, tensor-split over ``model`` by the
    Megatron rules (``tp_shard_params``'; a leaf whose split dim does not
    divide stays whole). ``params``: a GPT model (or its state dict with
    ``model`` the model it belongs to)."""
    model = params if model is None else model
    _, split, _ = _tp_block(model, mesh)
    return _place(params, mesh, n_layer, STAGE_AXIS,
                  {n: d for n, d in split.items() if d is not None})


def make_pp_tp_lm_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, mesh: Mesh,
                             n_microbatches: int, compute_dtype: Optional[torch.dtype] = None,
                             device=None):
    """Composed dp x tp x pp GPipe train step on a ``make_mesh3`` mesh:
    ``step(stem, stacked, head, idx, targets) -> {"loss"}`` with the tensors
    from ``place_pp_tp_params``; otherwise as ``make_pp_lm_train_step``
    (dropout must be 0)."""
    _check_no_dropout(model.config, "the composed step")
    blk, _, partial = _tp_block(model, mesh)
    pipe = _Pipeline(model, mesh, STAGE_AXIS, n_microbatches, compute_dtype, device, block=blk)
    return _make_step(pipe, optimizer, pipe.gpipe, partial, mesh.group(MODEL_AXIS))
