"""Continuous-batching decode engine for the GPT family, in PyTorch: the port
of ``mop_tpu/serving/engine.py`` (``DecodeEngine``, ``SpecDecodeEngine``,
``decode_step_rows``, ``decode_chunk_rows``, ``lora_params_view``); the two
per-row steps live in ``models.generate``, whose single-stream
``decode_step`` / ``decode_chunk`` are their shared-length case. A subclass
with another cache layout replaces ``_make_cache`` and ``_slot_logits``
(``serving.paged``); ``_on_admit`` runs after each admission.

- The KV cache is a fixed pool of ``max_batch`` slots (the
  ``init_decode_cache`` layout, (L, B, H, block, dk); int8 pools carry their
  per-row fp32 scales, GPT-MoP its view history ``mv``).
- Each slot has its own length: the batched step writes each row's new
  K/K2/V at that row's position (in place) and standardizes and masks each
  score row over the row's own live prefix, the per-row form of
  ``generate_cached``'s math.
- Admission is a one-row prefill (``prefill``, or ``prefill_padded`` to a
  bucket) pasted into a free slot; a request retires on EOS, a stop match,
  its budget or the full window, and frees its slot for the next one.

Host-side control (admission, retirement, EOS, stops, DFAs, beams) runs
between device steps in numpy, as in the JAX engine; each step brings its
tokens (and the logprob and beam blocks when they are on) back in one
device-to-host copy. The step reads the per-slot state from device buffers
(``DeviceMirror``: the sampling columns, seeds, output counts, lengths and
the rows that advance), written where host control changes a slot, and
advances it in place: the decode, the picker, the count update and the
extras are one body, run eagerly or as one CUDA graph (JAX's ``_step``), and
``step(n_tokens=k)`` may run k of them as one graph (JAX's ``_mstep``). An
admission is one body too (``_admit_rows``: the prefill or the fed chunk,
the paste into the slot a device index names, the length, the first pick,
its logprobs and the slot's token, counts and prompt mask), over the
engine's input buffer ``_adm_in``, written by one host-to-device copy; run
eagerly or as one CUDA graph per bucket, prefix tail or chunk width (JAX's
``_adm_padded``, ``_adm_chunk``, ``_chunk_feed`` / ``_chunk_tok0``), then
one device-to-host copy. The step composes plain torch ops and launches no
kernel: the Quartet scores of a cached row standardize over its live
prefix, not over K5's whole window.
Params are ``decode_params(model)`` or its ``ops.quant`` int8 / int4 form;
the engine runs on their device.

Tensor parallel: a model through ``parallel.tp.tp_shard_params`` serves
with every process of its model axis running the same engine on the same
requests. Each holds its share of the heads in every pool (the
``cache_sharding`` of the JAX engine, ``Sharding(mesh, (None, None,
'model', None, None))``, is the only layout), computes them, and all-reduces
the row products (the model's ``generate.DecodeSplit``), so the logits come out
whole on every process; the model group's first process picks each step's
tokens and broadcasts them, so every process advances the same streams
whatever its generator holds.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.beam import _top_k
from ..models.generate import (OneSlotRows, _gumbel, decode_chunk_rows, decode_params,
                               decode_rows, decode_split_of, decode_step_rows, init_decode_cache,
                               local_heads, model_n_views, prefill, prefill_padded)
from ..parallel.mesh import MODEL_AXIS
from ..utils.cuda_graph import GraphPerKey, StepGraph, require_graph
from .constrain import mask_row

Tensor = torch.Tensor

__all__ = ["DecodeEngine", "SpecDecodeEngine", "decode_chunk_rows", "decode_step_rows",
           "lora_params_view"]


def lora_params_view(params: dict, rows: Dict[str, Tuple[Tensor, Tensor]]) -> dict:
    """The params with per-row LoRA factors inserted beside each adapted
    kernel (read by ``_lin``). ``rows``: {kernel path: (a, b)}, the path
    slash-joined as in ``training.lora`` (``params/blocks_0/attn/q_proj/
    kernel``), ``a`` (B, din, r) and ``b`` (B, r, dout), row i holding batch
    row i's factors (zeros: no adapter). Only the dicts along each path are
    copied; every tensor is shared with ``params``."""
    def set_parent(tree, parts, a, b):
        node = dict(tree)
        if len(parts) == 1:  # parts[0] is the kernel's key: insert siblings
            node["lora_a"] = a
            node["lora_b"] = b
            return node
        node[parts[0]] = set_parent(node[parts[0]], parts[1:], a, b)
        return node

    for path, (a, b) in rows.items():
        params = set_parent(params, path.split("/"), a, b)
    return params


# The one cache layout of a tensor-parallel engine: (L, B, H, W, dk) split by head.
HEAD_SPLIT = (None, None, MODEL_AXIS, None, None)


def _check_cache_sharding(cache_sharding, tp) -> None:
    """``cache_sharding`` must be None or the head split ``HEAD_SPLIT``; a
    head split over a model axis above 1 needs a tensor-parallel model,
    whose pools then hold its heads."""
    if cache_sharding is None:
        return
    spec = tuple(getattr(cache_sharding, "spec", ("?",)))
    if spec + (None,) * (5 - len(spec)) != HEAD_SPLIT:
        raise ValueError(f"cache_sharding: the engines keep each process's heads of the "
                         f"(L, B, H, W, dk) pools, Sharding(mesh, {HEAD_SPLIT}); got "
                         f"{cache_sharding!r}")
    if tp is None and cache_sharding.mesh.shape.get(MODEL_AXIS, 1) > 1:
        raise ValueError("cache_sharding splits the heads over the model axis: serve a model "
                         "through parallel.tp.tp_shard_params")


def _no_int8_pools(kv_dtype: torch.dtype) -> None:
    """The paged and speculative engines' pools are fp32 or bf16, as JAX's
    engines'; the dense engine's int8 pool is an addition of the port."""
    if kv_dtype == torch.int8:
        raise ValueError("the serving engines support fp32/bfloat16 KV pools; the int8 "
                         "per-row-scale layout is a generate_cached feature")


def _pool_keys(cache: dict) -> Tuple[str, ...]:
    """The cache's per-slot buffers, the slot on axis 1 of each."""
    return tuple(k for k in ("k", "k2", "v", "k_s", "k2_s", "v_s", "mv") if k in cache)


def _pack(*ts: Tensor) -> Tensor:
    """The tensors as one flat buffer of int32 words (floats by their bits),
    for one device-to-host copy; ``_layout`` gives ``_unpack`` their form."""
    return torch.cat([(t.float().contiguous().view(torch.int32) if t.is_floating_point()
                       else t.to(torch.int32)).reshape(-1) for t in ts])


def _layout(*ts: Tensor) -> List[tuple]:
    return [(tuple(t.shape), t.is_floating_point()) for t in ts]


def _unpack(flat: np.ndarray, layout: List[tuple]) -> List[np.ndarray]:
    """``_pack``'s buffer, on the host, split back into arrays (int64, or
    float32 where the tensor was floating)."""
    out, at = [], 0
    for shape, floating in layout:
        n = int(np.prod(shape))
        part = flat[at:at + n].reshape(shape)
        out.append(part.view(np.float32) if floating else part.astype(np.int64))
        at += n
    return out


def _to_host(*ts: Tensor) -> List[np.ndarray]:
    """The tensors on the host in ONE device-to-host copy."""
    return _unpack(_pack(*ts).cpu().numpy(), _layout(*ts))


class DeviceMirror:
    """A device copy of a host per-slot array ((B,), or (C, B) columns) that
    host control changes a few slots at a time (admission, retirement) and a
    device step advances itself: ``sync(host)`` writes the entries where
    ``host`` differs from what the device holds, one ``fill_`` each (no
    tensor made from host data), and ``advanced(host)`` records that the
    device computed ``host``. A captured step reads ``dev`` by its address."""

    def __init__(self, shape, dtype: torch.dtype, device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self._held = np.zeros(shape, bool if dtype == torch.bool else
                              np.float32 if dtype.is_floating_point else np.int64)

    def sync(self, host: np.ndarray) -> None:
        for idx in zip(*np.nonzero(host != self._held)):
            self.dev[tuple(int(i) for i in idx)].fill_(host[idx].item())
        self._held = np.array(host, dtype=self._held.dtype)

    def advanced(self, host: np.ndarray) -> None:
        self._held = host.copy()


# the per-slot sampling columns the batched picker reads, in order
_SP = ("temp", "topk", "topp", "minp", "rep", "pres", "freq")


# the picker's host-known forms, each a graph of its own: no kept row
# samples (no sort, no draw); kept rows sample, none from the engine's
# generator; an unseeded kept row samples (the (B, V) block is drawn)
GREEDY, SAMPLE, DRAW = "greedy", "sample", "draw"

# the admission's routes (``DecodeEngine._admit_rows``): a prompt past the
# last bucket (or with no buckets) prefilled at its own length, eagerly, as
# JAX compiles one executable per length; one padded to its bucket; a
# prefix hit's tail padded to a power of two; a chunk of a chunked prefill
EXACT, BUCKET, TAIL, CHUNK = "exact", "bucket", "tail", "chunk"
_ADM_HEAD = 3  # ``_adm_in``'s scalars before the prompt: slot, base, g


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 that holds its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN, _MIX1, _MIX2 = (_signed(c) for c in (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                                              0x94D049BB133111EB))


def _shr(z: Tensor, n: int) -> Tensor:
    """The logical right shift of int64 words by ``n``."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _mix64(z: Tensor) -> Tensor:
    """splitmix64's finalizer over int64 words (products wrap mod 2**64)."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def seeded_gumbel(seeds: Tensor, ntoks: Tensor, vocab: int) -> Tensor:
    """(B, vocab) standard Gumbel noise, each row a pure function of its
    (seed, ntok) and each entry of its token index: a seeded request's draw
    for its ``ntok``-th output token, whatever the co-batched traffic, the
    engine's generator or the step's form (eager, a graph, a burst). Row b's
    key is splitmix64 of ``seed << 32 | ntok``; entry v is splitmix64's
    (v + 1)-th output from that key, whose top 24 bits give u in (0, 1)."""
    key = _mix64((seeds << 32) + ntoks + _GOLDEN)
    idx = torch.arange(1, vocab + 1, dtype=torch.long, device=seeds.device)
    z = _mix64(key[:, None] + idx[None, :] * _GOLDEN)
    u = (_shr(z, 40).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _generator_mark(gen: torch.Generator):
    """Where ``gen`` stands: its Philox offset on a CUDA device, its state
    on the CPU."""
    return gen.get_offset() if gen.device.type == "cuda" else gen.get_state()


def _rewind(gen: torch.Generator, mark, done: int, wanted: int, shape) -> None:
    """Leave ``gen``, which drew ``done`` blocks of ``shape`` since ``mark``,
    where ``wanted`` such draws from ``mark`` leave it: on a CUDA device its
    offset moved by the measured advance of one block, on the CPU its state
    drawn forward again."""
    if wanted == done:
        return
    if gen.device.type == "cuda":
        per = (gen.get_offset() - mark) // done
        gen.set_offset(mark + wanted * per)
    else:
        gen.set_state(mark)
        for _ in range(wanted):
            torch.rand(shape, generator=gen)


def _penalized(logits: Tensor, sp: Dict[str, Tensor], ocounts: Tensor, pseen: Tensor,
               lbias: Tensor) -> Tensor:
    """The logits with each row's bias and penalties applied (``sampling_dist``'s
    first stage)."""
    logits = logits + lbias
    out = ocounts > 0
    r = sp["rep"][:, None]
    logits = torch.where(pseen | out, torch.where(logits > 0, logits / r, logits * r), logits)
    logits = logits - sp["pres"][:, None] * out
    return logits - sp["freq"][:, None] * ocounts


def sampling_dist(logits: Tensor, sp: Dict[str, Tensor], ocounts: Tensor, pseen: Tensor,
                  lbias: Tensor):
    """The per-row sampler's distribution before the draw, in sorted-logit
    space: ``(greedy (B,), order (B, V), masked (B, V))``. Per row: the logit
    bias added first, the repetition penalty over prompt and output tokens
    and presence / frequency penalties over the output counts (vLLM's
    conventions), the greedy argmax of that; then the temperature and, in
    the descending order ``order`` (ties: the higher index first, as JAX's
    reversed ``argsort``), ranks from ``top_k`` on, tokens past the nucleus
    ``top_p`` and under the ``min_p`` floor masked to -inf. A row's
    ``topk`` 0, ``topp`` 1 and ``minp`` 0 are off."""
    v = logits.shape[1]
    logits = _penalized(logits, sp, ocounts, pseen, lbias)
    greedy = logits.argmax(-1)
    scaled = logits / sp["temp"].clamp_min(1e-6)[:, None]
    order = torch.sort(scaled, dim=-1, stable=True).indices.flip(-1)
    srt = scaled.gather(-1, order)
    ranks = torch.arange(v, device=logits.device)[None, :]
    topk = sp["topk"]
    keep = ranks < torch.where(topk > 0, topk, torch.full_like(topk, v))[:, None]
    probs = torch.softmax(srt.masked_fill(~keep, float("-inf")), -1)
    cum = probs.cumsum(-1)
    keep = keep & ((cum - probs) < sp["topp"][:, None])  # the top token always kept
    minp = sp["minp"]
    floor = srt[:, :1] + torch.log(minp.clamp_min(1e-38))[:, None]
    keep = keep & ((srt >= floor) | (minp[:, None] <= 0.0))
    return greedy, order, srt.masked_fill(~keep, float("-inf"))


class DecodeEngine:
    """Continuous-batching greedy / sampled / beam decode over a fixed slot
    pool.

    >>> eng = DecodeEngine(model, params, max_batch=8)
    >>> rid = eng.submit([5, 17, 3], max_new_tokens=32)
    >>> results = eng.run()          # {rid: [tokens...]}

    ``submit`` may be called at any time, also between ``step`` calls while
    other requests are in flight. ``step`` advances every live request and
    returns this iteration's ``{rid: [tokens]}``; ``run`` steps until the
    queue and the slots drain. The constructor's options are the JAX
    engine's (its docstring, ``mop_tpu/serving/engine.py:245``), with
    ``generator`` in place of ``rng``:

    - ``params``: ``decode_params(model)`` or its int8 / int4 form (None:
      the model's own); the pools live on its device.
    - ``prefill_buckets``: ascending pad lengths; admission pads a prompt to
      the smallest bucket that holds it (``prefill_padded``, the pads masked
      out of every row statistic). The tokens are those without buckets.
    - ``prefix_cache_entries``: an LRU of that many prompts' slot rows (each
      entry a copy that owns its rows); a prompt sharing a prefix with one
      reuses its rows and runs ``decode_chunk_rows`` over the tail only
      (exact). ``prefix_cache_hits`` / ``prefix_tokens_reused`` count it.
    - ``chunk_prefill``: a prompt longer than C is fed C tokens per engine
      step (``decode_chunk_rows``), so that co-batched streams keep emitting.
    - ``kv_dtype``: the pools' storage, fp32, bf16, or int8 with per-row fp32
      scales written beside each row (``generate_cached``'s layout).
    - ``adapters`` / ``adapter_scale``: a bank of LoRA adapters
      (``training.lora`` format, one path set and rank); each request picks
      one by name and its factors are gathered into its slot's rows at
      admission, so requests with different adapters share a step.
    - ``logprobs_topk``: record each emitted token's logprob (fp32
      log-softmax of the raw logits) and the ``logprobs_topk`` most likely
      alternatives (``logprobs`` / ``top_logprobs``, 1:1 with ``results``).
    - ``max_beams``: requests may ask for beam search over k <= max_beams
      adjacent slots; after each step the host picks the group's top k of
      its k x k candidates and the group's cache rows are permuted by parent.
    - ``generator``: the ``torch.Generator`` unseeded sampled rows draw from
      (a fresh one seeded 0 when None). A request's ``seed`` gives its row
      Gumbel noise that is a function of (seed, output position) alone
      instead (``seeded_gumbel``).
    - ``cache_sharding``: None, or ``Sharding(mesh, HEAD_SPLIT)``, the pools
      split by head over the model axis. A tensor-parallel model's pools
      hold its heads either way (the module docstring); any other spec
      raises.
    - ``cuda_graph``: the batched step (``_advance``: the cached step of
      every slot, the picker, the ``adv`` select, the count update and the
      logprob / beam extras) runs as one CUDA graph over the static pools
      and the device per-slot state, one graph per host-known form of the
      picker (greedy, sampled, drawing the engine generator's block; all
      captured into one pool, the generator registered with each), then
      one device-to-host copy. ``step(n_tokens=k)`` replays one graph of k
      steps (one per k) where no constrained row and no beam group is
      live, k capped at the largest headroom; its tokens are those of k
      ``step()`` calls and the generator is left where they leave it.
      An admission (``_admit_rows``) is one replay and one copy: a graph
      per (bucket width, picker form) for a bucketed prompt, per (tail
      width, form) for a prefix hit (the tail padded to the next power of
      two), per (chunk_prefill, form or none) for a chunk, all in the
      step's pool with the generator registered; the slot, the feed's
      base and length are device scalars. Two admissions stay eager by
      design, as JAX's are per exact length: a prompt past the last bucket
      (or an engine without buckets, with no prefix hit or chunk), and a
      beam request (``_admit_beam``); a capture that fails raises. Host
      control and the beams' ranking stay eager. On a CUDA device only; a
      tensor-parallel model (its all-reduces) raises, as does a subclass
      that does not declare ``_captures_step`` in its own body
      (``PagedDecodeEngine`` and ``SpecDecodeEngine`` declare it). Per-row
      LoRA is captured: its factor rows are buffers written in place at
      admission.
    """

    # ``cuda_graph=True`` captures this class's step: read from the class's
    # own body, so that a subclass with another step declares its own
    _captures_step = True

    def __init__(self, model, params: Optional[dict] = None, max_batch: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, cache_sharding=None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefix_cache_entries: int = 0, kv_dtype: torch.dtype = torch.float32,
                 min_p: float = 0.0, repetition_penalty: float = 1.0,
                 presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
                 adapters: Optional[Dict[str, dict]] = None, adapter_scale=1.0,
                 chunk_prefill: Optional[int] = None, logprobs_topk: int = 0,
                 max_beams: int = 0, cuda_graph: bool = False):
        self.model = model
        self.params = decode_params(model) if params is None else params
        self._tp = decode_split_of(model)  # a tensor-parallel model's
        _check_cache_sharding(cache_sharding, self._tp)
        self.device = self.params["params"]["wte"]["embedding"].device
        if cuda_graph:
            if not type(self).__dict__.get("_captures_step", False):
                raise ValueError(f"{type(self).__name__}: cuda_graph=True is the dense "
                                 "DecodeEngine's and that of the engines that declare "
                                 "_captures_step in their own class body; this engine's step is "
                                 "not captured")
            require_graph(type(self).__name__, self.device, tensor_parallel=self._tp)
        self.max_batch = max_batch
        self.eos_id = eos_id
        if not 0 <= int(logprobs_topk) <= 32:
            raise ValueError(f"logprobs_topk must be in [0, 32], got {logprobs_topk}")
        self.logprobs_topk = int(logprobs_topk)
        if not 0 <= int(max_beams) <= max_batch:
            raise ValueError(f"max_beams must be in [0, max_batch={max_batch}], got {max_beams}")
        self.max_beams = int(max_beams)
        self._beam_groups: Dict[int, dict] = {}
        self._beam_finalized: List[tuple] = []
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.repetition_penalty = repetition_penalty
        self.presence_penalty = presence_penalty
        self.frequency_penalty = frequency_penalty
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self._gen = generator
        cfg = model.config
        self.block_size = cfg.block_size
        if kv_dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"kv_dtype must be float32, bfloat16 or int8, got {kv_dtype}")
        self.kv_dtype = kv_dtype
        self._n_views = model_n_views(model)
        self._cache = self._make_cache(cfg, max_batch, kv_dtype)
        self._pool_keys = () if self._cache is None else _pool_keys(self._cache)
        self._lens = np.zeros((max_batch,), np.int64)
        self._tokens = torch.zeros((max_batch,), dtype=torch.long, device=self.device)
        self._slot_rid: List[int] = [-1] * max_batch
        self._budget = np.zeros((max_batch,), np.int64)
        # per-slot sampling parameters, the batched picker's (B,) columns
        self._sp = {"temp": np.zeros(max_batch, np.float32),
                    "topk": np.zeros(max_batch, np.float32),   # 0: off
                    "topp": np.ones(max_batch, np.float32),    # 1: off
                    "minp": np.zeros(max_batch, np.float32),   # 0: off
                    "rep": np.ones(max_batch, np.float32),     # 1: off
                    "pres": np.zeros(max_batch, np.float32),
                    "freq": np.zeros(max_batch, np.float32)}
        self._slot_eos = np.full((max_batch,), -1, np.int64)  # -1: none
        self._slot_seed = np.full((max_batch,), -1, np.int64)  # -1: unseeded
        # each slot's output position, the seeded draw's counter (beam
        # slots, which draw nothing, count their steps too)
        self._slot_ntok = np.zeros((max_batch,), np.int64)
        self._vocab = model.wte.num_embeddings
        dev = self.device
        # what the step reads of each slot, on the device (``_sync_slots``)
        self._dsp = DeviceMirror((len(_SP), max_batch), torch.float32, dev)
        self._dseed = DeviceMirror((max_batch,), torch.long, dev)
        self._dntok = DeviceMirror((max_batch,), torch.long, dev)
        self._dlens = DeviceMirror((max_batch,), torch.long, dev)
        self._dadv = DeviceMirror((max_batch,), torch.bool, dev)
        self._ocounts = torch.zeros((max_batch, self._vocab), dtype=torch.int32, device=dev)
        self._pseen = torch.zeros((max_batch, self._vocab), dtype=torch.bool, device=dev)
        self._lbias = torch.zeros((max_batch, self._vocab), dtype=torch.float32, device=dev)
        self._slot_bias: List[Optional[np.ndarray]] = [None] * max_batch
        self._slot_stops: List[list] = [[] for _ in range(max_batch)]
        self._slot_constraint: List[Optional[Any]] = [None] * max_batch
        self._slot_cstate: List[Any] = [None] * max_batch
        self._lora_bank: Dict[str, tuple] = {}
        self._lora_rows: Dict[str, tuple] = {}
        self._adapter_idx: Dict[Optional[str], int] = {None: 0}
        self._slot_adapter = np.zeros((max_batch,), np.int64)
        if adapters:
            self._init_lora_bank(adapters, adapter_scale, max_batch)
        self._queue: deque = deque()
        self._results: Dict[int, List[int]] = {}
        self._done: Dict[int, bool] = {}
        self._logprobs: Dict[int, List[float]] = {}
        self._top_logprobs: Dict[int, List[list]] = {}
        self._next_rid = 0
        self.tokens_generated = 0
        self.engine_steps = 0
        self.prefill_buckets = sorted(prefill_buckets) if prefill_buckets else None
        if self.prefill_buckets and self.prefill_buckets[-1] > self.block_size:
            raise ValueError(f"prefill bucket {self.prefill_buckets[-1]} exceeds "
                             f"block_size {self.block_size}")
        self._prefix_max = prefix_cache_entries
        self._prefix_lru: "OrderedDict[tuple, dict]" = OrderedDict()
        self.prefix_cache_hits = 0
        self.prefix_tokens_reused = 0
        self.chunk_prefill = None if chunk_prefill is None else int(chunk_prefill)
        if self.chunk_prefill is not None and not 0 < self.chunk_prefill <= self.block_size:
            raise ValueError(f"chunk_prefill {chunk_prefill} must be in "
                             f"(0, block_size={self.block_size}]")
        self._chunk_state: Dict[int, dict] = {}
        self._layouts: Dict[tuple, List[tuple]] = {}  # (steps, form) -> _steps' outputs
        # an admission's inputs, one host-to-device copy before its body:
        # slot, the feed's base and length, then the prompt zero-padded to
        # the window
        self._adm_in = torch.zeros((_ADM_HEAD + self.block_size,), dtype=torch.long, device=dev)
        self._adm_layouts: Dict[tuple, List[tuple]] = {}  # admission key -> its outputs
        self._graph = self._adm_graph = None
        if cuda_graph:
            # every graph of the engine in one pool: they replay one at a time
            self._graph_pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
            self._graph = self._make_graph()
            self._adm_graph = GraphPerKey(self._admit_rows, dev, generators=(self._gen,),
                                          capture_error_mode="thread_local",
                                          pool=self._graph_pool)

    def _make_graph(self):
        """The captured step: one graph per (steps, picker form), captured
        by a thread of the server next to others (thread-local capture
        errors)."""
        return GraphPerKey(lambda key: self._steps(*key), self.device, generators=(self._gen,),
                           capture_error_mode="thread_local", pool=self._graph_pool)

    def _make_cache(self, cfg, max_batch: int, kv_dtype: torch.dtype) -> Optional[dict]:
        """The per-slot KV pools. A subclass with another cache layout
        (``PagedDecodeEngine``) returns None, so that the dense
        ``max_batch x block_size`` slabs are never allocated."""
        cache = init_decode_cache(cfg, max_batch, kv_dtype, n_views=self._n_views,
                                  device=self.device, n_head=self.n_local_heads)
        del cache["len"]  # the per-row lengths live on the host, ``_lens``
        return cache

    @property
    def n_local_heads(self) -> int:
        """The heads this process's pools hold: its share of a
        tensor-parallel model's, else all."""
        return local_heads(self.model)

    def _agree(self, toks: Tensor) -> Tensor:
        """A tensor-parallel engine's tokens: the model group's first
        process's, broadcast to the others (in place)."""
        return toks if self._tp is None else self._tp.broadcast(toks)

    def _on_admit(self, slot: int, prompt: np.ndarray) -> None:
        """Subclass hook: called after a request's prompt is in ``slot``."""

    # ---------------- multi-LoRA ----------------

    def _init_lora_bank(self, adapters: Dict[str, dict], scale, max_batch: int) -> None:
        names = list(adapters)
        paths = sorted(adapters[names[0]])
        scales = ({nm: float(scale) for nm in names} if not isinstance(scale, dict)
                  else {nm: float(scale.get(nm, 1.0)) for nm in names})
        for nm in names:
            if sorted(adapters[nm]) != paths:
                raise ValueError(f"adapter {nm!r} adapts a different kernel set than "
                                 f"{names[0]!r}; all served adapters must share one path set")
        dev = self.device
        for path in paths:
            node = self.params
            for part in path.split("/"):
                if not isinstance(node, dict) or part not in node:
                    raise ValueError(f"adapter path {path!r} not found in params")
                node = node[part]
            din, r = adapters[names[0]][path]["a"].shape
            dout = adapters[names[0]][path]["b"].shape[1]
            if tuple(getattr(node, "shape", ())) != (din, dout):
                raise ValueError(f"adapter {path!r} factors ({din}, {r})x({r}, {dout}) do not "
                                 f"match kernel shape {tuple(getattr(node, 'shape', ()))}")
            a_stack = [torch.zeros((din, r), device=dev)]
            b_stack = [torch.zeros((r, dout), device=dev)]
            for nm in names:
                fa, fb = adapters[nm][path]["a"], adapters[nm][path]["b"]
                if tuple(fa.shape) != (din, r) or tuple(fb.shape) != (r, dout):
                    raise ValueError(f"adapter {nm!r} path {path!r}: rank/shape differs from "
                                     "the bank (all served adapters must share one rank)")
                a_stack.append(torch.as_tensor(fa, dtype=torch.float32, device=dev))
                b_stack.append(torch.as_tensor(fb, dtype=torch.float32, device=dev) * scales[nm])
            self._lora_bank[path] = (torch.stack(a_stack).detach(), torch.stack(b_stack).detach())
            self._lora_rows[path] = (torch.zeros((max_batch, din, r), device=dev),
                                     torch.zeros((max_batch, r, dout), device=dev))
        self._adapter_idx.update({nm: i + 1 for i, nm in enumerate(names)})

    def _step_params(self) -> dict:
        """The params the batched step reads: each slot's LoRA factor rows
        inserted when the engine has an adapter bank."""
        if not self._lora_bank:
            return self.params
        return lora_params_view(self.params, self._lora_rows)

    def _admit_params(self, slot: Tensor) -> dict:
        """The params of a one-row admission into the slot that ``slot`` (a
        (1,) device index) names: its adapter's factor rows, which
        ``_set_slot_adapter`` wrote."""
        if not self._lora_bank:
            return self.params
        rows = {path: (a.index_select(0, slot), b.index_select(0, slot))
                for path, (a, b) in self._lora_rows.items()}
        return lora_params_view(self.params, rows)

    def _set_slot_adapter(self, slot: int, aid: int) -> None:
        if not self._lora_bank:
            return
        self._slot_adapter[slot] = aid
        for path, (a, b) in self._lora_bank.items():
            ra, rb = self._lora_rows[path]
            ra[slot] = a[aid]
            rb[slot] = b[aid]

    def _bucket_of(self, t0: int) -> Optional[int]:
        """The smallest bucket that holds a ``t0``-token prompt, else None."""
        if self.prefill_buckets and t0 <= self.prefill_buckets[-1]:
            return next(b for b in self.prefill_buckets if b >= t0)
        return None

    def _route(self, t0: int, lcp: int) -> Tuple[str, int]:
        """An admission's route and feed width: a prefix hit's ``t0 - lcp``
        tail padded to the next power of two (JAX's ``g_pad``), else the
        prompt's bucket, else its own length."""
        if lcp:
            return TAIL, 1 << (t0 - lcp - 1).bit_length()
        b = self._bucket_of(t0)
        return (EXACT, t0) if b is None else (BUCKET, b)

    # ---------------- sampling ----------------

    def _lp_of(self, logits: Tensor, toks: Tensor) -> tuple:
        """``(lp, top_vals, top_ids)`` of the emitted tokens when logprobs are
        tracked, else (): the fp32 log-softmax of the raw logits (before
        temperature, penalties, bias and constraint masks)."""
        if not self.logprobs_topk:
            return ()
        lsm = torch.log_softmax(logits.float(), -1)
        lp = lsm.gather(-1, toks[..., None])[..., 0]
        tv, ti = _top_k(lsm, self.logprobs_topk)
        return lp, tv, ti

    def _beam_tops(self, logits: Tensor) -> tuple:
        """Each row's top ``max_beams`` fp32 log-probs ``(vals, ids)`` when
        beams are on, else ()."""
        if not self.max_beams:
            return ()
        return _top_k(torch.log_softmax(logits.float(), -1), self.max_beams)

    @staticmethod
    def _lp_entry(lp_h, tv_h, ti_h, idx: int):
        return (float(lp_h[idx]), [(int(t), float(v)) for t, v in zip(ti_h[idx], tv_h[idx])])

    def _sync_slots(self, adv: Optional[np.ndarray] = None) -> None:
        """Write what host control changed of the per-slot state into the
        device buffers the step reads: the sampling columns, seeds, output
        counts and lengths, and ``adv`` (B,) the rows that advance."""
        self._dsp.sync(np.stack([self._sp[k] for k in _SP]))
        self._dseed.sync(self._slot_seed)
        self._dntok.sync(self._slot_ntok)
        self._dlens.sync(self._lens)
        if adv is not None:
            self._dadv.sync(adv)

    def _cols(self, slot: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """The picker's per-slot device columns (``_SP``, ``seed``,
        ``ntok``) of every slot, or of the one that ``slot`` (a (1,) device
        index) names."""
        sp, seed, ntok = self._dsp.dev, self._dseed.dev, self._dntok.dev
        if slot is not None:
            sp = sp.index_select(1, slot)
            seed, ntok = seed.index_select(0, slot), ntok.index_select(0, slot)
        cols = {k: sp[i] for i, k in enumerate(_SP)}
        cols["seed"], cols["ntok"] = seed, ntok
        return cols

    def _form(self, kept: np.ndarray) -> str:
        """The picker's form for the slots ``kept`` (B,) whose tokens are
        kept, from the host columns."""
        samp = kept & (self._sp["temp"] > 0)
        if not samp.any():
            return GREEDY
        return DRAW if (samp & (self._slot_seed < 0)).any() else SAMPLE

    def _pick(self, logits: Tensor, cols: Dict[str, Tensor], kept: Optional[Tensor], form: str,
              ocounts: Tensor, pseen: Tensor, lbias: Tensor) -> Tensor:
        """The per-row sampler over rows with the columns ``cols``: greedy
        where the temperature is 0, else a draw from ``sampling_dist``'s
        masked distribution by Gumbel noise. Only the rows of ``kept`` (a
        bool tensor; None: all) are sampled; the others, whose tokens are
        thrown away, take the greedy pick. A seeded row's noise is
        ``seeded_gumbel`` of its (seed, ntok); the unseeded rows share one
        (B, V) block from the engine's generator, drawn in the ``DRAW``
        form only (``_form``: an unseeded kept row samples)."""
        if form == GREEDY:  # no sort, no draw
            return self._agree(_penalized(logits, cols, ocounts, pseen, lbias).argmax(-1))
        greedy, order, masked = sampling_dist(logits, cols, ocounts, pseen, lbias)
        seeds = cols["seed"]
        noise = seeded_gumbel(seeds.clamp_min(0), cols["ntok"], masked.shape[1])
        if form == DRAW:
            noise = torch.where(seeds[:, None] >= 0, noise,
                                _gumbel(masked.shape, self._gen, self.device))
        choice = (masked + noise).argmax(-1, keepdim=True)
        sampled = order.gather(-1, choice)[:, 0]
        samp = cols["temp"] > 0
        return self._agree(torch.where(samp if kept is None else samp & kept, sampled, greedy))

    # ---------------- public API ----------------

    def submit(self, prompt, max_new_tokens: int, temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_id: Optional[int] = None, min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None, logit_bias: Optional[dict] = None,
               stop=None, adapter: Optional[str] = None, constraint=None,
               seed: Optional[int] = None, num_beams: Optional[int] = None,
               length_penalty: float = 1.0) -> int:
        """Queue a request: ``prompt`` a 1-D int sequence, 1 <= len <
        block_size. It stops at ``max_new_tokens``, EOS, a ``stop`` match or
        the full window. The options are the JAX engine's
        (``mop_tpu/serving/engine.py:826``): per-request sampling overrides
        (None: the engine's), ``logit_bias`` {token: bias}, ``stop`` (ints
        or token sequences, kept in the result), ``adapter`` (a bank name),
        ``constraint`` (a ``TokenDFA``; needs an ``eos_id``), ``seed`` (in
        [0, 2**31): the request's tokens then depend only on the seed, the
        prompt and the params) and ``num_beams`` / ``length_penalty`` (beam
        search; deterministic, so it takes none of the others)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if not 1 <= prompt.size < self.block_size:
            raise ValueError(f"prompt length {prompt.size} must be in [1, {self.block_size})")
        # ids are checked here: one that reached admission would raise in the
        # thread that drives the engine (the HTTP server's device worker)
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            bad = int(prompt[(prompt < 0) | (prompt >= self._vocab)][0])
            raise ValueError(f"prompt token {bad} outside vocab [0, {self._vocab})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        pick = lambda v, d: d if v is None else v  # noqa: E731
        temp = pick(temperature, self.temperature)
        tk = pick(top_k, self.top_k)
        tp = pick(top_p, self.top_p)
        eos = pick(eos_id, self.eos_id)
        mp = pick(min_p, self.min_p)
        rp = pick(repetition_penalty, self.repetition_penalty)
        pp = pick(presence_penalty, self.presence_penalty)
        fp = pick(frequency_penalty, self.frequency_penalty)
        if temp < 0:
            raise ValueError(f"temperature must be >= 0, got {temp}")
        if tk is not None and tk < 0:
            raise ValueError(f"top_k must be >= 0, got {tk}")
        if tp is not None and not 0.0 < tp <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {tp}")
        if not 0.0 <= mp <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {mp}")
        if rp <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, got {rp}")
        # a negative eos is the explicit "never fires"; above the vocab is a bug
        if eos is not None and int(eos) >= self._vocab:
            raise ValueError(f"eos_id {eos} outside vocab [0, {self._vocab})")
        sp = {"temp": float(temp), "topk": float(tk or 0), "topp": 1.0 if tp is None else float(tp),
              "minp": float(mp), "rep": float(rp), "pres": float(pp), "freq": float(fp)}
        eos_q = -1 if eos is None else int(eos)
        bias_row = None
        if logit_bias:
            bias_row = np.zeros((self._vocab,), np.float32)
            for t, b in logit_bias.items():
                t = int(t)
                if not 0 <= t < self._vocab:
                    raise ValueError(f"logit_bias token {t} outside vocab [0, {self._vocab})")
                bias_row[t] = float(b)
        stops = []
        for s in (stop or ()):
            seq = [int(s)] if np.isscalar(s) else [int(t) for t in s]
            if not seq:
                raise ValueError("empty stop sequence")
            for t in seq:
                if not 0 <= t < self._vocab:
                    raise ValueError(f"stop token {t} outside vocab [0, {self._vocab})")
            stops.append(seq)
        if adapter is not None and adapter not in self._adapter_idx:
            raise ValueError(f"unknown adapter {adapter!r}; engine has "
                             f"{sorted(k for k in self._adapter_idx if k)}")
        aid = self._adapter_idx[adapter]
        if constraint is not None:
            if eos_q < 0:
                raise ValueError("a constrained request needs an eos_id (constraint "
                                 "completion is signalled through EOS)")
            for state, edges in constraint.transitions.items():
                for t in edges:
                    if not 0 <= int(t) < self._vocab:
                        raise ValueError(f"constraint state {state!r} allows token {t} "
                                         f"outside vocab [0, {self._vocab})")
                    if int(t) == eos_q:
                        raise ValueError(f"constraint state {state!r} uses eos_id {eos_q} as a "
                                         "transition token; EOS may only END a constrained "
                                         "output (accepting states)")
        if seed is not None and not 0 <= int(seed) < 2 ** 31:
            raise ValueError(f"seed must be in [0, 2**31), got {seed}")
        seed_q = -1 if seed is None else int(seed)
        nb = None
        if num_beams is not None and int(num_beams) == 1:
            # one beam IS greedy decoding: no engine sampling default leaks in
            if temperature not in (None, 0, 0.0) or top_k is not None \
                    or top_p not in (None, 1.0) or seed is not None:
                raise ValueError("num_beams=1 is deterministic greedy; sampling "
                                 "overrides/seed cannot combine with it")
            sp["temp"] = 0.0
        if num_beams is not None and int(num_beams) != 1:
            nb = int(num_beams)
            if self.logprobs_topk:
                raise ValueError("num_beams on a logprobs-tracking engine is not supported: "
                                 "beams record no per-token logprobs, which would break the "
                                 "results/logprobs 1:1 invariant")
            if not 2 <= nb <= self.max_beams:
                raise ValueError(f"num_beams {nb} needs an engine built with max_beams >= {nb} "
                                 f"(max_beams={self.max_beams})")
            if nb > self._vocab:
                raise ValueError(f"num_beams {nb} exceeds vocab_size {self._vocab}")
            if prompt.size + max_new_tokens > self.block_size:
                raise ValueError("beam search needs t0 + max_new_tokens <= block_size "
                                 f"({prompt.size} + {max_new_tokens} > {self.block_size}): "
                                 "beams cannot retire early row by row")
            if temperature not in (None, 0, 0.0) or top_k is not None \
                    or top_p not in (None, 1.0) or min_p not in (None, 0.0) \
                    or repetition_penalty not in (None, 1.0) \
                    or presence_penalty not in (None, 0.0) \
                    or frequency_penalty not in (None, 0.0) \
                    or logit_bias or stops or adapter is not None \
                    or constraint is not None or seed is not None:
                raise ValueError("beam search is deterministic: sampling overrides, penalties, "
                                 "logit_bias, stop sequences, adapters, constraints, and seeds "
                                 "are not supported with num_beams")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, prompt, max_new_tokens, sp, eos_q, bias_row, stops, aid,
                            constraint, seed_q, nb, float(length_penalty)))
        self._results[rid] = []
        self._done[rid] = False
        if self.logprobs_topk:
            self._logprobs[rid] = []
            self._top_logprobs[rid] = []
        return rid

    @property
    def n_active(self) -> int:
        return sum(r >= 0 for r in self._slot_rid)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def results(self) -> Dict[int, List[int]]:
        return self._results

    @property
    def logprobs(self) -> Dict[int, List[float]]:
        """Each request's emitted-token logprobs, 1:1 with ``results``
        (engines built with ``logprobs_topk > 0``)."""
        return self._logprobs

    @property
    def top_logprobs(self) -> Dict[int, List[list]]:
        """Each emitted token's ``logprobs_topk`` most likely alternatives,
        ``[(token_id, logprob), ...]``, most likely first."""
        return self._top_logprobs

    def is_done(self, rid: int) -> bool:
        return self._done[rid]

    def _bias_mask_row(self, slot: int) -> Optional[np.ndarray]:
        """The slot's additive (vocab,) bias: the user's logit_bias plus the
        constraint state's 0/-inf mask (None if it has neither)."""
        user = self._slot_bias[slot]
        con = self._slot_constraint[slot]
        if con is None:
            return user
        row = mask_row(con, self._slot_cstate[slot], self._vocab, int(self._slot_eos[slot]))
        return row if user is None else row + user

    def _set_bias_row(self, slot: int) -> None:
        row = self._bias_mask_row(slot)
        if row is None:
            self._lbias[slot] = 0.0
        else:
            self._lbias[slot] = torch.from_numpy(np.asarray(row, np.float32)).to(self.device)

    def _emit_token(self, emitted: Dict[int, List[int]], slot: int, rid: int, tok: int,
                    new_len: int, lp=None) -> bool:
        """Record one emitted token; retire the slot on EOS, a stop match,
        the full window or the budget. Returns whether the request lives on.
        ``lp``: (logprob, [(tok, logprob), ...]), which every emit path
        supplies when logprobs are tracked."""
        self.tokens_generated += 1
        self._slot_ntok[slot] += 1  # the seeded stream's next position
        res = self._results[rid]
        res.append(tok)
        if self.logprobs_topk:
            if lp is None:
                raise RuntimeError("logprob tracking is on but an emit path supplied no "
                                   "logprob (results/logprobs would desynchronize)")
            self._logprobs[rid].append(lp[0])
            self._top_logprobs[rid].append(lp[1])
        emitted.setdefault(rid, []).append(tok)
        self._budget[slot] -= 1
        hit_eos = tok == self._slot_eos[slot]
        hit_stop = any(len(res) >= len(sq) and res[-len(sq):] == sq
                       for sq in self._slot_stops[slot])
        if hit_eos or hit_stop or new_len >= self.block_size or self._budget[slot] <= 0:
            self._slot_rid[slot] = -1
            self._lens[slot] = 0  # a free slot carries no prefix
            self._slot_constraint[slot] = None
            self._slot_cstate[slot] = None
            self._done[rid] = True
            return False
        con = self._slot_constraint[slot]
        if con is not None:
            ns = con.advance(self._slot_cstate[slot], tok)
            if ns is None:  # the mask bans every illegal edge: unreachable
                raise RuntimeError(f"constrained slot {slot} emitted banned token {tok} in "
                                   f"state {self._slot_cstate[slot]!r}")
            self._slot_cstate[slot] = ns
            self._set_bias_row(slot)
        return True

    def step(self, n_tokens: int = 1) -> Dict[int, List[int]]:
        """One engine iteration: admit whatever fits (an admission emits the
        prefill's first token; a request whose budget is 1 or whose first
        token is EOS completes there), feed one chunk of each chunked
        prefill, then advance every live row ``n_tokens`` tokens. Returns
        ``{rid: [tokens]}``.

        ``n_tokens = k`` gives the tokens of k ``step()`` calls for every
        row (greedy, seeded and unseeded sampled, constrained), admission
        apart: it happens once per call. A row that retires within the k
        steps stops there. Eagerly, and under ``cuda_graph`` while a
        constrained row or a beam group is live, that is k single steps
        with host control between; otherwise, under ``cuda_graph``, one
        replay of a k-step graph (``_burst_len``)."""
        self.engine_steps += 1
        emitted: Dict[int, List[int]] = {}
        emit = lambda *a: self._emit_token(emitted, *a)  # noqa: E731
        while self._queue:
            adm = self._admit_one()
            if adm is None:
                break
            if adm[2] is not None:
                emit(*adm)
        for slot in list(self._chunk_state):
            fin = self._chunk_advance(slot)
            if fin is not None:
                emit(*fin)
        left = max(1, int(n_tokens))
        with torch.no_grad():
            while left > 0:
                active = [s for s, r in enumerate(self._slot_rid)
                          if r >= 0 and s not in self._chunk_state]
                if not active:
                    break
                k = self._burst_len(left, active)
                if k > 1:
                    self._decode_burst(active, k, emit)
                else:
                    self._decode_once(active, emit)
                left -= k
        for rid, toks_f in self._beam_finalized:
            emitted.setdefault(rid, []).extend(toks_f)
        self._beam_finalized.clear()
        return emitted

    def _burst_len(self, n_tokens: int, active: List[int]) -> int:
        """The steps the next replay takes: under ``cuda_graph`` with no
        constrained row and no beam group live, ``n_tokens`` capped at the
        largest headroom (budget, window) of the rows, as JAX's
        ``_multi_k``, so that once the burst ends every row has retired or
        had them all; else 1."""
        if self._graph is None or n_tokens < 2 or self._beam_groups or any(
                self._slot_constraint[s] is not None for s in active):
            return 1
        headroom = max(min(int(self._budget[s]), self.block_size - int(self._lens[s]))
                       for s in active)
        return min(n_tokens, max(headroom, 1))

    def _run(self, k: int, adv: np.ndarray):
        """k batched steps on the device of the rows ``adv`` (B,), the
        others held; one replay under ``cuda_graph``, its output one buffer.
        Returns the picker's form and the host copies, in one
        device-to-host copy, of the tokens
        (k, B) and the extras (k, ...); the device lengths and output
        positions are recorded as advanced (rows at the window's end held)."""
        self._sync_slots(adv)
        form = self._form(adv)
        lens0, ntok0 = self._lens.copy(), self._slot_ntok.copy()
        flat = self._graph((k, form)) if self._graph is not None else self._steps(k, form)
        toks, *rest = _unpack(flat.cpu().numpy(), self._layouts[(k, form)])
        steps = np.where(adv, np.minimum(lens0 + k, self.block_size) - lens0, 0)
        self._dlens.advanced(lens0 + steps)
        self._dntok.advanced(ntok0 + steps)
        return form, toks, rest

    def _steps(self, k: int, form: str) -> Tensor:
        """``_advance`` k times, its outputs stacked (k, ...) and packed for
        the one copy to the host (``_pack``; their layout recorded by the
        Python run that a graph captures): what a graph of k steps captures
        (JAX's ``_mstep`` scan)."""
        outs = [torch.stack(o) for o in zip(*(self._advance(form) for _ in range(k)))]
        self._layouts[(k, form)] = _layout(*outs)
        return _pack(*outs)

    def _advance(self, form: str) -> tuple:
        """One batched step in place over the device state: each row's token
        at its device length, the picker in ``form``; the rows of ``adv``
        below the window's end advance (token, length, output position,
        output-token counts), the others are held, their token kept and
        their write at their length overwritten by their next real feed (a
        held row's length masks it out). Returns (tokens, *``_lp_of``,
        *``_beam_tops``)."""
        lens, tokens = self._dlens.dev, self._tokens
        go = self._dadv.dev & (lens < self.block_size)
        logits = self._slot_logits(tokens, lens)
        nxt = self._pick(logits, self._cols(), go, form, self._ocounts, self._pseen, self._lbias)
        nxt = torch.where(go, nxt, tokens)
        tokens.copy_(nxt)
        lens.add_(go)
        self._dntok.dev.add_(go)
        self._ocounts.scatter_add_(1, nxt[:, None], go[:, None].to(torch.int32))
        return (nxt,) + self._lp_of(logits, nxt) + self._beam_tops(logits)

    def _decode_once(self, active: List[int], emit) -> None:
        """One batched decode step over the pool. Rows not in ``active``
        (free slots, chunk-pending prompts) are held (``_advance``)."""
        adv = np.zeros((self.max_batch,), bool)
        adv[active] = True
        _, toks, rest = self._run(1, adv)
        toks = toks[0]
        rest = [r[0] for r in rest]
        lph = rest[:3] if self.logprobs_topk else None
        bth = rest[3:] if self.logprobs_topk else rest
        self._lens[active] += 1
        beam_slots = {s for g in self._beam_groups.values() for s in g["slots"]}
        for s in active:
            if s in beam_slots:
                self._slot_ntok[s] += 1  # as the device counted it
                continue
            lp = self._lp_entry(*lph, s) if lph is not None else None
            emit(s, self._slot_rid[s], int(toks[s]), int(self._lens[s]), lp)
        if self._beam_groups:
            perm, newtoks = self._beam_step_update(bth[0], bth[1], toks)
            self._permute_rows(perm)
            self._tokens.copy_(torch.from_numpy(newtoks))

    def _decode_burst(self, rows: List[int], k: int, emit) -> None:
        """k batched steps of ``rows`` in one replay, the others held; then
        the host emits them step by step as k ``_decode_once`` calls would.
        A row that retires within the burst kept advancing on the device
        (its tokens thrown away, its writes in its own rows, pages or the
        scratch page, its length held at the window's end). The engine's
        generator drew its (B, V) block at every step of a ``DRAW`` burst,
        where single steps stop drawing once no unseeded sampler lives: it
        is left where they leave it."""
        adv = np.zeros((self.max_batch,), bool)
        adv[rows] = True
        mark = _generator_mark(self._gen)
        form, toks, rest = self._run(k, adv)
        lph = rest[:3] if self.logprobs_topk else None
        live, drew = list(rows), 0
        for j in range(k):
            if not live:
                break
            drew += form == DRAW and any(self._sp["temp"][s] > 0 and self._slot_seed[s] < 0
                                         for s in live)
            for s in list(live):
                self._lens[s] += 1
                lp = self._lp_entry(lph[0][j], lph[1][j], lph[2][j], s) if lph else None
                if not emit(s, self._slot_rid[s], int(toks[j, s]), int(self._lens[s]), lp):
                    live.remove(s)
        if form == DRAW:
            _rewind(self._gen, mark, k, drew, (self.max_batch, self._vocab))

    def _slot_logits(self, tokens: Tensor, lens: Tensor) -> Tensor:
        """The cache access a subclass replaces (``PagedDecodeEngine``)."""
        return decode_step_rows(self.model, self._step_params(), self._cache, tokens, lens)[0]

    def _permute_rows(self, perm: np.ndarray) -> None:
        """Slot s takes slot ``perm[s]``'s cache rows, for the slots that
        move. The parents' rows are gathered (a copy) before any is written,
        so that no row is read after it was overwritten."""
        moved = np.nonzero(perm != np.arange(self.max_batch))[0]
        if moved.size:
            dst = torch.from_numpy(moved).to(self.device)
            src = torch.from_numpy(perm[moved]).to(self.device)
            for key in self._pool_keys:
                self._cache[key][:, dst] = self._cache[key].index_select(1, src)

    def _zero_dead_lens(self, dead) -> None:
        """Zero retired slots' lengths, so that a free slot never carries a
        stale prefix."""
        if len(dead):
            self._lens[np.asarray(dead, np.int64)] = 0

    def run(self, n_tokens: int = 1) -> Dict[int, List[int]]:
        """Step until every queued and live request completes; all results.
        ``n_tokens`` > 1 goes to ``step`` (``SpecDecodeEngine``'s takes none:
        its step advances up to gamma + 1 tokens already)."""
        while self._queue or self.n_active:
            if n_tokens == 1:
                self.step()
            else:
                self.step(n_tokens=n_tokens)
        return {rid: list(toks) for rid, toks in self._results.items()}

    def cancel(self, rid: int) -> bool:
        """Cancel a request: queued, it never reaches the device; active, its
        slot (or its beam group's slots) is freed and its length zeroed.
        Tokens already emitted stay in ``results``. False if ``rid`` is
        unknown or already finished."""
        if self._done.get(rid, True):
            return False
        for i, item in enumerate(self._queue):
            if item[0] == rid:
                del self._queue[i]
                self._done[rid] = True
                return True
        if rid in self._beam_groups:
            g = self._beam_groups.pop(rid)
            for s in g["slots"]:
                self._slot_rid[s] = -1
            self._zero_dead_lens(list(g["slots"]))
            self._done[rid] = True
            return True
        slot = self._slot_rid.index(rid)
        self._slot_rid[slot] = -1
        self._slot_constraint[slot] = None
        self._slot_cstate[slot] = None
        self._chunk_state.pop(slot, None)
        self._zero_dead_lens([slot])
        self._done[rid] = True
        return True

    # ---------------- internals ----------------

    def _set_slot_sampling(self, slot: int, sp: dict, eos: int, seed: int) -> None:
        for k in _SP:
            self._sp[k][slot] = sp[k]
        self._slot_eos[slot] = eos
        self._slot_seed[slot] = seed

    def _admit_one(self):
        """Admit the next queued request into a free slot (a one-row prefill
        pasted into the pool). Returns (slot, rid, tok0, prompt_len, lp0), tok0
        None while a chunked prefill feeds, or None if no slot is free."""
        if not self._queue:
            return None
        if self._queue[0][10] is not None:  # a beam request at the head
            return self._admit_beam()
        try:
            slot = self._slot_rid.index(-1)
        except ValueError:
            return None
        (rid, prompt, max_new, sp, eos, bias_row, stops, aid, con, seed, _nb,
         _lpen) = self._queue.popleft()
        t0 = int(prompt.size)
        self._set_slot_sampling(slot, sp, eos, seed)
        self._slot_ntok[slot] = len(self._results[rid])
        entry, lcp = self._prefix_lookup(prompt, aid)
        self._set_slot_adapter(slot, aid)
        self._slot_bias[slot] = bias_row
        self._slot_stops[slot] = stops
        self._slot_constraint[slot] = con
        self._slot_cstate[slot] = None if con is None else con.init_state()
        self._set_bias_row(slot)
        if entry is not None:  # the entry's rows, one copy a pool key
            for key in self._pool_keys:
                self._cache[key][:, slot] = entry[key]
            self.prefix_cache_hits += 1
            self.prefix_tokens_reused += lcp
        self._slot_rid[slot] = rid
        self._budget[slot] = max_new  # tokens still to emit, tok0 included
        if self.chunk_prefill is not None and t0 - lcp > self.chunk_prefill:
            # reserve the slot and feed the prompt one chunk per step
            self._lens[slot] = lcp
            self._chunk_state[slot] = {"rid": rid, "prompt": prompt, "fed": lcp, "t0": t0,
                                       "aid": aid}
            return slot, rid, None, t0, None
        route, width = self._route(t0, lcp)
        tok0, lp0 = self._admit_run(route, width, slot, prompt, lcp, t0 - lcp)
        self._prefix_store(prompt, slot, aid)
        self._on_admit(slot, prompt)
        return slot, rid, tok0, t0, lp0

    def _chunk_advance(self, slot: int):
        """Feed the next chunk of ``slot``'s pending prompt; after the last,
        pick the request's first token and hand the slot to the decode step:
        (slot, rid, tok0, t0, lp0) then, None while feeding."""
        st = self._chunk_state[slot]
        fed, t0 = st["fed"], st["t0"]
        g = min(self.chunk_prefill, t0 - fed)
        first = self._admit_run(CHUNK, self.chunk_prefill, slot, st["prompt"], fed, g,
                                pick=fed + g == t0)
        st["fed"] = fed + g
        if first is None:
            return None
        self._prefix_store(st["prompt"], slot, st["aid"])
        self._on_admit(slot, st["prompt"])
        del self._chunk_state[slot]
        return (slot, st["rid"]) + first[:1] + (t0,) + first[1:]

    def _admit_key(self, t0: int) -> tuple:
        """What a subclass's admission body adds to its key (the speculative
        engine's draft bucket)."""
        return ()

    def _admit_run(self, route: str, width: int, slot: int, prompt: np.ndarray, base: int,
                   g: int, pick: bool = True):
        """Feed ``prompt[base:base + g]`` into ``slot`` by ``route`` at feed
        width ``width`` (``_admit_rows``): one host-to-device copy of its
        inputs, the per-slot mirrors synced (the sampling columns the pick
        reads) and its picker form read on the host, then the body, one
        replay under ``cuda_graph`` (the exact route eager), and, with
        ``pick``, one device-to-host copy of the first token and its
        logprob entry: (tok0, lp0); None without ``pick``."""
        row = np.zeros((_ADM_HEAD + self.block_size,), np.int64)
        row[:_ADM_HEAD] = slot, base, g
        row[_ADM_HEAD:_ADM_HEAD + prompt.size] = prompt
        self._adm_in.copy_(torch.from_numpy(row))
        self._sync_slots()
        form = None
        if pick:
            kept = np.zeros((self.max_batch,), bool)
            kept[slot] = True
            form = self._form(kept)
        key = (route, width, form) + self._admit_key(base + g)
        with torch.no_grad():
            if self._adm_graph is not None and route != EXACT:
                flat = self._adm_graph(key)
            else:
                flat = self._admit_rows(key)
        self._lens[slot] = base + g
        self._dlens.advanced(self._lens)
        if not pick:
            return None
        tok0, *lph = _unpack(flat.cpu().numpy(), self._adm_layouts[key])
        return int(tok0[0]), (self._lp_entry(*lph, 0) if lph else None)

    def _admit_rows(self, key: tuple) -> Optional[Tensor]:
        """One admission in place over ``_adm_in`` (the slot a (1,) device
        index, the base and the fed count g 0-dim device scalars), for
        ``key = (route, width, form, *more)``: the feed, a prefill
        (``prefill`` on the exact route; ``prefill_padded`` to the
        bucket, its live length g on the device) pasted into the slot
        (``_paste``), or ``width`` prompt tokens from ``base`` appended to
        the slot's rows (``_feed_rows``: a prefix hit's tail or a chunk, the
        pads past g written past the live rows); the slot's device length
        ``base + g``; a subclass's ``_admit_more``; then, with a picker
        ``form``, the first token by ``_pick`` over the slot's columns,
        bias row, output counts (the prompt's last ``ntok`` tokens, the
        emitted count ``_sync_slots`` wrote to the slot's mirror) and
        prompt mask (its first ``base + g``), ``_lp_of``'s extras, and the
        slot's token, counts (the first token counted) and mask written.
        Returns the first token and extras packed for the copy to the host
        (their layout in ``_adm_layouts``), or None without a form: the
        eager route and the body a graph of ``key`` captures (JAX's
        ``_adm_padded``, ``_adm_chunk``, ``_chunk_feed`` + ``_chunk_tok0``)."""
        route, width, form, *more = key
        inp = self._adm_in
        slot, base, g = inp[0:1], inp[1], inp[2]
        prompt = inp[_ADM_HEAD:][None]  # (1, block)
        t_end = base + g
        params = self._admit_params(slot)
        if route in (EXACT, BUCKET):
            if route == EXACT:
                logits, pc = prefill(self.model, params, prompt[:, :width], kv_dtype=self.kv_dtype)
            else:
                logits, pc = prefill_padded(self.model, params, prompt[:, :width], g,
                                            kv_dtype=self.kv_dtype)
            self._paste(pc, slot)
        else:
            at = (base + torch.arange(width, device=inp.device)).clamp_max(self.block_size - 1)
            logits = self._feed_rows(slot, params, prompt.index_select(1, at), base, g)
        self._dlens.dev.index_copy_(0, slot, t_end.reshape(1))
        self._admit_more(prompt, t_end, slot, *more)
        if form is None:
            return None
        # the prompt's columns: a prefill's width, a feed's whole window
        span = width if route in (EXACT, BUCKET) else self.block_size
        pos = torch.arange(span, device=inp.device)
        live = (pos < t_end).to(torch.int32)[None]
        cols = self._cols(slot)  # its ntok: a re-admission's emitted tokens, the prompt's last
        seen = self._ocounts.new_zeros((1, self._vocab)).scatter_add_(
            1, prompt[:, :span], live) > 0
        oc = self._ocounts.new_zeros((1, self._vocab)).scatter_add_(
            1, prompt[:, :span], live * (pos >= t_end - cols["ntok"]))
        tok0 = self._pick(logits, cols, None, form, oc, seen, self._lbias.index_select(0, slot))
        lpx = self._lp_of(logits, tok0)
        self._tokens.index_copy_(0, slot, tok0)
        self._ocounts.index_copy_(0, slot, oc.scatter_add(1, tok0[:, None], live[:, :1]))
        self._pseen.index_copy_(0, slot, seen)
        self._adm_layouts[key] = _layout(tok0, *lpx)
        return _pack(tok0, *lpx)

    def _paste(self, pc: dict, slot: Tensor) -> None:
        """A one-row prefill's cache ``pc`` into the slot that ``slot`` (a
        (1,) device index) names: the cache access a subclass replaces."""
        for key in self._pool_keys:
            self._cache[key].index_copy_(1, slot, pc[key].to(self._cache[key].dtype))

    def _feed_rows(self, slot: Tensor, params: dict, toks: Tensor, base: Tensor,
                   g: Tensor) -> Tensor:
        """Append the (1, G) ``toks`` to the slot's rows from position
        ``base``, in place (``decode_rows`` over ``OneSlotRows``); the
        logits (1, V) after its ``g``-th token."""
        logits = decode_rows(self.model, params, OneSlotRows(self._cache, slot), toks,
                             base.reshape(1))
        return logits.index_select(1, (g - 1).reshape(1))[:, 0]

    def _admit_more(self, prompt: Tensor, t0: Tensor, slot: Tensor, *more) -> None:
        """Subclass hook inside the admission's body (``_admit_key``'s
        entries in ``more``)."""

    # ---------------- beam groups ----------------

    def _admit_beam(self):
        """Admit the beam request at the queue head into k free slots (one
        prefill pasted into all k, the top k first tokens). A beam request
        emits nothing until it finalizes; None if fewer than k slots are free
        (head-of-line wait)."""
        free = [s for s, r in enumerate(self._slot_rid) if r < 0]
        nb = self._queue[0][10]
        if len(free) < nb:
            return None
        (rid, prompt, max_new, _sp, eos, _bias, _stops, _aid, _con, _seed, nb,
         lpen) = self._queue.popleft()
        slots = free[:nb]
        t0 = int(prompt.size)
        dev = self.device
        with torch.no_grad():
            logits, pc = prefill(self.model, self.params, torch.from_numpy(prompt[None]).to(dev),
                                 kv_dtype=self.kv_dtype)
            idx = torch.tensor(slots, device=dev)
            for key in self._pool_keys:
                self._cache[key][:, idx] = pc[key][:, 0:1].to(self._cache[key].dtype)
            scores, toks = _top_k(torch.log_softmax(logits[0].float(), -1), nb)
            self._tokens[idx] = toks
        scores_h, toks_h = _to_host(scores, toks)
        alive = np.ones((nb,), bool) if eos < 0 else (toks_h != eos)
        greedy = {"temp": 0.0, "topk": 0.0, "topp": 1.0, "minp": 0.0, "rep": 1.0, "pres": 0.0,
                  "freq": 0.0}
        for s in slots:
            self._slot_rid[s] = rid
            self._set_slot_sampling(s, greedy, -1, -1)  # the host's hypotheses own EOS
            self._slot_stops[s] = []
            self._slot_constraint[s] = None
            self._slot_cstate[s] = None
            self._slot_bias[s] = None
            self._budget[s] = max_new
            self._lens[s] = t0
            self._lbias[s] = 0.0
            self._ocounts[s] = 0
            self._pseen[s] = False
        self._beam_groups[rid] = {
            "slots": slots, "k": nb, "lenpen": float(lpen),
            "scores": np.asarray(scores_h, np.float32), "alive": alive,
            "hyp_len": np.ones((nb,), np.int32), "bufs": [[int(t)] for t in toks_h],
            "eos": None if eos < 0 else eos, "pad": 0 if eos < 0 else eos,
            "budget": max_new - 1}
        if max_new <= 1 or not alive.any():
            self._finalize_beam(rid)
        return slots[0], rid, None, t0, None

    def _finalize_beam(self, rid: int) -> None:
        """Rank the group's hypotheses (score / length ** length_penalty),
        record the best one as the result and free the slots, their lengths
        zeroed as ``cancel`` zeroes them."""
        g = self._beam_groups.pop(rid)
        norm = np.maximum(g["hyp_len"].astype(np.float32), np.float32(1.0)) \
            ** np.float32(g["lenpen"])
        best = int(np.argsort(-(g["scores"] / norm), kind="stable")[0])
        toks = g["bufs"][best][:int(g["hyp_len"][best])]
        self._results[rid] = [int(t) for t in toks]
        self.tokens_generated += len(toks)
        self._done[rid] = True
        for s in g["slots"]:
            self._slot_rid[s] = -1
        self._zero_dead_lens(list(g["slots"]))
        self._beam_finalized.append((rid, self._results[rid]))

    def _beam_step_update(self, btv, bti, toks_host) -> Tuple[np.ndarray, np.ndarray]:
        """The host's beam selection after a step: each live group keeps the
        top k of its k x k candidates (exact: a parent's own k best bound the
        global top k; ties broken on the parent-major flat index, as
        ``generate_beam``'s top-k). Returns (perm, next tokens): slot
        ``perm[s]``'s rows move to slot s."""
        perm = np.arange(self.max_batch)
        newtoks = np.asarray(toks_host, np.int64).copy()
        for rid in list(self._beam_groups):
            g = self._beam_groups[rid]
            slots, k = g["slots"], g["k"]
            V = self._vocab
            cand = []  # (-score, flat index, parent, token)
            for j, s in enumerate(slots):
                if g["alive"][j]:
                    for r in range(k):
                        tok = int(bti[s][r])
                        cand.append((-(g["scores"][j] + np.float32(btv[s][r])), j * V + tok, j,
                                     tok))
                else:
                    cand.append((-g["scores"][j], j * V + g["pad"], j, g["pad"]))
            cand.sort()
            top = cand[:k]
            parents = [c[2] for c in top]
            toks = [c[3] for c in top]
            p_alive = np.asarray([g["alive"][p] for p in parents], bool)
            g["alive"] = np.asarray([pa and (g["eos"] is None or t != g["eos"])
                                     for pa, t in zip(p_alive, toks)], bool)
            g["bufs"] = [g["bufs"][p] + [t if pa else g["pad"]]
                         for p, t, pa in zip(parents, toks, p_alive)]
            g["hyp_len"] = np.asarray([g["hyp_len"][p] + (1 if pa else 0)
                                       for p, pa in zip(parents, p_alive)], np.int32)
            g["scores"] = np.asarray([-c[0] for c in top], np.float32)
            g["budget"] -= 1
            for i, (p, t) in enumerate(zip(parents, toks)):
                perm[slots[i]] = slots[p]
                newtoks[slots[i]] = t if p_alive[i] else g["pad"]
            if g["budget"] <= 0 or not g["alive"].any():
                self._finalize_beam(rid)
        return perm, newtoks

    # ---------------- prefix cache ----------------

    def _prefix_lookup(self, prompt: np.ndarray, aid: int = 0):
        """The longest shared prefix between ``prompt`` and an entry computed
        under the same adapter: (entry, lcp) with 1 <= lcp <= len(prompt) - 1
        (one tail token at least gives the admission logits), or (None, 0)."""
        if not self._prefix_max:
            return None, 0
        best_key, best_lcp = None, 0
        for key, entry in self._prefix_lru.items():
            if entry["aid"] != aid:
                continue
            toks = entry["tokens"]
            m = min(toks.size, prompt.size - 1)
            if m <= best_lcp:
                continue
            neq = np.nonzero(toks[:m] != prompt[:m])[0]
            lcp = int(neq[0]) if neq.size else m
            if lcp > best_lcp:
                best_key, best_lcp = key, lcp
        if best_lcp < 1:
            return None, 0
        self._prefix_lru.move_to_end(best_key)
        return self._prefix_lru[best_key], best_lcp

    def _prefix_store(self, prompt: np.ndarray, slot: int, aid: int = 0) -> None:
        """LRU-store a copy of ``slot``'s rows for this prompt, keyed by
        (adapter id, tokens). The entry owns its rows: a later request in the
        slot does not change them."""
        if not self._prefix_max:
            return
        key = (aid, prompt.tobytes())
        if key in self._prefix_lru:
            self._prefix_lru.move_to_end(key)
            return
        entry = {"tokens": prompt.copy(), "aid": aid}
        entry.update({k: self._cache[k][:, slot].clone() for k in self._pool_keys})
        self._prefix_lru[key] = entry
        while len(self._prefix_lru) > self._prefix_max:
            self._prefix_lru.popitem(last=False)


class SpecDecodeEngine(DecodeEngine):
    """Continuous batching with speculative decoding (greedy only), the port
    of JAX's ``SpecDecodeEngine`` (``mop_tpu/serving/engine.py:1718``).

    Every live slot advances 1 to gamma + 1 tokens an engine step: a draft
    model proposes gamma tokens per row from its own slot pool (filled at
    admission by a prefill of the prompt), the target verifies every row at
    every position in one ``decode_chunk_rows`` call, and each row keeps its
    longest matching prefix plus the target's correction token. Every
    emitted token is the target's argmax given the same prefix, so the
    tokens are ``DecodeEngine``'s for any draft (up to the verify chunk's
    summation order, as ``decode_chunk``'s); the draft changes only the
    number of target passes. A slot retires when the next round would not
    fit the window (``len + gamma + 1 > block_size``): budget that close to
    the edge is truncated, as in JAX's engine. The pools are fp32 or bf16
    (int8 raises, as JAX's). ``drafts_proposed`` / ``drafts_accepted``
    count the draft tokens of every round and those the target kept.

    The round reads the lengths and the live rows from the engine's device
    buffers (``_dlens``, ``_dadv``), written where host control changed a
    slot; it advances the lengths itself. ``cuda_graph=True`` (a CUDA device; neither model
    tensor-parallel) runs the round (``_round``: the draft steps, the
    verify, the accepted counts, the corrections and, with
    ``logprobs_topk``, the logprob extras) as one CUDA graph, and a
    bucketed or prefix-hit admission as one replay of the dense engine's
    admission graph with the draft's bucketed prefill of the whole prompt
    inside it (``_admit_more``, JAX's ``_d_adm_padded``), keyed by the
    draft's bucket too; a prompt past the last bucket is admitted eagerly
    into both pools, as the dense engine's. Host control stays eager.
    """

    _captures_step = True

    def __init__(self, model, params, draft_model, draft_params, max_batch: int = 8,
                 gamma: int = 4, eos_id: Optional[int] = None, cache_sharding=None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefix_cache_entries: int = 0, kv_dtype: torch.dtype = torch.float32,
                 logprobs_topk: int = 0, cuda_graph: bool = False):
        _no_int8_pools(kv_dtype)
        super().__init__(model, params, max_batch=max_batch, eos_id=eos_id, temperature=0.0,
                         cache_sharding=cache_sharding, prefill_buckets=prefill_buckets,
                         prefix_cache_entries=prefix_cache_entries, kv_dtype=kv_dtype,
                         logprobs_topk=logprobs_topk, cuda_graph=cuda_graph)
        if cuda_graph:
            require_graph("SpecDecodeEngine (draft)", self.device,
                          tensor_parallel=decode_split_of(draft_model))
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.draft_model = draft_model
        self.draft_params = decode_params(draft_model) if draft_params is None else draft_params
        self.gamma = int(gamma)
        dcfg = draft_model.config
        if dcfg.block_size < self.block_size:
            raise ValueError(f"draft block_size {dcfg.block_size} must be >= target's "
                             f"{self.block_size}")
        # the draft's slot pool; its lengths are the target's, ``_lens``
        self._dcache = init_decode_cache(dcfg, max_batch, kv_dtype,
                                         n_views=model_n_views(draft_model), device=self.device)
        del self._dcache["len"]
        self._d_keys = _pool_keys(self._dcache)
        self.drafts_proposed = 0  # gamma per live row and round
        self.drafts_accepted = 0

    def submit(self, prompt, max_new_tokens: int, temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_id: Optional[int] = None, min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None, logit_bias: Optional[dict] = None,
               stop=None, adapter: Optional[str] = None, constraint=None,
               seed: Optional[int] = None) -> int:
        """Greedy only: the verify compares the target's argmax with the
        draft's, which penalties, a bias, a constraint or an adapter (the
        draft has none) would break, so per-request overrides other than
        ``eos_id`` and ``stop`` are rejected. ``seed`` is accepted and
        ignored: greedy decoding is deterministic already."""
        if temperature not in (None, 0, 0.0) or top_k is not None \
                or top_p not in (None, 1.0) or min_p not in (None, 0.0) \
                or repetition_penalty not in (None, 1.0) \
                or presence_penalty not in (None, 0.0) or logit_bias \
                or frequency_penalty not in (None, 0.0) \
                or adapter is not None or constraint is not None:
            raise ValueError("SpecDecodeEngine is greedy-only; per-request temperature/top_k/"
                             "top_p/min_p/penalties/logit_bias/adapter/constraint are not "
                             "supported (use DecodeEngine)")
        return super().submit(prompt, max_new_tokens, eos_id=eos_id, stop=stop)

    def _admit_key(self, t0: int) -> tuple:
        """The draft's prefill bucket (None: past the last)."""
        return (self._bucket_of(t0),)

    def _admit_more(self, prompt: Tensor, t0: Tensor, slot: Tensor, *more) -> None:
        """The draft's prefill of the whole prompt padded to its bucket
        (JAX's ``_d_adm_padded``), inside the target's admission body: one
        replay admits both."""
        width = more[0]
        if width is None:
            return
        _, pc = prefill_padded(self.draft_model, self.draft_params, prompt[:, :width], t0,
                               kv_dtype=self.kv_dtype)
        for key in self._d_keys:
            self._dcache[key].index_copy_(1, slot, pc[key].to(self._dcache[key].dtype))

    def _on_admit(self, slot: int, prompt: np.ndarray) -> None:
        """The draft's exact prefill of a prompt past the last bucket into its
        slot, eagerly, as the target's (a bucketed prompt's ran in the
        admission's body, ``_admit_more``)."""
        if self._bucket_of(prompt.size) is not None:
            return
        with torch.no_grad():
            _, pc = prefill(self.draft_model, self.draft_params,
                            torch.from_numpy(prompt[None]).to(self.device), kv_dtype=self.kv_dtype)
            for key in self._d_keys:
                self._dcache[key][:, slot] = pc[key][:, 0].to(self._dcache[key].dtype)

    def _make_graph(self):
        return StepGraph(self._round, self.device, capture_error_mode="thread_local",
                         pool=self._graph_pool)

    def _round(self):
        """One speculative round over every row, in place: gamma greedy
        draft steps and one more, whose rows the rows that accept every
        draft need (the others get a row past their length, overwritten by
        their next write); then the target's verify over [token, drafts].
        The tokens become the corrections and the live rows' device lengths
        advance by the accepted counts plus one. Returns the emitted tokens
        (B, gamma + 1), the accepted counts (B,) and ``_lp_of``'s extras."""
        g = self.gamma
        lens = self._dlens.dev
        tok, drafts = self._tokens, []
        for j in range(g):
            logits, _ = decode_step_rows(self.draft_model, self.draft_params, self._dcache, tok,
                                         lens + j)
            tok = logits.argmax(-1)
            drafts.append(tok)
        decode_step_rows(self.draft_model, self.draft_params, self._dcache, tok, lens + g)
        drafts = torch.stack(drafts, 1)  # (B, gamma)
        chunk = torch.cat([self._tokens[:, None], drafts], 1)
        logits, _ = decode_chunk_rows(self.model, self.params, self._cache, chunk, lens)
        tpred = logits.argmax(-1)  # (B, gamma + 1)
        n_acc = (tpred[:, :g] == drafts).long().cumprod(1).sum(1)
        corr = tpred.gather(1, n_acc[:, None])
        i = torch.arange(g + 1, device=lens.device)[None, :]
        emit = torch.where(i < n_acc[:, None], torch.cat([drafts, drafts[:, -1:]], 1), corr)
        extras = self._lp_of(logits, emit)
        self._tokens.copy_(corr[:, 0])
        lens.copy_(torch.where(self._dadv.dev, lens + n_acc + 1, torch.zeros_like(lens)))
        return (emit, n_acc, *extras)

    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: admit, retire the rows whose next round would
        overflow the window, then advance every live row by 1 to gamma + 1
        tokens with one draft pass and one target verify."""
        self.engine_steps += 1
        emitted: Dict[int, List[int]] = {}
        while self._queue:
            adm = self._admit_one()
            if adm is None:
                break
            self._emit_token(emitted, *adm)
        for s, rid in enumerate(self._slot_rid):
            if rid >= 0 and int(self._lens[s]) + self.gamma + 1 > self.block_size:
                self._slot_rid[s] = -1
                self._done[rid] = True
                self._zero_dead_lens([s])
        active = [s for s, r in enumerate(self._slot_rid) if r >= 0]
        if not active:
            return emitted
        live = np.zeros((self.max_batch,), bool)
        live[active] = True
        self._sync_slots(live)
        with torch.no_grad():
            out = self._graph() if self._graph is not None else self._round()
            et, na, *lph = _to_host(*out)
        self._lens = np.where(live, self._lens + na + 1, 0)
        self._dlens.advanced(self._lens)
        self.drafts_proposed += self.gamma * len(active)
        self.drafts_accepted += int(na[active].sum())
        for s in active:
            rid = self._slot_rid[s]
            n_emit = int(na[s]) + 1
            base = int(self._lens[s]) - n_emit
            for j in range(n_emit):
                lp = self._lp_entry(lph[0][s], lph[1][s], lph[2][s], j) if lph else None
                if not self._emit_token(emitted, s, rid, int(et[s, j]), base + j + 1, lp):
                    break
        return emitted
