"""Paged KV cache for the serving engine (vLLM-style page tables), in
PyTorch: the port of ``mop_tpu/serving/paged.py``.

The dense ``DecodeEngine`` reserves a ``block_size``-row slab per slot, so
its cache is ``max_batch x block_size`` rows however short the live
requests are. Here K/K2/V (and GPT-MoP's view history) live in a pool of
fixed-size pages; each slot holds a page table, pages are allocated as a
request's sequence grows and freed when it retires, so the number of
resident tokens, not ``max_batch x block_size``, bounds concurrency. When
the pool runs dry mid-decode the engine preempts the youngest request: its
pages are freed and it goes back to the front of the queue with its prompt
and the tokens emitted so far, which re-prefill on re-admission (greedy
tokens are unchanged: a row's state depends only on its token prefix).

``paged_decode_step_rows`` is ``decode_step_rows``'s math with the window
assembled by a gather through the page table (``models.generate.decode_rows``
with ``PagedRows`` as its cache access). The gather copies each row's
table-ordered window every layer, as JAX's does: paging buys memory, not
bandwidth (``cache_bytes`` against ``dense_equivalent_bytes``). The step
composes plain torch ops and launches no kernel, as the dense engine's. The
page tables live on the device beside their host copy, written in place
where a page is granted or freed, so that the step reads them without a
copy from the host; ``cuda_graph=True`` runs the step, its picker included,
as one CUDA graph, and a burst of ``step(n_tokens=k)`` as one graph of k
steps (JAX's ``_pmstep``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.generate import decode_rows, model_n_views
from ..utils.device import resolve_device
from .engine import _SP, DecodeEngine, _no_int8_pools

Tensor = torch.Tensor

__all__ = ["PagedDecodeEngine", "PagedRows", "init_paged_pool", "paged_decode_step_rows"]


def init_paged_pool(config, n_pages: int, page_size: int, dtype: torch.dtype = torch.float32,
                    n_views: int = 0, device=None, n_head: Optional[int] = None) -> dict:
    """K/K2/V page pools of shape (L, n_pages + 1, H, page_size, dk).

    Physical page 0 is the scratch page: every unallocated page-table entry
    points at it, so that rows that are not live write there and every
    gather reads valid indices. Usable pages are 1..n_pages. ``n_views > 0``
    (GPT-MoP) adds the view-history pool ``mv`` (L, n_pages + 1, page_size,
    V) in fp32, paged with the same tables. ``n_head``: the heads this
    process holds (a tensor-parallel model's share; default all). On the GPU
    unless ``device`` is given."""
    device = resolve_device(device)
    L, h = config.n_layer, n_head or config.n_head
    shape = (L, n_pages + 1, h, page_size, config.n_embd // config.n_head)
    pool = {key: torch.zeros(shape, dtype=dtype, device=device) for key in ("k", "k2", "v")}
    if n_views:
        pool["mv"] = torch.zeros(L, n_pages + 1, page_size, n_views, device=device)
    return pool


class PagedRows:
    """The paged cache's access for ``decode_rows``: row b's window is the
    pages ``table[b]`` in table order. Row b's position t lives in page
    ``table[b, t // page_size]`` at offset ``t % page_size`` (positions past
    the window are clamped to its last column, which no live row reads)."""

    def __init__(self, pool: dict, table: Tensor):
        self.pool, self.table = pool, table
        self.ps = pool["k"].shape[3]
        self.width = table.shape[1] * self.ps

    def _at(self, pos: Tensor):
        pos = pos.clamp_max(self.width - 1)
        return self.table.gather(1, pos // self.ps), pos % self.ps

    def write(self, i: int, pos: Tensor, new) -> None:
        page, off = self._at(pos)
        for key, r in zip(("k", "k2", "v"), new):  # r (B, H, G, dk)
            buf = self.pool[key]
            buf[i, page, :, off] = r.transpose(1, 2).to(buf.dtype)
        return None

    def window(self, key: str, i: int) -> Tensor:
        g = self.pool[key][i][self.table]  # (B, P, H, ps, dk)
        b, p, h, ps, dk = g.shape
        return g.transpose(1, 2).reshape(b, h, p * ps, dk)

    def write_views(self, i: int, pos: Tensor, views: Tensor) -> None:
        page, off = self._at(pos)
        self.pool["mv"][i, page, off] = views

    def views(self, i: int) -> Tensor:
        g = self.pool["mv"][i][self.table]  # (B, P, ps, V)
        return g.reshape(g.shape[0], -1, g.shape[-1])


def paged_decode_step_rows(model, params: Optional[dict], pool: dict, table: Tensor,
                           tokens: Tensor, lens: Tensor):
    """Advance every row one token against the paged pools.

    ``table`` (B, P): physical page ids (unallocated entries 0, the scratch
    page); ``tokens`` / ``lens`` (B,) as in ``decode_step_rows``. Row b's new
    K/K2/V land in page ``table[b, lens[b] // page_size]`` at offset
    ``lens[b] % page_size`` (in place); attention runs over the
    table-ordered ``P * page_size`` window masked to ``lens[b] + 1`` live
    columns. Returns ``(logits (B, vocab), pool)``."""
    logits = decode_rows(model, params, PagedRows(pool, table), tokens[:, None], lens)
    return logits[:, 0], pool


class PagedDecodeEngine(DecodeEngine):
    """Continuous batching over a paged KV pool with preemption.

    >>> eng = PagedDecodeEngine(model, params, max_batch=8, n_pages=48, page_size=16)
    >>> rid = eng.submit([5, 17, 3], max_new_tokens=32)
    >>> eng.run()

    The cache is ``n_pages x page_size`` token rows whatever ``max_batch``
    (the dense engine's: ``max_batch x block_size``), see ``cache_bytes``.
    ``n_pages`` must hold one full-window request (``block_size /
    page_size`` pages), so that preemption, youngest first, always lets the
    oldest request progress. ``preemptions``, ``pages_in_use`` and
    ``peak_pages_in_use`` count it. The options are the dense engine's but
    the prefix cache, chunked prefill and beams (JAX's paged engine has
    none of them either; ``num_beams`` raises); the pools are fp32 or bf16
    (int8 raises, as JAX's). ``cuda_graph=True`` (a CUDA device, a model
    that is not tensor-parallel) runs the batched step (the dense engine's
    ``_advance``, picker included) as one CUDA graph over the pools and the
    device page table, and the burst of ``step(n_tokens=k)`` as one replay
    of a k-step graph; a bucketed admission (a re-prefill after a
    preemption too) is one replay of a graph per (bucket, picker form) that
    pastes over the slot's whole page-table row (``_paste``), a prompt past
    the last bucket eager, as the dense engine's. Page allocation,
    preemption and host control stay on the host.
    """

    _captures_step = True

    def __init__(self, model, params: Optional[dict] = None, max_batch: int = 8,
                 n_pages: int = 64, page_size: int = 16, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, generator: Optional[torch.Generator] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 kv_dtype: torch.dtype = torch.float32, min_p: float = 0.0,
                 repetition_penalty: float = 1.0, presence_penalty: float = 0.0,
                 frequency_penalty: float = 0.0, adapters: Optional[Dict[str, dict]] = None,
                 adapter_scale=1.0, logprobs_topk: int = 0, cuda_graph: bool = False):
        cfg = model.config
        if cfg.block_size % page_size != 0:
            raise ValueError(f"page_size {page_size} must divide block_size {cfg.block_size}")
        self.page_size = page_size
        self.pages_per_slot = cfg.block_size // page_size
        if n_pages < self.pages_per_slot:
            raise ValueError(f"n_pages {n_pages} < pages_per_slot {self.pages_per_slot}: a "
                             "full-window request could never fit; preemption could not "
                             "guarantee progress")
        self.n_pages = n_pages
        _no_int8_pools(kv_dtype)
        super().__init__(model, params, max_batch=max_batch, eos_id=eos_id,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         generator=generator, prefill_buckets=prefill_buckets,
                         kv_dtype=kv_dtype, min_p=min_p, repetition_penalty=repetition_penalty,
                         presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
                         adapters=adapters, adapter_scale=adapter_scale,
                         logprobs_topk=logprobs_topk, cuda_graph=cuda_graph)
        self._pool = init_paged_pool(cfg, n_pages, page_size, kv_dtype,
                                     n_views=model_n_views(model), device=self.device,
                                     n_head=self.n_local_heads)
        self._pool_keys = tuple(self._pool)
        self._free: List[int] = list(range(n_pages, 0, -1))  # a stack; 0 is the scratch page
        self._table = np.zeros((max_batch, self.pages_per_slot), np.int64)
        # the device copy the step reads, kept equal to ``_table`` in place
        self._table_dev = torch.zeros((max_batch, self.pages_per_slot), dtype=torch.long,
                                      device=self.device)
        self._n_alloc = np.zeros((max_batch,), np.int64)  # pages each slot holds
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * max_batch
        # the length of results[rid] at admission: the tokens after it were
        # emitted since the (re-)admitted prefix
        self._slot_res_base = np.zeros((max_batch,), np.int64)
        self.preemptions = 0
        self.peak_pages_in_use = 0

    def _make_cache(self, cfg, max_batch: int, kv_dtype: torch.dtype) -> None:
        """No dense slabs: the ``max_batch x block_size`` reservation never exists."""
        return None

    def _slot_logits(self, tokens: Tensor, lens: Tensor) -> Tensor:
        return paged_decode_step_rows(self.model, self._step_params(), self._pool,
                                      self._table_dev, tokens, lens)[0]

    # ---------------- accounting ----------------

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def cache_bytes(self) -> int:
        """The cache this engine holds: the page pools, the scratch page included."""
        return sum(buf.numel() * buf.element_size() for buf in self._pool.values())

    def dense_equivalent_bytes(self) -> int:
        """What the dense engine's K/K2/V slabs would hold at this ``max_batch``."""
        cfg = self.model.config
        per = cfg.n_layer * self.max_batch * cfg.block_size * cfg.n_embd
        return 3 * per * torch.empty((), dtype=self.kv_dtype).element_size()

    # ---------------- page bookkeeping (host) ----------------

    def _alloc_page(self) -> Optional[int]:
        if not self._free:
            return None
        pg = self._free.pop()
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return pg

    def _grow(self, slot: int, pg: int) -> None:
        j = int(self._n_alloc[slot])
        self._table[slot, j] = pg
        self._table_dev[slot, j].fill_(pg)
        self._n_alloc[slot] += 1

    def _clear_table(self, slot: int) -> None:
        self._table[slot] = 0
        self._table_dev[slot].fill_(0)

    def _free_slot_pages(self, slot: int) -> None:
        for j in range(int(self._n_alloc[slot])):
            self._free.append(int(self._table[slot, j]))
        self._clear_table(slot)
        self._n_alloc[slot] = 0
        self._lens[slot] = 0
        self._slot_prompt[slot] = None

    def _reclaim_retired(self) -> None:
        for s in range(self.max_batch):
            if self._slot_rid[s] < 0 and self._n_alloc[s] > 0:
                self._free_slot_pages(s)

    def _replay_constraint(self, con, rid: int):
        """The DFA state after the tokens already emitted for ``rid`` (past
        the initial state only on re-admission after a preemption; the
        emitted tokens are legal by construction)."""
        if con is None:
            return None
        state = con.init_state()
        for t in self._results[rid]:
            state = con.advance(state, int(t))
        return state

    def _preempt_slot(self, victim: int) -> None:
        """Evict ``victim``: free its pages and put it back at the front of
        the queue with its whole prefix (the admitted prompt and the tokens
        emitted since), its remaining budget and its options."""
        rid = self._slot_rid[victim]
        sp = {k: float(self._sp[k][victim]) for k in _SP}
        new_toks = self._results[rid][int(self._slot_res_base[victim]):]
        prefix = np.concatenate([self._slot_prompt[victim], np.asarray(new_toks, np.int64)])
        self._queue.appendleft((rid, prefix, int(self._budget[victim]), sp,
                                int(self._slot_eos[victim]), self._slot_bias[victim],
                                self._slot_stops[victim], int(self._slot_adapter[victim]),
                                self._slot_constraint[victim], int(self._slot_seed[victim]),
                                None, 1.0))
        self._slot_rid[victim] = -1
        self._slot_constraint[victim] = None
        self._slot_cstate[victim] = None
        self._free_slot_pages(victim)
        self.preemptions += 1

    def _preempt_for(self, needy: int) -> None:
        """Free pages so that slot ``needy`` (or the queue, after ``needy``
        itself is evicted) can progress. A victim must be re-admissible: a
        slot whose prefix fills the window (``lens + 1 == block_size``, one
        emission from retiring) cannot be re-prefilled and is skipped; the
        youngest eligible goes first. With none, ``needy`` evicts itself
        (a slot that needs a growth page is re-admissible)."""
        cands = [s for s in range(self.max_batch)
                 if s != needy and self._slot_rid[s] >= 0
                 and int(self._lens[s]) + 1 < self.block_size]
        if cands:
            self._preempt_slot(max(cands, key=lambda s: self._slot_rid[s]))
        else:
            self._preempt_slot(needy)

    def _ensure_growth_pages(self) -> None:
        """Every live row writes its next K/V at position ``lens``: make sure
        that page exists, preempting youngest first when the pool is dry."""
        for s in range(self.max_batch):
            if self._slot_rid[s] < 0:
                continue
            need = int(self._lens[s]) // self.page_size
            while self._slot_rid[s] >= 0 and need >= int(self._n_alloc[s]):
                pg = self._alloc_page()
                if pg is None:
                    self._preempt_for(s)  # may evict s itself
                    continue
                self._grow(s, pg)

    # ---------------- admission ----------------

    def _admit_one(self):
        """Admit the queue's head into a free slot once the pool holds the
        pages of its prompt and first token; None while it waits (the live
        rows always drain). The pages are granted on the host; the prefill,
        the paste and the pick are the dense engine's admission body
        (``_admit_rows``, one replay per bucket under ``cuda_graph``; a
        prompt past the last bucket eagerly). A re-admitted request keeps
        its penalty counts (its prompt's last tokens are the ones it
        emitted), its constraint's state and its seeded stream's
        position."""
        try:
            slot = self._slot_rid.index(-1)
        except ValueError:
            return None
        if not self._queue:
            return None
        self._reclaim_retired()
        (rid, prompt, max_new, sp, eos, bias_row, stops, aid, con, seed, _nb,
         _lpen) = self._queue[0]
        t0 = int(prompt.size)
        n_need = t0 // self.page_size + 1  # positions 0..t0: t0 is tok0's
        if n_need > len(self._free):
            return None
        self._queue.popleft()
        self._clear_table(slot)
        for _ in range(n_need):
            self._grow(slot, self._alloc_page())
        self._slot_prompt[slot] = prompt.copy()
        self._slot_res_base[slot] = len(self._results[rid])
        self._set_slot_sampling(slot, sp, eos, seed)
        self._slot_ntok[slot] = len(self._results[rid])
        self._slot_bias[slot] = bias_row
        self._slot_stops[slot] = stops
        self._set_slot_adapter(slot, aid)
        self._slot_constraint[slot] = con
        self._slot_cstate[slot] = self._replay_constraint(con, rid)
        self._set_bias_row(slot)
        route, width = self._route(t0, 0)
        tok0, lp0 = self._admit_run(route, width, slot, prompt, 0, t0)
        self._slot_rid[slot] = rid
        self._budget[slot] = max_new
        return slot, rid, tok0, t0, lp0

    def _paste(self, pc: dict, slot: Tensor) -> None:
        """The prefill's rows (one row of a block-wide cache) into the pages
        of the slot that ``slot`` (a (1,) device index) names: its whole
        ``pages_per_slot`` table row, the entries past its allocation the
        scratch page 0, whose duplicate writes are garbage by design, so
        that one admission graph serves a bucket whatever its page count
        (JAX's ``_padm_finish``)."""
        idx = self._table_dev.index_select(0, slot)[0]
        npb, ps = self.pages_per_slot, self.page_size
        for key in self._pool_keys:
            rows = pc[key][:, 0]  # (L, H, block, dk); mv (L, block, V)
            if key == "mv":
                chunk = rows.reshape(rows.shape[0], npb, ps, rows.shape[-1])
            else:
                L, h, _, dk = rows.shape
                chunk = rows.reshape(L, h, npb, ps, dk).transpose(1, 2)
            self._pool[key].index_copy_(1, idx, chunk.to(self._pool[key].dtype))

    # ---------------- engine loop ----------------

    def step(self, n_tokens: int = 1) -> Dict[int, List[int]]:
        """One engine iteration: admit what the pool holds, give every live
        row the page its next token writes (preempting when the pool is
        dry), then advance the rows. ``n_tokens = k > 1`` runs a burst of k
        single steps for the unconstrained rows, with every page the burst
        writes allocated first (``_paged_multi_k``: the free pool bounds k,
        so no preemption happens inside a burst; if it cannot cover k = 2
        the call takes a single step, which may preempt); the constrained
        rows sit the burst out and take one step after it. The tokens are
        those of single steps. Under ``cuda_graph`` the burst is one replay
        (``_decode_burst``): a row that retires within it writes on into its
        own pages, and past them into the scratch page (its table's
        unallocated entries), until the burst ends and its pages are
        freed."""
        self.engine_steps += 1
        emitted: Dict[int, List[int]] = {}

        def emit(s, *a):
            alive = self._emit_token(emitted, s, *a)
            if not alive:
                self._free_slot_pages(s)
            return alive

        self._reclaim_retired()
        while self._queue:
            adm = self._admit_one()
            if adm is None:
                break
            if not self._emit_token(emitted, *adm):
                self._reclaim_retired()
        active = [s for s, r in enumerate(self._slot_rid) if r >= 0]
        if active:
            self._ensure_growth_pages()
            active = [s for s, r in enumerate(self._slot_rid) if r >= 0]  # after preemption
        with torch.no_grad():
            if active and n_tokens > 1:
                k, elig = self._paged_multi_k(n_tokens, active)
                if k > 1 and self._graph is not None:
                    self._decode_burst(elig, k, emit)
                elif k > 1:
                    for _ in range(k):
                        live = [s for s in elig if self._slot_rid[s] >= 0]
                        if not live:
                            break
                        self._decode_once(live, emit)
                if k > 1:
                    active = [s for s in active if s not in elig and self._slot_rid[s] >= 0]
            if active:
                self._decode_once(active, emit)
        return emitted

    def _paged_multi_k(self, n_tokens: int, active):
        """The burst size and its rows: the unconstrained live rows, k capped
        at the largest headroom among them (a row nearer its end retires
        mid-burst), then lowered until the free pool holds every page the
        burst writes (positions ``lens .. min(lens + k, lens + budget,
        block) - 1``), which are allocated here. ``(1, None)``: no burst."""
        elig = [s for s in active if self._slot_constraint[s] is None]
        if not elig:
            return 1, None
        headroom = max(min(int(self._budget[s]), self.block_size - int(self._lens[s]))
                       for s in elig)
        k = min(int(n_tokens), max(headroom, 1))
        while k > 1 and self._burst_page_need(elig, k) > len(self._free):
            k -= 1
        if k <= 1:
            return 1, None
        for s in elig:
            need = self._burst_last_pos(s, k) // self.page_size + 1
            while int(self._n_alloc[s]) < need:
                self._grow(s, self._alloc_page())  # the loop above guarantees a page
        return k, elig

    def _burst_last_pos(self, s: int, k: int) -> int:
        """The last position slot ``s`` writes in a k-burst (it retires at its
        budget or the window's end)."""
        lens = int(self._lens[s])
        return min(lens + k, lens + int(self._budget[s]), self.block_size) - 1

    def _burst_page_need(self, elig, k: int) -> int:
        """The free pages a k-burst over ``elig`` takes."""
        return sum(max(0, self._burst_last_pos(s, k) // self.page_size + 1
                       - int(self._n_alloc[s])) for s in elig)

    def cancel(self, rid: int) -> bool:
        ok = super().cancel(rid)
        if ok:
            self._reclaim_retired()
        return ok
