"""Continuous-batching transcription serving for Whisper-MoP, the port of
``mop_tpu/serving/whisper.py``.

Audio requests are admitted into a fixed slot pool: admission runs the
encoder once (on the card, K1 in every encoder layer) and freezes the
request's cross-attention K/V into its slot; one batched decoder step
advances every live transcription by a token, each at its own position.
The Whisper decoder is a standard causal transformer, so the cache is exact:
each stream's tokens are those of ``whisper_transcribe_cached`` for its mel
alone. The decode reads the JAX-layout tree (``whisper_decode_params``)
through ``_lin``, so its kernels may be int8 / int4; the encoder runs on the
tree's dequantized copy.

The step reads each slot's length and liveness from device buffers
(``engine.DeviceMirror``) and advances the lengths itself.
``cuda_graph=True`` runs the batched step and the admission each as one
CUDA graph, as JAX's ``_step_fn`` and ``_admit_fn``: the admission's
encoder (K1 in every layer, its launches counted per replay) and cross
K/V written into the slot a device index names; the mel's shape is the
model's, so one graph serves every admission. ``step(n_tokens=k)`` is then
one replay of k greedy steps, as JAX's ``_mstep`` (one graph per k).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.generate import (_lin, _split_heads, whisper_decode_params,
                               whisper_decode_step_rows, whisper_encode)
from ..ops.quant import Q4Tensor, QTensor, _leaves, dequantize_params
from ..utils.cuda_graph import GraphPerKey, StepGraph, require_graph
from .engine import DeviceMirror

Tensor = torch.Tensor

__all__ = ["WhisperServingEngine", "whisper_decode_step_rows"]


class WhisperServingEngine:
    """Continuous-batching greedy transcription over a fixed slot pool.

    >>> eng = WhisperServingEngine(model, params, max_batch=4, bos_token=1)
    >>> rid = eng.submit(mel, max_new_tokens=64)
    >>> results = eng.run()     # {rid: [tokens...]}

    Every mel has the model's ``n_audio_ctx`` frames (Whisper's fixed 30 s
    window). A request retires at ``max_new_tokens``, its ``eos_id`` or the
    text window. ``params``: ``whisper_decode_params(model)`` or its int8 /
    int4 form (None: the model's own); the pools live on its device.
    ``kv_dtype``: the pools' storage, fp32 or bf16. ``cuda_graph=True`` (a
    CUDA device only, else a ValueError): the batched step and the
    admission each one CUDA graph, and ``step(n_tokens=k)`` replays of
    min(k, the least budget, the least window room) steps, one while no
    row's budget or window ends sooner (the module docstring)."""

    def __init__(self, model, params: Optional[dict] = None, max_batch: int = 4,
                 bos_token: int = 1, eos_id: Optional[int] = None,
                 kv_dtype: torch.dtype = torch.float32, cuda_graph: bool = False):
        if kv_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the Whisper engine stores fp32 or bf16 K/V, got {kv_dtype}")
        self.model = model
        self.params = whisper_decode_params(model) if params is None else params
        # the encoder's layers take no quantized weights: one dequantized copy
        quantized = any(isinstance(w, (QTensor, Q4Tensor)) for w in _leaves(self.params))
        self._enc_params = dequantize_params(self.params) if quantized else params
        self.device = self.params["params"]["wte"]["embedding"].device
        if cuda_graph:
            require_graph("WhisperServingEngine", self.device)
        self.max_batch = max_batch
        self.bos_token = bos_token
        self.eos_id = eos_id
        cfg = model.cfg
        self.win = cfg.n_text_ctx
        self.t_enc = cfg.n_audio_ctx
        h, dh, L = cfg.n_head, cfg.n_embd // cfg.n_head, cfg.n_layer_dec
        dev = self.device
        self._ck = torch.zeros((L, max_batch, h, self.t_enc, dh), dtype=kv_dtype, device=dev)
        self._cv = torch.zeros_like(self._ck)
        self._ks = torch.zeros((L, max_batch, h, self.win, dh), dtype=kv_dtype, device=dev)
        self._vs = torch.zeros_like(self._ks)
        self._tokens = torch.full((max_batch,), bos_token, dtype=torch.long, device=dev)
        self._lens = np.zeros((max_batch,), np.int64)
        self._dlens = DeviceMirror(max_batch, torch.long, dev)
        self._dlive = DeviceMirror(max_batch, torch.bool, dev)
        self._slot_ids = torch.arange(max_batch, device=dev)
        # each graph captured by the thread that drives the engine (the HTTP
        # server's device worker) next to others: thread-local capture errors
        self._step_graph = self._admit_graph = None
        if cuda_graph:  # one graph per burst size, the single step's 1
            self._step_graph = GraphPerKey(self._steps_rows, dev,
                                           capture_error_mode="thread_local")
            self._admit_graph = StepGraph(self._admit_rows, dev,
                                          capture_error_mode="thread_local")
        self._slot_rid: List[int] = [-1] * max_batch
        self._slot_eos = np.full((max_batch,), -1, np.int64)
        self._budget = np.zeros((max_batch,), np.int64)
        self._queue: deque = deque()
        self._results: Dict[int, List[int]] = {}
        self._done: Dict[int, bool] = {}
        self._next_rid = 0
        self.tokens_generated = 0
        self.engine_steps = 0

    def submit(self, mel, max_new_tokens: int, eos_id: Optional[int] = None) -> int:
        """Queue a transcription: ``mel`` (n_audio_ctx, n_mels) or
        (1, n_audio_ctx, n_mels) floats."""
        mel = np.asarray(mel, np.float32)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.shape[0] != 1 or mel.shape[1] != self.t_enc:
            raise ValueError(f"mel must be (1, {self.t_enc}, n_mels); got {mel.shape}")
        if not 1 <= max_new_tokens <= self.win:
            raise ValueError(f"max_new_tokens must be in [1, {self.win}]")
        rid = self._next_rid
        self._next_rid += 1
        eos = self.eos_id if eos_id is None else eos_id
        self._queue.append((rid, mel, max_new_tokens, -1 if eos is None else int(eos)))
        self._results[rid] = []
        self._done[rid] = False
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

    def is_done(self, rid: int) -> bool:
        return self._done[rid]

    def _admit(self, slot: int, mel: np.ndarray) -> None:
        """One encoder pass; this request's cross K/V frozen into ``slot``."""
        args = (torch.from_numpy(mel).to(self.device), self._slot_ids[slot:slot + 1])
        if self._admit_graph is not None:
            self._admit_graph(*args)
        else:
            self._admit_rows(*args)

    def _admit_rows(self, mel: Tensor, slot: Tensor) -> None:
        """The admission in place: the encoder over the (1, T, n_mels)
        ``mel``, every decoder layer's cross K/V written into the slot that
        ``slot`` (a (1,) device tensor) names."""
        cfg = self.model.cfg
        enc = whisper_encode(self.model, mel, self._enc_params)
        p = self.params["params"]
        with torch.no_grad():
            for li in range(cfg.n_layer_dec):
                cp = p[f"decoder_{li}"]["cross_attn"]
                for pool, w in ((self._ck, cp["k_proj"]), (self._cv, cp["v_proj"])):
                    rows = _split_heads(_lin(enc, w), cfg.n_head)
                    pool[li].index_copy_(0, slot, rows.to(pool.dtype))

    def _step_rows(self) -> Tensor:
        """The batched step in place: every row's token at its device length,
        the tokens becoming the argmax and the live rows' lengths advancing
        by one (a row at the window's end held there: its write lands in its
        own last column). Returns the (B,) tokens."""
        lens = self._dlens.dev
        logits = whisper_decode_step_rows(self.model, self.params, self._ck, self._cv, self._ks,
                                          self._vs, self._tokens, lens)[0]
        self._tokens.copy_(logits.argmax(-1))
        lens.add_(self._dlive.dev & (lens < self.win))
        return self._tokens

    def _steps_rows(self, k: int) -> Tensor:
        """``_step_rows`` k times: the (k, B) tokens as int32, ready for the
        copy to the host (JAX's ``_mstep`` scan)."""
        return torch.stack([self._step_rows().to(torch.int32) for _ in range(k)])

    def step(self, n_tokens: int = 1) -> Dict[int, List[int]]:
        """Admit whatever fits, then advance every live row ``n_tokens``
        tokens, one batched step at a time (a row that hits EOS retires
        there). Under ``cuda_graph`` the rows advance k = min(n_tokens, the
        least budget, the least window room) tokens in one replay, as JAX's
        ``step`` (a row that hits EOS within them retires there and its
        later tokens are thrown away), and the next replay takes the
        tokens left, so that the call gives the single steps' tokens.
        Returns ``{rid: [tokens]}``."""
        self.engine_steps += 1
        emitted: Dict[int, List[int]] = {}
        while self._queue:
            try:
                slot = self._slot_rid.index(-1)
            except ValueError:
                break
            rid, mel, max_new, eos = self._queue.popleft()
            self._admit(slot, mel)
            self._slot_rid[slot] = rid
            self._slot_eos[slot] = eos
            self._budget[slot] = max_new
            self._lens[slot] = 0
            self._tokens[slot] = self.bos_token
        left = max(1, int(n_tokens))
        while left > 0:
            active = [s for s, r in enumerate(self._slot_rid) if r >= 0]
            if not active:
                break
            k = 1
            if self._step_graph is not None:
                k = max(1, min(left, int(self._budget[active].min()),
                               int((self.win - self._lens[active]).min())))
            live = np.zeros((self.max_batch,), bool)
            live[active] = True
            self._dlens.sync(self._lens)
            self._dlive.sync(live)
            with torch.no_grad():
                out = self._step_graph(k) if self._step_graph is not None else self._steps_rows(1)
            toks = out.cpu().numpy()
            self._dlens.advanced(np.where(live, self._lens + k, self._lens))
            for j in range(k):
                for s in active:
                    if self._slot_rid[s] >= 0:
                        self._emit(emitted, s, int(toks[j, s]))
            left -= k
        return emitted

    def _emit(self, emitted: Dict[int, List[int]], s: int, tok: int) -> None:
        """Record slot ``s``'s next token; retire it at its EOS, its budget
        or the window's end."""
        rid = self._slot_rid[s]
        self._lens[s] += 1
        self.tokens_generated += 1
        self._results[rid].append(tok)
        emitted.setdefault(rid, []).append(tok)
        self._budget[s] -= 1
        if tok == self._slot_eos[s] or self._budget[s] <= 0 or self._lens[s] >= self.win:
            self._slot_rid[s] = -1
            self._lens[s] = 0
            self._done[rid] = True

    def run(self, n_tokens: int = 1) -> Dict[int, List[int]]:
        while self._queue or self.n_active:
            self.step(n_tokens=n_tokens)
        return {rid: list(t) for rid, t in self._results.items()}
