"""Minimal HTTP front-end for the continuous-batching decode engine, the
port of ``mop_tpu/serving/http.py`` (same endpoints, same JSON).

Stdlib-only (``http.server`` + threads): concurrent clients POST token
prompts; their requests are admitted into ONE shared `DecodeEngine` slot
pool, so unrelated HTTP requests batch onto the same device step. A single
worker thread owns the engines' device work, inside its own
``torch.inference_mode()`` (grad mode is thread-local: without it every step
would record autograd state); handlers only submit and wait, so the engine
needs no internal thread safety. The embedding and echo-scoring forwards
run on the handler threads, each under its own ``no_grad``. The engines run
on the device of their params: the card unless the caller built them on
the CPU.

API:
- ``POST /generate``  body ``{"prompt": [int, ...], "max_new_tokens": N}``
  -> ``{"request_id": rid, "tokens": [int, ...]}`` (blocks until done).
  Optional per-request sampling fields: ``temperature`` (0 = greedy),
  ``top_k``, ``top_p``, ``eos_id``, ``min_p``, ``repetition_penalty``,
  ``presence_penalty``, ``frequency_penalty``, ``seed`` (pins the
  request's sample stream — bit-reproducible regardless of co-batched
  traffic), ``logit_bias`` (JSON object
  ``{token_id: bias}``), ``stop`` (list of ints or token-id lists),
  ``adapter`` (LoRA adapter name from the engine's bank) — requests with
  different sampling params (or adapters) still batch onto the same
  device step. Guided decoding: ``guided_choice`` (list of token-id
  sequences; the output is exactly one of them, then EOS),
  ``guided_token_set`` (``{"allowed": [ids], "min_len": N, "max_len":
  M}``), ``guided_regex`` (anchored pattern compiled against the
  server's ``token_strs`` vocabulary), or ``guided_json`` (a JSON-schema
  dict; the output is compact JSON satisfying it) build a
  :mod:`~mop_tpu_torch.serving.constrain` DFA for the request; all require an
  effective ``eos_id``.
- ``POST /generate`` with ``"text": "..."`` instead of ``"prompt"``
  (requires a server constructed with ``tokenizer=``, e.g.
  :class:`mop_tpu_torch.data.tokenizer.ByteBPETokenizer`): the prompt is encoded
  server-side and the response gains a decoded ``"text"`` field.
  ``guided_regex``/``guided_json`` compile against the tokenizer's
  vocabulary automatically.
- ``POST /generate`` with ``"stream": true`` -> Server-Sent Events
  (``text/event-stream``): one ``data: {"token": t}`` event per generated
  token AS IT LANDS, then ``data: {"done": true, "request_id": rid,
  "tokens": [...]}``. In text mode every token event also carries a
  ``"text"`` piece (incremental UTF-8-safe decode: a multi-byte
  character held across events surfaces once complete) and the final
  event the full decoded string. Tokens equal the non-streamed response
  exactly
  (same engine, same slot pool — streaming changes delivery, not
  decoding).
  The FIRST event is ``data: {"request_id": rid}`` so the client can
  cancel mid-stream; a client that disconnects mid-stream cancels its
  request automatically (the slot frees for the next queued request).
- ``POST /cancel`` body ``{"request_id": rid}`` -> ``{"request_id": rid,
  "cancelled": bool}`` (false = unknown rid or already finished).
- ``GET /health`` -> ``{"status": "ok"|"draining"|"failed", "active": A,
  "queued": Q, "completed": C}``. ``"failed"`` means the device worker
  hit a fatal ``engine.step()`` exception: in-flight waiters fail fast
  with 500 (instead of hanging) and new submissions are rejected.
- **OpenAI-compatible endpoints** (require ``tokenizer=``):
  ``POST /v1/completions``, ``POST /v1/chat/completions`` (blocking and
  ``"stream": true`` SSE chunk formats, ``data: [DONE]`` terminator),
  ``GET /v1/models`` — field mapping, stop-string trimming, and
  ``finish_reason``/``usage`` semantics in
  :mod:`mop_tpu_torch.serving.openai_api`. ``response_format`` type
  ``json_schema`` compiles to a token DFA (guided decoding) when the
  server has ``token_strs``; ``logprobs`` (completions int 0..5, chat
  ``true`` + ``top_logprobs`` 0..20) are served when the engine was
  built with ``logprobs_topk > 0`` (blocking responses only); ``n``
  1..8 choices decode as one batch (each an independent engine
  request). OpenAI requests batch onto the same slot pool as native
  ``/generate`` traffic. ``model_name=`` sets
  the advertised model id; ``chat_template=`` overrides the default
  role-tagged chat rendering.
- ``POST /v1/embeddings`` (OpenAI-compatible): ``input`` as a string /
  list of strings (needs ``tokenizer=``) / token-id list(s);
  ``encoding_format`` ``float``|``base64``; ``dimensions`` truncation.
  Vectors are final-LN masked-mean-pooled, unit-norm hidden states of
  the serving model (or a dedicated ``embed_model=``); the whole batch
  runs as one forward pass (:mod:`mop_tpu_torch.serving.embeddings`).
- ``GET /metrics`` -> Prometheus text format (requests
  completed/cancelled/active/queued, tokens generated, engine steps,
  prefix-cache hits and reused tokens, plus latency histograms:
  ``mop_ttft_seconds`` — submit to first generated token — and
  ``mop_tpot_seconds`` — mean time per subsequent token — the two
  numbers a serving SLO is written against).

Graceful drain (preemption-aware shutdown, the serving counterpart of
:class:`mop_tpu_torch.training.preemption.PreemptionGuard`): ``srv.drain()`` —
or SIGTERM after ``srv.install_drain_handler()`` — stops admitting
(new ``/generate`` requests get 503 + ``Retry-After`` so a load balancer
fails over), lets every in-flight request finish (streams included),
then stops the server. ``drain(timeout=...)`` bounds the wait; on
timeout the stragglers are cancelled so a preemption grace window is
never overrun.

Usage::

    eng = DecodeEngine(model, params, max_batch=8, eos_id=eos)
    srv = ServingServer(eng)
    srv.start()                      # returns immediately
    srv.install_drain_handler()      # SIGTERM -> graceful drain
    ...                              # POST to http://127.0.0.1:{srv.port}
    srv.stop()

See ``mop_tpu_torch/cli/serve_http.py`` for an end-to-end deployment.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from . import openai_api as _oai
from ..data.audio import load_wav, log_mel, resample, segment_frames
from .constrain import choices, token_set
from .embeddings import EmbeddingModel, embeddings_body, \
    parse_embedding_input
from .json_schema import (json_schema_to_dfa, tool_call_auto_to_dfa,
                          tool_call_to_dfa)
from .regex_dfa import regex_to_dfa
from .scoring import prompt_logprobs


class _Histogram:
    """Minimal Prometheus histogram: cumulative buckets + sum + count."""

    def __init__(self, buckets):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        i = 0
        while i < len(self.buckets) and v > self.buckets[i]:
            i += 1
        self.counts[i] += 1
        self.total += v
        self.n += 1

    def render(self, name: str, help_: str) -> list:
        out = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        cum = 0
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f'{name}_bucket{{le="{le}"}} {cum}')
        out.append(f'{name}_bucket{{le="+Inf"}} {self.n}')
        out.append(f"{name}_sum {self.total}")
        out.append(f"{name}_count {self.n}")
        return out


_TTFT_BUCKETS = (0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0, 10.0)
_TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5)


class _FairLock:
    """A lock granted in the order it was asked for. The device worker asks
    again as soon as it releases, after every step; with a plain lock it
    would win that race against a waiting handler (``/cancel``,
    ``/health``, a submit) as long as the engine is busy, since its eager
    steps keep the interpreter."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._next = 0  # the next ticket to hand out
        self._serving = 0  # the ticket that holds the lock

    def __enter__(self):
        with self._cond:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cond.wait()
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._serving += 1
            self._cond.notify_all()


class ServingServer:
    """HTTP wrapper around a decode engine; one device-worker thread.

    ``token_strs`` (optional): id -> decoded-string vocabulary table;
    required only to serve ``guided_regex`` requests (the regex is
    compiled to a token DFA against it; empty strings mark ids with no
    text, e.g. specials)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 poll_interval: float = 0.002, token_strs=None,
                 tokenizer=None, model_name: str = "mop",
                 chat_template=None, whisper_engine=None,
                 whisper_tokenizer=None, audio_rate: int = 16000,
                 embed_model: Optional[EmbeddingModel] = None,
                 max_embed_inputs: int = 256,
                 max_queue: int = 64, retry_after: int = 1,
                 steps_per_dispatch: int = 1):
        self.engine = engine
        # /v1/embeddings backend: an explicit EmbeddingModel, or (lazily,
        # on first request) the serving engine's own model + params.
        # Requests with more than ``max_embed_inputs`` sequences are
        # rejected with 400 (the embedder additionally chunks what it
        # accepts through a bounded device batch).
        self._embed_model = embed_model
        self._max_embed_inputs = int(max_embed_inputs)
        self._embeddings_served = 0
        # admission backpressure: requests past ``max_queue`` waiting
        # entries get 429 + Retry-After instead of unbounded queue (and
        # host memory) growth; rejections are counted in /metrics
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._max_queue = int(max_queue)
        self._retry_after = int(retry_after)
        self._rejected = 0
        # multi-step decoding: the worker advances the TEXT engine this
        # many tokens per engine step (step(n_tokens=k) — token-identical;
        # tokens stream in bursts of up to k, so keep it small when
        # TTFT/stream smoothness matters). Supported by engines whose step() takes n_tokens
        # (DecodeEngine); validated HERE so an engine whose step does not
        # fails loudly at construction instead of latching a TypeError
        # into _step_error at the first request.
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if steps_per_dispatch > 1:
            import inspect
            try:
                step_params = inspect.signature(
                    type(engine).step).parameters
            except (TypeError, ValueError):  # builtins/odd callables
                step_params = {}
            if "n_tokens" not in step_params:
                raise ValueError(
                    f"steps_per_dispatch={steps_per_dispatch} needs an "
                    f"engine whose step() takes n_tokens; "
                    f"{type(engine).__name__}.step does not (use "
                    f"steps_per_dispatch=1 with it)")
        self._spd = int(steps_per_dispatch)
        self._tokenizer = tokenizer
        self._model_name = model_name
        self._chat_template = chat_template
        # optional second engine: audio transcription
        # (POST /v1/audio/transcriptions). Shares the device-worker
        # thread — text and audio requests interleave step-for-step.
        self.whisper_engine = whisper_engine
        self._whisper_tokenizer = whisper_tokenizer or tokenizer
        self._audio_rate = audio_rate
        self._completed_audio = 0
        self._created = int(time.time())
        if token_strs is None and tokenizer is not None:
            # duck-typed tokenizers without a token_strs table are fine:
            # it only gates the grammar-constrained features (json_schema
            # / tool calling), which raise their own clear 400 without it
            token_strs = getattr(tokenizer, "token_strs", None)
        self._token_strs = None if token_strs is None else \
            [str(s) for s in token_strs]
        self._lock = _FairLock()               # guards engine access
        self._completed = 0
        self._cancelled = 0
        self._running = False
        self._draining = False
        self._drained = threading.Event()      # set when drain completes
        self._step_error = None                # fatal engine.step exception
        self._poll = poll_interval
        # latency tracking (all under _lock): rid -> submit/first times
        self._lat_pending = {}                 # rid -> (t_submit, t_first)
        self._hist_ttft = _Histogram(_TTFT_BUCKETS)
        self._hist_tpot = _Histogram(_TPOT_BUCKETS)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _json(self, code: int, payload: dict,
                      headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _admission_check(self, n_new: int, oai: bool,
                                 engine=None):
                """Bounded-queue backpressure (must hold outer._lock):
                if admitting ``n_new`` more requests would push the
                given engine's queue (default: the text engine) past
                ``max_queue``, send 429 + ``Retry-After`` and return
                False. Without this a misbehaving client grows the
                queue (and host memory) without limit."""
                eng = outer.engine if engine is None else engine
                if eng.n_queued + n_new <= outer._max_queue:
                    return True
                outer._rejected += 1
                retry = {"Retry-After": str(outer._retry_after)}
                msg = (f"queue full ({eng.n_queued} waiting, limit "
                       f"{outer._max_queue}); retry later")
                if oai:
                    body = {"error": {"message": msg,
                                      "type": "overloaded_error",
                                      "param": None, "code": None}}
                else:
                    body = {"error": msg}
                self._json(429, body, headers=retry)
                return False

            def do_GET(self):
                if self.path == "/metrics":
                    return self._metrics()
                if self.path == "/v1/models":
                    return self._json(200, _oai.models_body(
                        outer._model_name, outer._created))
                if self.path != "/health":
                    return self._json(404, {"error": "unknown path"})
                with outer._lock:
                    self._json(200, {
                        "status": ("failed" if outer._step_error is not None
                                   else "draining" if outer._draining
                                   else "ok"),
                        "active": outer.engine.n_active,
                        "queued": outer.engine.n_queued,
                        "completed": outer._completed,
                    })

            def _metrics(self) -> None:
                eng = outer.engine
                with outer._lock:
                    rows = [
                        ("requests_completed_total", "counter",
                         "Requests fully completed.", outer._completed),
                        ("requests_cancelled_total", "counter",
                         "Requests cancelled via /cancel or client "
                         "disconnect.", outer._cancelled),
                        ("requests_active", "gauge",
                         "Requests currently occupying a decode slot.",
                         eng.n_active),
                        ("requests_queued", "gauge",
                         "Requests waiting for a free slot.", eng.n_queued),
                        ("tokens_generated_total", "counter",
                         "Tokens emitted across all requests.",
                         eng.tokens_generated),
                        ("engine_steps_total", "counter",
                         "Engine iterations (one fixed-shape device step "
                         "each, plus admissions).", eng.engine_steps),
                        ("prefix_cache_hits_total", "counter",
                         "Admissions that reused a cached prefix.",
                         eng.prefix_cache_hits),
                        ("prefix_tokens_reused_total", "counter",
                         "Prompt tokens whose prefill was skipped via the "
                         "prefix cache.", eng.prefix_tokens_reused),
                        ("embeddings_served_total", "counter",
                         "Input sequences embedded via /v1/embeddings.",
                         outer._embeddings_served),
                        ("requests_rejected_total", "counter",
                         "Requests rejected with 429 (queue full).",
                         outer._rejected),
                    ]
                out = []
                for name, kind, help_, val in rows:
                    out.append(f"# HELP mop_{name} {help_}")
                    out.append(f"# TYPE mop_{name} {kind}")
                    out.append(f"mop_{name} {val}")
                with outer._lock:
                    out += outer._hist_ttft.render(
                        "mop_ttft_seconds",
                        "Submit to first generated token.")
                    out += outer._hist_tpot.render(
                        "mop_tpot_seconds",
                        "Mean per-token time after the first.")
                body = ("\n".join(out) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path == "/cancel":
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        rid = int(json.loads(self.rfile.read(n))
                                  ["request_id"])
                    except (KeyError, ValueError,
                            json.JSONDecodeError) as e:
                        return self._json(400, {"error": str(e)})
                    with outer._lock:
                        ok = outer.engine.cancel(rid)
                        outer._cancelled += ok
                        if ok:
                            outer._lat_pending.pop(rid, None)
                    return self._json(200, {"request_id": rid,
                                            "cancelled": ok})
                if self.path in ("/v1/completions", "/v1/chat/completions"):
                    return self._openai(
                        chat=self.path.endswith("chat/completions"))
                if self.path == "/v1/audio/transcriptions":
                    return self._audio_transcription()
                if self.path == "/v1/embeddings":
                    return self._embeddings()
                if self.path != "/generate":
                    return self._json(404, {"error": "unknown path"})
                if outer._draining:
                    self.send_response(503)
                    body = json.dumps(
                        {"error": "server draining (preemption)"}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Retry-After", "1")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    is_text = req.get("text") is not None
                    if is_text:
                        if outer._tokenizer is None:
                            raise ValueError(
                                "text prompts need a server constructed "
                                "with a tokenizer")
                        if req.get("prompt") is not None:
                            raise ValueError(
                                "pass either 'text' or 'prompt', not both")
                        prompt = outer._tokenizer.encode(str(req["text"]))
                        if not prompt:
                            raise ValueError("text encoded to zero tokens")
                    else:
                        prompt = req["prompt"]
                    max_new = int(req.get("max_new_tokens", 32))
                    stream = bool(req.get("stream", False))
                    kw = {}
                    for key, cast in (("temperature", float),
                                      ("top_p", float), ("top_k", int),
                                      ("eos_id", int), ("min_p", float),
                                      ("repetition_penalty", float),
                                      ("presence_penalty", float),
                                      ("frequency_penalty", float),
                                      ("seed", int)):
                        if req.get(key) is not None:
                            kw[key] = cast(req[key])
                    if req.get("logit_bias") is not None:
                        kw["logit_bias"] = {
                            int(t): float(v)
                            for t, v in req["logit_bias"].items()}
                    if req.get("stop") is not None:
                        kw["stop"] = req["stop"]
                    if req.get("adapter") is not None:
                        kw["adapter"] = str(req["adapter"])
                    if req.get("guided_regex") is not None or \
                            req.get("guided_json") is not None:
                        if outer._token_strs is None:
                            raise ValueError(
                                "guided_regex/guided_json need a server "
                                "constructed with token_strs (the "
                                "id->string vocabulary to compile "
                                "against)")
                        if req.get("guided_regex") is not None:
                            kw["constraint"] = regex_to_dfa(
                                str(req["guided_regex"]),
                                outer._token_strs)
                        else:
                            kw["constraint"] = json_schema_to_dfa(
                                req["guided_json"], outer._token_strs)
                    elif req.get("guided_choice") is not None:
                        kw["constraint"] = choices(req["guided_choice"])
                    elif req.get("guided_token_set") is not None:
                        g = req["guided_token_set"]
                        kw["constraint"] = token_set(
                            g["allowed"], int(g.get("min_len", 1)),
                            None if g.get("max_len") is None
                            else int(g["max_len"]))
                    if (not isinstance(prompt, list)
                            or not all(isinstance(t, int) for t in prompt)):
                        raise ValueError("prompt must be a list of ints")
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._json(400, {"error": str(e)})
                try:
                    with outer._lock:
                        if outer._draining:  # re-check under the lock:
                            # a drain that began after the fast-path check
                            # must not admit work onto a stopping engine
                            return self._json(503, {
                                "error": "server draining (preemption)"})
                        if outer._step_error is not None:
                            return self._json(500, {
                                "error": "device worker failed: "
                                         f"{outer._step_error!r}"})
                        if not self._admission_check(1, oai=False):
                            return
                        rid = outer.engine.submit(prompt, max_new, **kw)
                        outer._lat_pending[rid] = [time.monotonic(), None]
                except (ValueError, TypeError) as e:
                    # bad length / budget / sampling, or an extension
                    # kwarg this engine's submit doesn't take — a clean 400,
                    # not an aborted connection
                    return self._json(400, {"error": str(e)})
                if stream:
                    return self._stream(rid, is_text)
                try:
                    toks = outer._wait(rid)
                except RuntimeError as e:  # device worker died
                    return self._json(500, {"error": str(e)})
                payload = {"request_id": rid, "tokens": toks}
                if is_text:
                    payload["text"] = outer._tokenizer.decode(toks)
                self._json(200, payload)

            def _oai_error(self, code: int, msg: str,
                           kind: str = "invalid_request_error") -> None:
                self._json(code, {"error": {"message": msg, "type": kind}})

            def _openai(self, chat: bool) -> None:
                """OpenAI-compatible /v1/completions and
                /v1/chat/completions (field mapping in
                :mod:`mop_tpu_torch.serving.openai_api`)."""
                if outer._tokenizer is None:
                    return self._oai_error(
                        400, "this server was constructed without a "
                        "tokenizer; OpenAI endpoints need one")
                if outer._draining:
                    return self._oai_error(
                        503, "server draining (preemption)", "server_error")
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    if chat:
                        p = _oai.parse_chat(req, outer._tokenizer,
                                            outer._chat_template)
                    else:
                        p = _oai.parse_completion(req, outer._tokenizer)
                    if p["json_schema"] is not None:
                        if outer._token_strs is None:
                            raise ValueError(
                                "response_format json_schema needs a "
                                "server constructed with token_strs")
                        p["kw"]["constraint"] = json_schema_to_dfa(
                            p["json_schema"], outer._token_strs)
                    if p.get("tools"):
                        if outer._token_strs is None:
                            raise ValueError(
                                "tool calling needs a server "
                                "constructed with token_strs")
                        build = (tool_call_auto_to_dfa
                                 if p["tools"]["mode"] == "auto"
                                 else tool_call_to_dfa)
                        p["kw"]["constraint"] = build(
                            p["tools"]["tools"], outer._token_strs)
                    if p["logprobs"] is not None:
                        have = getattr(outer.engine, "logprobs_topk", 0)
                        if have <= 0:
                            raise ValueError(
                                "this server's engine does not track "
                                "logprobs (construct it with "
                                "logprobs_topk > 0)")
                        if p["logprobs"] > have:
                            raise ValueError(
                                f"logprobs {p['logprobs']} exceeds the "
                                f"engine's tracked top-{have}")
                        if p["stream"]:
                            raise ValueError(
                                "logprobs with stream is not supported")
                    if p.get("best_of", p["n"]) > p["n"] and \
                            getattr(outer.engine, "logprobs_topk", 0) <= 0:
                        raise ValueError(
                            "best_of ranking needs an engine built with "
                            "logprobs_topk > 0 (candidates are ranked by "
                            "mean token logprob)")
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._oai_error(400, str(e))
                try:
                    with outer._lock:
                        if outer._draining:
                            return self._oai_error(
                                503, "server draining (preemption)",
                                "server_error")
                        if outer._step_error is not None:
                            return self._oai_error(
                                500, "device worker failed: "
                                     f"{outer._step_error!r}",
                                "server_error")
                        # best_of (>= n) candidates = that many engine
                        # requests submitted together; they decode as one
                        # batch on the slot pool (not sequentially)
                        if not self._admission_check(
                                p.get("best_of", p["n"]), oai=True):
                            return
                        rids = []
                        base_seed = p["kw"].get("seed")
                        for ci in range(p.get("best_of", p["n"])):
                            kw_i = dict(p["kw"])
                            if base_seed is not None:
                                # distinct-but-reproducible candidates
                                kw_i["seed"] = \
                                    (int(base_seed) + ci) % (2 ** 31)
                            rid = outer.engine.submit(
                                p["prompt_ids"], p["max_new"], **kw_i)
                            outer._lat_pending[rid] = [time.monotonic(),
                                                       None]
                            rids.append(rid)
                except (ValueError, TypeError) as e:
                    # bad length / budget, or an extension kwarg this
                    # engine's submit doesn't take (e.g. num_beams on an
                    # engine without beam support)
                    return self._oai_error(400, str(e))
                created = int(time.time())
                if p["stream"]:  # parse guarantees best_of == n here
                    return self._openai_stream(rids, p, chat, created)
                need_lp = (p["logprobs"] is not None
                           or len(rids) > p["n"])
                results, n_out = [], 0
                for rid in rids:
                    try:
                        toks = outer._wait(rid)
                    except RuntimeError as e:  # device worker died
                        return self._oai_error(500, str(e), "server_error")
                    n_out += len(toks)  # usage bills every candidate
                    lps = tops = None
                    if need_lp:
                        with outer._lock:
                            lps = list(outer.engine.logprobs[rid])
                            tops = [list(a) for a in
                                    outer.engine.top_logprobs[rid]]
                    results.append((rid, toks, lps, tops))
                if len(rids) > p["n"]:  # best_of: keep the n best
                    order = _oai.best_of_order([r[2] for r in results])
                    results = [results[j] for j in order[:p["n"]]]
                # echo + logprobs (completions): score the prompt once
                # (same prefix semantics as the engine's own logprobs)
                # and prepend its entries to every choice's arrays
                p_lp = p_tp = None
                if not chat and p["echo"] and p["logprobs"] is not None:
                    p_lp, p_tp = prompt_logprobs(
                        outer.engine.model, outer.engine.params,
                        p["prompt_ids"], p["logprobs"])
                choices = []
                for i, (rid, toks, lps, tops) in enumerate(results):
                    text, finish = _oai.finalize(
                        toks, outer._tokenizer, outer.engine.eos_id,
                        p["stop_strs"])
                    if p["echo"]:
                        text = p["prompt_text"] + text
                    if p.get("tools"):
                        # constrained tool call; None = truncated ->
                        # plain content choice keeps it visible
                        tc = _oai.tool_call_choice(i, rid, text, finish)
                        if tc is not None:
                            choices.append(tc)
                            continue
                    lpobj = None
                    if p["logprobs"] is not None:
                        if chat:
                            lpobj = _oai.chat_logprobs(
                                toks, lps, tops, p["logprobs"],
                                outer._tokenizer, outer.engine.eos_id)
                        else:
                            lpobj = _oai.completion_logprobs(
                                toks, lps, tops, p["logprobs"],
                                outer._tokenizer, outer.engine.eos_id,
                                prompt_toks=(p["prompt_ids"]
                                             if p_lp is not None
                                             else None),
                                prompt_lps=p_lp, prompt_tops=p_tp)
                    choices.append(_oai.make_choice(chat, i, text, finish,
                                                    lpobj))
                build = _oai.chat_body if chat else _oai.completion_body
                self._json(200, build(rids[0], outer._model_name, created,
                                      choices, len(p["prompt_ids"]),
                                      n_out))

            def _embeddings(self) -> None:
                """OpenAI-compatible ``POST /v1/embeddings``: the batch
                of inputs runs as ONE forward pass over the serving
                model (final-LN masked-mean pooling, unit-norm — see
                :mod:`mop_tpu_torch.serving.embeddings`). Embedding forwards
                are one-shot device calls: they dispatch from the
                handler thread and interleave with the decode worker's
                steps at the device queue."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    seqs = parse_embedding_input(req, outer._tokenizer)
                    if len(seqs) > outer._max_embed_inputs:
                        return self._oai_error(
                            400, f"too many inputs: {len(seqs)} > "
                            f"{outer._max_embed_inputs}")
                    emb = outer._embedder()
                    fmt = req.get("encoding_format", "float")
                    dims = req.get("dimensions")
                    dims = None if dims is None else int(dims)
                    vecs = emb.embed(seqs)
                    body = embeddings_body(
                        vecs, outer._model_name, sum(map(len, seqs)),
                        encoding_format=fmt, dimensions=dims)
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._oai_error(400, str(e))
                with outer._lock:
                    outer._embeddings_served += len(seqs)
                return self._json(200, body)

            def _audio_transcription(self) -> None:
                """OpenAI-compatible ``POST /v1/audio/transcriptions``:
                PCM WAV upload -> :func:`mop_tpu_torch.data.audio.log_mel`
                features -> the whisper engine's continuous-batching
                slot pool -> ``{"text": ...}`` (or plain text). Audio
                requests batch with each other and interleave with the
                text engine on the same device-worker thread."""
                weng = outer.whisper_engine
                if weng is None:
                    return self._oai_error(
                        400, "this server was constructed without a "
                             "whisper_engine")
                if outer._whisper_tokenizer is None:
                    return self._oai_error(
                        400, "audio transcription needs a tokenizer "
                             "(whisper_tokenizer= or tokenizer=)")
                if outer._draining:
                    return self._oai_error(
                        503, "server draining (preemption)",
                        "server_error")
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    plan = _oai.parse_transcription(
                        self.headers.get("Content-Type", ""),
                        self.rfile.read(n))
                    try:
                        audio, sr = load_wav(plan["file"])
                    except Exception as e:  # noqa: BLE001 — bad upload
                        raise ValueError(
                            "could not parse the audio file (a PCM WAV "
                            f"is required): {e}")
                    audio = resample(audio, sr, outer._audio_rate)
                    # Long-audio recipe: mel over the WHOLE clip (global
                    # dynamic-range normalization), then sequential
                    # n_audio_ctx-frame windows — each window is one
                    # engine request and they all batch together in the
                    # same slot pool. <= one window degenerates to the
                    # fixed-window path (zero-padded), unchanged.
                    mel_full = log_mel(audio, outer._audio_rate,
                                       n_mels=weng.model.cfg.n_mels)
                    segments = segment_frames(mel_full, weng.t_enc)
                    with outer._lock:
                        if outer._draining:
                            return self._oai_error(
                                503, "server draining (preemption)",
                                "server_error")
                        if outer._step_error is not None:
                            return self._oai_error(
                                500, "device worker failed: "
                                     f"{outer._step_error!r}",
                                "server_error")
                        if len(segments) > outer._max_queue:
                            # NOT retryable overload: this clip can never
                            # fit the queue bound — reject permanently
                            # (429 here would have clients retry forever)
                            return self._oai_error(
                                400,
                                f"audio too long: {len(segments)} "
                                f"{weng.t_enc}-frame windows exceeds the "
                                f"server's max_queue={outer._max_queue}")
                        if not self._admission_check(
                                len(segments), oai=True, engine=weng):
                            return
                        rids = [weng.submit(seg, max_new_tokens=max(
                            1, weng.win - 1)) for seg in segments]
                except (KeyError, ValueError, TypeError) as e:
                    return self._oai_error(400, str(e))
                toks = []
                for rid in rids:
                    try:
                        seg_toks = outer._wait_whisper(rid)
                    except RuntimeError as e:  # device worker died
                        return self._oai_error(500, str(e),
                                               "server_error")
                    if weng.eos_id is not None and seg_toks and \
                            seg_toks[-1] == weng.eos_id:
                        seg_toks = seg_toks[:-1]
                    toks.extend(seg_toks)
                text = outer._whisper_tokenizer.decode(toks)
                if plan["response_format"] == "text":
                    body = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._json(200, {"text": text})

            def _openai_stream(self, rids, p: dict, chat: bool,
                               created: int) -> None:
                """OpenAI SSE chunks; ends with ``data: [DONE]``. Stop
                strings are trimmed on the fly (text that could begin a
                stop string is withheld until disambiguated). With
                ``n > 1`` the choices decode as one batch and their
                chunks interleave, each carrying its choice ``index``
                (the OpenAI multi-choice streaming contract); the one
                shared response id is the first request's."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                tok = outer._tokenizer
                eos = outer.engine.eos_id
                rid0 = rids[0]
                mk = _oai.chat_chunk if chat else _oai.completion_chunk
                # per-choice stream state: the n decodes are independent
                # token streams (partial UTF-8, stop trimming, EOS)
                decs = [tok.stream_decoder()
                        if hasattr(tok, "stream_decoder") else None
                        for _ in rids]
                trims = [_oai.StopTrimmer(p["stop_strs"]) for _ in rids]
                sent = [0] * len(rids)
                saw_eos = [False] * len(rids)
                finished = [False] * len(rids)

                inc_usage = p.get("include_usage", False)

                def emit(i, piece, finish=None):
                    if chat:
                        delta = {"content": piece} if piece else {}
                        ev = mk(rid0, outer._model_name, created, delta,
                                finish, index=i)
                    else:
                        ev = mk(rid0, outer._model_name, created, piece,
                                finish, index=i)
                    if inc_usage:  # the OpenAI contract: data chunks
                        ev["usage"] = None  # carry usage: null
                    self.wfile.write(
                        f"data: {json.dumps(ev)}\n\n".encode())

                try:
                    for i in range(len(rids)):
                        if chat:
                            ev = mk(rid0, outer._model_name, created,
                                    {"role": "assistant"}, None, index=i)
                            if inc_usage:
                                ev["usage"] = None
                            self.wfile.write(
                                f"data: {json.dumps(ev)}\n\n".encode())
                        elif p["echo"]:
                            emit(i, p["prompt_text"])
                    self.wfile.flush()
                    while True:
                        with outer._lock:
                            err = outer._step_error
                            done = [outer.engine.is_done(r) for r in rids]
                            toks = [list(outer.engine.results[r])
                                    for r in rids]
                        if err is not None and not all(done):
                            for i in range(len(rids)):
                                if not finished[i]:
                                    emit(i, "", "error")
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            return
                        wrote = False
                        for i, rid in enumerate(rids):
                            if finished[i]:
                                continue
                            for t in toks[i][sent[i]:]:
                                if eos is not None and t == eos:
                                    saw_eos[i] = True
                                    continue
                                raw = (decs[i].feed(t)
                                       if decs[i] is not None
                                       else tok.decode([t]))
                                piece = trims[i].feed(raw)
                                if piece:
                                    emit(i, piece)
                                    wrote = True
                            sent[i] = len(toks[i])
                            if done[i]:
                                tail = ("" if trims[i].hit
                                        else trims[i].flush())
                                if tail:
                                    emit(i, tail)
                                finish = ("stop" if trims[i].hit
                                          or saw_eos[i] else "length")
                                emit(i, "", finish)
                                finished[i] = True
                                wrote = True
                        if all(finished):
                            if inc_usage:
                                ev = _oai.usage_chunk(
                                    rid0, outer._model_name, created,
                                    chat, len(p["prompt_ids"]),
                                    sum(sent))
                                self.wfile.write(
                                    f"data: {json.dumps(ev)}\n\n"
                                    .encode())
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            return
                        if wrote:
                            self.wfile.flush()
                        time.sleep(outer._poll)
                except OSError:  # client disconnected mid-stream
                    with outer._lock:
                        for rid in rids:
                            if outer.engine.cancel(rid):
                                outer._cancelled += 1
                                outer._lat_pending.pop(rid, None)

            def _stream(self, rid: int, is_text: bool = False) -> None:
                """Server-Sent Events: one event per token as it lands
                (close-delimited body — HTTP/1.0 semantics, no chunked
                framing needed). First event carries the request_id; a
                failed write (client went away) cancels the request so its
                slot frees immediately."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                tok = outer._tokenizer if is_text else None
                dec = (tok.stream_decoder()
                       if tok is not None and hasattr(tok, "stream_decoder")
                       else None)
                sent = 0
                try:
                    self.wfile.write(
                        f"data: {json.dumps({'request_id': rid})}\n\n"
                        .encode())
                    self.wfile.flush()
                    while True:
                        with outer._lock:
                            err = outer._step_error
                            done = outer.engine.is_done(rid)
                            toks = list(outer.engine.results[rid])
                        if err is not None and not done:
                            self.wfile.write(
                                f"data: {json.dumps({'error': repr(err), 'request_id': rid})}\n\n"
                                .encode())
                            self.wfile.flush()
                            return
                        for t in toks[sent:]:
                            ev = {"token": t}
                            if tok is not None:
                                ev["text"] = (dec.feed(t) if dec is not None
                                              else tok.decode([t]))
                            self.wfile.write(
                                f"data: {json.dumps(ev)}\n\n".encode())
                        if sent < len(toks):
                            self.wfile.flush()
                        sent = len(toks)
                        if done:
                            fin = {"done": True, "request_id": rid,
                                   "tokens": toks}
                            if tok is not None:
                                fin["text"] = tok.decode(toks)
                            self.wfile.write(
                                f"data: {json.dumps(fin)}\n\n".encode())
                            self.wfile.flush()
                            return
                        time.sleep(outer._poll)
                except OSError:  # client disconnected mid-stream
                    with outer._lock:
                        if outer.engine.cancel(rid):
                            outer._cancelled += 1
                            outer._lat_pending.pop(rid, None)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]

    # ---------------- lifecycle ----------------

    def _embedder(self) -> EmbeddingModel:
        # double-checked under the engine lock: concurrent first requests
        # on the threaded server must not each build an EmbeddingModel
        # (a duplicate model wrapper each)
        if self._embed_model is None:
            with self._lock:
                if self._embed_model is None:
                    self._embed_model = self._build_embedder()
        return self._embed_model

    def _build_embedder(self) -> EmbeddingModel:
        return EmbeddingModel(self.engine.model, self.engine.params)

    def start(self) -> None:
        """Start the HTTP listener and the device-worker thread."""
        self._running = True
        self._worker = threading.Thread(target=self._work, daemon=True)
        self._worker.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()

    def stop(self) -> None:
        self._running = False
        self._httpd.shutdown()
        self._httpd.server_close()
        self._worker.join(timeout=5)

    # ---------------- graceful drain ----------------

    def drain(self, timeout: Optional[float] = None,
              stop_when_drained: bool = True) -> bool:
        """Stop admitting, finish in-flight requests, then stop the server.

        New ``/generate`` requests get 503 immediately; requests already
        active or queued run to completion (streams keep delivering).
        ``timeout`` bounds the wait — on expiry the stragglers are
        cancelled so a preemption grace window is never overrun.
        Returns True if everything finished, False if cancellation was
        needed. Idempotent; safe from any thread or a signal handler
        via :meth:`install_drain_handler`.
        """
        self._draining = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = not (self.engine.n_active or self.engine.n_queued)
                if idle and self.whisper_engine is not None:
                    idle = not (self.whisper_engine.n_active
                                or self.whisper_engine.n_queued)
            if idle:
                finished = True
                break
            if deadline is not None and time.monotonic() >= deadline:
                with self._lock:
                    for rid, done in list(self.engine._done.items()):
                        if not done:
                            self._cancelled += self.engine.cancel(rid)
                finished = False
                break
            time.sleep(self._poll)
        if stop_when_drained and self._running:
            self.stop()
        self._drained.set()
        return finished

    def install_drain_handler(self, signals=None,
                              timeout: Optional[float] = None) -> None:
        """SIGTERM (default) -> :meth:`drain` on a background thread —
        the serving counterpart of training's ``PreemptionGuard``: the
        spot/maintenance signal finishes in-flight generations
        inside the grace window instead of dropping them."""
        import signal as _signal

        if signals is None:
            signals = (_signal.SIGTERM,)

        def _handler(signum, frame):
            threading.Thread(target=self.drain, kwargs={"timeout": timeout},
                             daemon=True).start()

        for s in signals:
            _signal.signal(s, _handler)

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until a drain (signal- or caller-initiated) completes."""
        return self._drained.wait(timeout)

    # ---------------- internals ----------------

    def _work(self) -> None:
        """The only thread that touches the device: steps the engine
        whenever work is pending, sleeps briefly otherwise. A step()
        exception is fatal for the engine but must not silently kill this
        thread (every waiter would hang forever): it is recorded in
        ``_step_error``, waiters and streams fail fast, and new
        submissions are rejected with 500."""
        with torch.inference_mode():  # grad mode is per thread
            self._work_loop()

    def _work_loop(self) -> None:
        while self._running:
            with self._lock:
                busy = (self._step_error is None
                        and (self.engine.n_queued or self.engine.n_active))
                weng = self.whisper_engine
                wbusy = (self._step_error is None and weng is not None
                         and (weng.n_queued or weng.n_active))
                if busy:
                    done_before = sum(self.engine._done.values())
                    try:
                        if self._spd > 1:
                            self.engine.step(n_tokens=self._spd)
                        else:
                            self.engine.step()
                    except Exception as e:  # noqa: BLE001 — must not hang
                        self._step_error = e
                        continue
                    self._completed += (
                        sum(self.engine._done.values()) - done_before)
                    self._observe_latency_locked(time.monotonic())
                if wbusy:
                    done_before = sum(weng._done.values())
                    try:
                        if self._spd > 1:
                            weng.step(n_tokens=self._spd)
                        else:
                            weng.step()
                    except Exception as e:  # noqa: BLE001 — must not hang
                        self._step_error = e
                        continue
                    self._completed_audio += (
                        sum(weng._done.values()) - done_before)
            if not (busy or wbusy):
                time.sleep(self._poll)

    def _observe_latency_locked(self, now: float) -> None:
        """After an engine step (lock held): record TTFT the first time a
        request has any output, TPOT when it finishes. Granularity is the
        worker's step loop — per-token times within one engine step (e.g.
        a speculative chunk) are averaged, not resolved."""
        finished = []
        for rid, st in self._lat_pending.items():
            toks = self.engine.results.get(rid)
            n = 0 if toks is None else len(toks)
            if st[1] is None and n > 0:
                st[1] = now
                self._hist_ttft.observe(now - st[0])
            if self.engine.is_done(rid):
                if st[1] is not None and n > 1:
                    self._hist_tpot.observe((now - st[1]) / (n - 1))
                finished.append(rid)
        for rid in finished:
            del self._lat_pending[rid]

    def _wait(self, rid: int):
        while True:
            with self._lock:
                if self._step_error is not None:
                    raise RuntimeError(
                        f"device worker failed: {self._step_error!r}")
                if self.engine.is_done(rid):
                    return list(self.engine.results[rid])
            time.sleep(self._poll)

    def _wait_whisper(self, rid: int):
        while True:
            with self._lock:
                if self._step_error is not None:
                    raise RuntimeError(
                        f"device worker failed: {self._step_error!r}")
                if self.whisper_engine.is_done(rid):
                    return list(self.whisper_engine.results[rid])
            time.sleep(self._poll)
