"""OpenAI-compatible API translation for the serving front-end.

Pure request/response mapping between the public OpenAI REST shapes —
``POST /v1/completions``, ``POST /v1/chat/completions``, ``GET
/v1/models``, including their SSE streaming chunk formats — and the
decode engine's ``submit()`` surface. No device work happens here;
:class:`~mop_tpu_torch.serving.http.ServingServer` routes the endpoints and
this module owns the contract, so it is unit-testable without HTTP.

The reference has no serving story at all (SURVEY §0 — its models stop
at teacher-forced logits); this layer makes the continuous-batching
engine a drop-in backend for the ecosystem of OpenAI-client tooling
(openai-python, LangChain, curl recipes).

Field mapping:

- ``prompt`` (string or token-id list) / ``messages`` (rendered through
  a chat template; see :func:`default_chat_template`) -> prompt ids.
- ``max_tokens`` -> ``max_new_tokens`` (OpenAI default 16).
- ``temperature`` / ``top_p`` / ``presence_penalty`` /
  ``frequency_penalty`` / ``logit_bias`` -> the same-named per-request
  engine params (``logit_bias`` keys arrive as strings per the wire
  format).
- ``stop`` (string or up to 4 strings): each is tokenizer-encoded and
  passed as a token-level stop sequence, and the decoded output is cut
  at the first occurrence of any stop string (the OpenAI contract:
  stop text is excluded from the response). Token-level matching can
  miss a stop string that the model emits across a different BPE
  segmentation; the host-side text cut still trims it from the output,
  but generation then ran to another limit first.
- ``echo`` (completions only): prompt text is prepended (streamed
  first, in streaming mode).
- ``stream``: SSE chunks in the OpenAI shapes, terminated by
  ``data: [DONE]``.

- ``response_format``: ``{"type": "text"}`` is a no-op;
  ``{"type": "json_schema", "json_schema": {"schema": {...}}}`` compiles
  the schema to a token-level DFA
  (:func:`mop_tpu_torch.serving.json_schema.json_schema_to_dfa`) so the
  output is guaranteed to match the schema — the constrained request
  batches with unconstrained ones in the same device step.
  ``"json_object"`` (free-form JSON, unbounded nesting) is rejected:
  the DFA compiler is regular-language-exact and we never silently
  loosen a constraint.

- ``logprobs``: completions take an integer 0..5 (alternatives per
  token); chat takes ``logprobs: true`` + ``top_logprobs`` 0..20.
  Requires the engine to have been built with ``logprobs_topk >=``
  the requested count. Values are the raw model distribution (fp32
  log-softmax before temperature/penalties/bias — the engine
  contract); blocking responses only (stream + logprobs is rejected).

- ``n`` (1..8): each choice is an independent engine request sharing
  the slot pool — they decode as one batch, not sequentially.
  Temperature 0 gives ``n`` identical choices (greedy), like the
  upstream API. Streaming interleaves the choices' chunks, each
  carrying its ``index`` (the OpenAI multi-choice SSE contract).

- ``best_of`` (completions only, n..8): ``best_of`` candidates decode
  server-side as one batch; the ``n`` with the highest mean token
  logprob are returned (OpenAI's "highest log probability per token"
  rule). Needs an engine built with ``logprobs_topk > 0`` — the
  ranking key is the raw-model chosen-token logprob the engine already
  tracks. ``usage.completion_tokens`` counts ALL candidates (they all
  decoded — the upstream billing convention). Blocking only.

- ``tools`` + ``tool_choice`` (chat): tool calls ride guided decoding.
  FORCED (``"required"`` or a named function): the tool-call JSON
  ``{"name":...,"arguments":...}`` is compiled to a token DFA (union
  over the tools for ``"required"``), so ``message.tool_calls[0]``'s
  arguments are GUARANTEED to satisfy that tool's parameter schema;
  finish_reason ``"tool_calls"``. ``"auto"`` (the OpenAI default with
  tools present) uses the union DFA *free text ∪ tool grammar*
  (``json_schema.tool_call_auto_regex``): the model decides naturally,
  and the constraint only enforces well-formedness once the output
  commits to the ``{"`` trigger — free-text answers come back as plain
  content, started calls are guaranteed complete + schema-valid.
  ``"none"`` ignores the tools. Blocking only; truncated calls come
  back as plain content with the real finish_reason.

Explicitly rejected rather than silently ignored: ``n`` > 8,
``best_of`` < ``n`` or > 8 or exceeding ``n`` with
``stream`` or on chat, ``suffix``, ``functions`` /
``function_call`` (legacy), tools with
``stream`` or on completions, ``response_format`` type
``json_object``, ``logprobs`` combined with ``stream``.
``finish_reason`` is ``"stop"`` (EOS or stop sequence) or ``"length"``
(``max_tokens`` or the context window). ``usage`` counts prompt and
completion tokens exactly as submitted/emitted.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "parse_completion", "parse_chat", "default_chat_template",
    "finalize", "StopTrimmer", "completion_body", "chat_body",
    "completion_chunk", "chat_chunk", "models_body",
    "completion_logprobs", "chat_logprobs", "make_choice",
    "best_of_order", "tool_call_choice", "usage_chunk",
    "parse_transcription",
]

_UNSUPPORTED = ("suffix", "functions", "function_call")


def _parse_response_format(req: dict):
    """``response_format`` -> JSON schema dict or None. Only shapes we
    can honor exactly are accepted (``text`` no-op, ``json_schema``
    compiled to a token DFA downstream)."""
    rf = req.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict) or "type" not in rf:
        raise ValueError("response_format must be an object with 'type'")
    kind = rf["type"]
    if kind == "text":
        return None
    if kind == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict) or not isinstance(js.get("schema"),
                                                      dict):
            raise ValueError(
                "response_format.json_schema must be an object with a "
                "'schema' object")
        return js["schema"]
    raise ValueError(
        f"response_format type '{kind}' is not supported (use 'text' or "
        "'json_schema'; free-form 'json_object' cannot be honored "
        "exactly by the regular-language constraint compiler)")


def _parse_tools(req: dict):
    """``tools`` + ``tool_choice`` -> ``{"mode": "forced"|"auto",
    "tools": [(name, parameters), ...]}`` to constrain generation with,
    or None (no tool constraint). Forced = ``tool_choice`` names one
    function or is ``"required"`` (the model picks among the tools via a
    union DFA; the output IS a tool call). ``"auto"`` (and the OpenAI
    default when ``tools`` is present) constrains to *free text ∪
    tool-call grammar* (:func:`~mop_tpu_torch.serving.json_schema.
    tool_call_auto_regex`): the model decides whether to call, and the
    DFA only enforces well-formedness once the output commits to the
    ``{"`` trigger. ``"none"`` ignores the tools."""
    tools = req.get("tools")
    tc = req.get("tool_choice")
    if tools is None:
        if tc is not None:
            raise ValueError("'tool_choice' requires 'tools'")
        return None
    if not isinstance(tools, list) or not tools:
        raise ValueError("'tools' must be a non-empty list")
    byname: Dict[str, Optional[dict]] = {}
    for t in tools:
        fn = t.get("function") if isinstance(t, dict) else None
        if not isinstance(t, dict) or t.get("type") != "function" or \
                not isinstance(fn, dict) or not fn.get("name"):
            raise ValueError(
                "each tool must be {'type': 'function', 'function': "
                "{'name': ..., 'parameters': {...}}}")
        byname[fn["name"]] = fn.get("parameters")
    if tc is None or tc == "auto":
        return {"mode": "auto", "tools": list(byname.items())}
    if tc == "none":
        return None
    if tc == "required":
        return {"mode": "forced", "tools": list(byname.items())}
    if isinstance(tc, dict):
        name = (tc.get("function") or {}).get("name") \
            if isinstance(tc.get("function"), dict) else None
        if tc.get("type") != "function" or not name:
            raise ValueError(
                "tool_choice object must be {'type': 'function', "
                "'function': {'name': ...}}")
        if name not in byname:
            raise ValueError(f"tool_choice names unknown tool '{name}'")
        return {"mode": "forced", "tools": [(name, byname[name])]}
    raise ValueError(f"unsupported tool_choice: {tc!r}")


def default_chat_template(messages: Sequence[dict]) -> str:
    """Render chat messages as role-tagged plain-text lines ending with
    an ``assistant:`` cue — a trainable format for the char/BPE toy
    models. Pass ``chat_template=`` to :class:`ServingServer` for
    anything model-specific."""
    lines = []
    for m in messages:
        lines.append(f"{m['role']}: {m['content']}\n")
    lines.append("assistant:")
    return "".join(lines)


def _common(req: dict, tokenizer, allow_best_of: bool = False) -> tuple:
    """Shared sampling/limit parsing. Returns (max_new, kw, stop_strs,
    stream, schema, n, best_of). Raises ValueError on anything we can't
    honor exactly."""
    n = int(req.get("n") or 1)
    if not 1 <= n <= 8:
        raise ValueError(f"n must be in [1, 8], got {n}")
    best_of = int(req.get("best_of") or n)
    if not allow_best_of:
        if int(req.get("best_of") or 1) != 1:
            raise ValueError(
                "'best_of' is a completions-only parameter")
        best_of = n
    else:
        if best_of < n:
            raise ValueError(f"best_of ({best_of}) must be >= n ({n})")
        if best_of > 8:
            raise ValueError(f"best_of must be in [n, 8], got {best_of}")
        if best_of > n and req.get("stream"):
            raise ValueError("best_of > n with stream is not supported")
    for key in _UNSUPPORTED:
        if req.get(key) is not None:
            raise ValueError(f"'{key}' is not supported")
    kw: Dict[str, object] = {}
    for key, cast in (("temperature", float), ("top_p", float),
                      ("presence_penalty", float),
                      ("frequency_penalty", float)):
        if req.get(key) is not None:
            kw[key] = cast(req[key])
    if req.get("logit_bias") is not None:
        kw["logit_bias"] = {int(t): float(v)
                            for t, v in req["logit_bias"].items()}
    if req.get("seed") is not None:
        # exact (not best-effort) determinism: the engine pins the
        # request's sample stream to the seed (engine.submit docstring);
        # with n/best_of > 1 each candidate gets seed + choice index so
        # choices stay distinct yet reproducible (http.py submit loop)
        kw["seed"] = int(req["seed"])
    stop = req.get("stop")
    if stop is None:
        stop_strs: List[str] = []
    elif isinstance(stop, str):
        stop_strs = [stop]
    else:
        stop_strs = [str(s) for s in stop]
    if len(stop_strs) > 4:
        raise ValueError("at most 4 stop sequences are supported")
    if any(not s for s in stop_strs):
        raise ValueError("stop sequences must be non-empty strings")
    if stop_strs:
        seqs = [tokenizer.encode(s) for s in stop_strs]
        if any(not s for s in seqs):
            raise ValueError("a stop sequence encoded to zero tokens")
        kw["stop"] = seqs
    max_new = req.get("max_tokens")
    max_new = 16 if max_new is None else int(max_new)  # 0 stays invalid
    stream = bool(req.get("stream", False))
    # extension fields (not in the upstream API): per-request beam search
    # mapped onto the engine's beam groups. Deterministic and
    # whole-result: no stream, no n/best_of fan-out, no sampling knobs
    # (the engine's own submit validation covers those), no logprobs
    # (beams track none).
    if req.get("num_beams") is not None:
        nb = int(req["num_beams"])
        if not 1 <= nb <= 16:
            raise ValueError(f"num_beams must be in [1, 16], got {nb}")
        if stream:
            raise ValueError("num_beams with stream is not supported")
        if n != 1 or best_of != 1:
            raise ValueError("num_beams cannot combine with n/best_of")
        if req.get("logprobs"):
            raise ValueError("num_beams with logprobs is not supported")
        kw["num_beams"] = nb
        if req.get("length_penalty") is not None:
            kw["length_penalty"] = float(req["length_penalty"])
    elif req.get("length_penalty") is not None:
        raise ValueError("length_penalty requires num_beams")
    so = req.get("stream_options")
    include_usage = False
    if so is not None:
        if not isinstance(so, dict):
            raise ValueError("stream_options must be an object")
        if not stream:
            raise ValueError("stream_options requires stream")
        unknown = set(so) - {"include_usage"}
        if unknown:
            raise ValueError(
                f"unsupported stream_options: {sorted(unknown)}")
        include_usage = bool(so.get("include_usage"))
    return (max_new, kw, stop_strs, stream,
            _parse_response_format(req), n, best_of, include_usage)


def parse_completion(req: dict, tokenizer) -> dict:
    """``/v1/completions`` request -> submit plan. ``prompt`` may be a
    string or a token-id list (both OpenAI-legal)."""
    prompt = req.get("prompt")
    if prompt is None:
        raise ValueError("'prompt' is required")
    if isinstance(prompt, str):
        prompt_ids = tokenizer.encode(prompt)
        prompt_text = prompt
    elif isinstance(prompt, list) and all(
            isinstance(t, int) for t in prompt):
        prompt_ids = list(prompt)
        prompt_text = tokenizer.decode(prompt_ids)
    else:
        raise ValueError("prompt must be a string or a list of token ids")
    if not prompt_ids:
        raise ValueError("prompt encoded to zero tokens")
    for key in ("tools", "tool_choice"):  # chat-only in the OpenAI API
        if req.get(key) is not None:
            raise ValueError(f"'{key}' is a chat-completions parameter")
    max_new, kw, stop_strs, stream, schema, n, best_of, inc_usage = \
        _common(req, tokenizer, allow_best_of=True)
    lp = req.get("logprobs")
    if lp is not None:
        if isinstance(lp, bool) or not isinstance(lp, int) or \
                not 0 <= lp <= 5:
            raise ValueError(
                "completions 'logprobs' must be an integer in [0, 5] "
                "(the number of alternatives per token)")
    return {"prompt_ids": prompt_ids, "prompt_text": prompt_text,
            "max_new": max_new, "kw": kw, "stop_strs": stop_strs,
            "stream": stream, "echo": bool(req.get("echo", False)),
            "json_schema": schema, "logprobs": lp, "n": n,
            "best_of": best_of, "include_usage": inc_usage}


def parse_chat(req: dict, tokenizer,
               template: Optional[Callable] = None) -> dict:
    """``/v1/chat/completions`` request -> submit plan."""
    messages = req.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ValueError("'messages' must be a non-empty list")
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ValueError("each message needs 'role' and 'content'")
    if req.get("echo"):
        raise ValueError("'echo' is not supported for chat completions")
    text = (template or default_chat_template)(messages)
    prompt_ids = tokenizer.encode(text)
    if not prompt_ids:
        raise ValueError("messages encoded to zero tokens")
    max_new, kw, stop_strs, stream, schema, n, best_of, inc_usage = \
        _common(req, tokenizer)
    lp = None
    if req.get("logprobs") is not None:
        if req["logprobs"] is not True:
            raise ValueError("chat 'logprobs' must be true when present")
        top = req.get("top_logprobs", 0)
        if isinstance(top, bool) or not isinstance(top, int) or \
                not 0 <= top <= 20:
            raise ValueError("'top_logprobs' must be an integer in "
                             "[0, 20]")
        lp = top
    elif req.get("top_logprobs") is not None:
        raise ValueError("'top_logprobs' requires 'logprobs': true")
    tools = _parse_tools(req)
    if tools is not None:
        if stream:
            raise ValueError("tools with stream is not supported")
        if schema is not None:
            raise ValueError("tools cannot combine with "
                             "response_format json_schema (two output "
                             "constraints)")
    return {"prompt_ids": prompt_ids, "prompt_text": text,
            "max_new": max_new, "kw": kw, "stop_strs": stop_strs,
            "stream": stream, "echo": False, "json_schema": schema,
            "logprobs": lp, "n": n, "best_of": best_of, "tools": tools,
            "include_usage": inc_usage}


def finalize(toks: Sequence[int], tokenizer, eos_id: Optional[int],
             stop_strs: Sequence[str]) -> tuple:
    """Emitted tokens -> (text, finish_reason) with the OpenAI trimming
    contract: the EOS token and any matched stop text are excluded."""
    out = list(toks)
    finish = "length"
    if eos_id is not None and out and out[-1] == eos_id:
        out = out[:-1]
        finish = "stop"
    text = tokenizer.decode(out)
    for s in stop_strs:
        i = text.find(s)
        if i >= 0:
            text = text[:i]
            finish = "stop"
            break
    return text, finish


class StopTrimmer:
    """Streaming-side stop-string cut: withholds any emitted-text suffix
    that could begin a stop string, cuts at the first full match.

    ``feed(piece) -> safe-to-emit text``; ``hit`` is True once a stop
    matched (everything after the cut is discarded); ``flush()`` releases
    the held tail when generation ends for another reason."""

    def __init__(self, stops: Sequence[str]):
        self.stops = [s for s in stops if s]
        self.buf = ""
        self.hit = False

    def feed(self, piece: str) -> str:
        if self.hit:
            return ""
        if not self.stops:
            return piece
        self.buf += piece
        for s in self.stops:
            i = self.buf.find(s)
            if i >= 0:
                out, self.buf, self.hit = self.buf[:i], "", True
                return out
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        cut = len(self.buf) - hold
        out, self.buf = self.buf[:cut], self.buf[cut:]
        return out

    def flush(self) -> str:
        out, self.buf = self.buf, ""
        return out


def tool_call_choice(index: int, rid: int, text: str,
                     finish: str) -> Optional[dict]:
    """Constrained ``{"name":...,"arguments":...}`` output -> an OpenAI
    chat choice with ``message.tool_calls`` and finish_reason
    ``"tool_calls"``. Returns None when the text is not a complete tool
    call (``max_tokens``/window truncated the constrained generation —
    the caller falls back to a plain content choice so truncation stays
    visible, the upstream behavior)."""
    try:
        obj = json.loads(text)
        name, args = obj["name"], obj["arguments"]
    except (ValueError, KeyError, TypeError):
        return None
    call = {"id": f"call_{rid}_{index}", "type": "function",
            "function": {"name": name,
                         "arguments": json.dumps(
                             args, separators=(",", ":"))}}
    return {"index": index,
            "message": {"role": "assistant", "content": None,
                        "tool_calls": [call]},
            "logprobs": None, "finish_reason": "tool_calls"}


def parse_transcription(content_type: str, body: bytes) -> dict:
    """``POST /v1/audio/transcriptions`` multipart body -> plan dict
    ``{"file": bytes, "response_format": "json"|"text"}``.

    Accepted fields: ``file`` (required — a PCM WAV upload), ``model``
    (accepted and ignored; the server advertises its own),
    ``response_format`` ``json`` (default) or ``text``, and
    ``temperature`` 0 (the engine decodes greedily). Anything we cannot
    honor exactly — other response formats, ``language`` / ``prompt``
    conditioning, ``timestamp_granularities`` — is rejected, never
    silently ignored."""
    import email.parser
    import email.policy

    if not content_type or not content_type.strip().lower().startswith(
            "multipart/form-data"):
        raise ValueError("audio transcription requires a "
                         "multipart/form-data body")
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1")
        + b"\r\n\r\n" + body)
    fields: Dict[str, str] = {}
    file_bytes = None
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name == "file":
            file_bytes = part.get_payload(decode=True)
        elif name:
            payload = part.get_payload(decode=True)
            fields[str(name)] = (payload or b"").decode(
                "utf-8", "replace").strip()
    if not file_bytes:
        raise ValueError("missing 'file' part")
    for key in ("language", "prompt", "timestamp_granularities"):
        if key in fields:
            raise ValueError(f"'{key}' is not supported")
    unknown = set(fields) - {"model", "response_format", "temperature"}
    if unknown:
        raise ValueError(f"unsupported fields: {sorted(unknown)}")
    if fields.get("temperature") not in (None, "", "0", "0.0"):
        raise ValueError("only temperature 0 is supported (the "
                         "transcription engine decodes greedily)")
    rf = fields.get("response_format", "json")
    if rf not in ("json", "text"):
        raise ValueError(f"response_format '{rf}' is not supported "
                         "(use 'json' or 'text')")
    return {"file": file_bytes, "response_format": rf}


def best_of_order(token_logprobs: Sequence[Sequence[float]]) -> List[int]:
    """``best_of`` candidate ranking: indices sorted by mean
    chosen-token logprob, highest first (OpenAI's "highest log
    probability per token"). Ties keep submit order; an empty candidate
    ranks last."""
    def mean(lps):
        return sum(lps) / len(lps) if lps else float("-inf")
    return sorted(range(len(token_logprobs)),
                  key=lambda i: -mean(token_logprobs[i]))


# ---------------- logprobs ----------------


def _visible(toks, lps, tops, eos_id):
    """Drop the trailing EOS entry (excluded from the completion text,
    so excluded from the logprob arrays too — they stay 1:1 with the
    visible tokens). When a stop STRING cut the text, the arrays still
    cover every emitted token (token-level data is not re-segmented to
    the text cut)."""
    if eos_id is not None and toks and toks[-1] == eos_id:
        return toks[:-1], lps[:-1], tops[:-1]
    return list(toks), list(lps), list(tops)


def completion_logprobs(toks, lps, tops, n_top: int, tokenizer,
                        eos_id, prompt_toks=None, prompt_lps=None,
                        prompt_tops=None) -> dict:
    """Engine logprob arrays -> the completions-API ``logprobs`` object
    (parallel ``tokens`` / ``token_logprobs`` / ``top_logprobs`` /
    ``text_offset`` arrays). Values are the engine's raw-model fp32
    log-softmax (see ``DecodeEngine(logprobs_topk=...)``).

    ``prompt_*`` (echo mode): prompt-token entries from
    :func:`mop_tpu_torch.serving.scoring.prompt_logprobs` are prepended —
    ``token_logprobs[0]`` is null and offsets start at the echoed text's
    position 0, the upstream ``echo`` + ``logprobs`` contract."""
    toks, lps, tops = _visible(toks, lps, tops, eos_id)
    if prompt_toks:
        toks = list(prompt_toks) + toks
        lps = list(prompt_lps) + lps
        tops = list(prompt_tops) + tops
    strs = [tokenizer.decode([t]) for t in toks]
    offsets, pos = [], 0
    for s in strs:
        offsets.append(pos)
        pos += len(s)
    out = {"tokens": strs, "token_logprobs": lps,
           "top_logprobs": None, "text_offset": offsets}
    if n_top > 0:
        # the wire format keys alternatives by token STRING; distinct ids
        # can decode to the same string (byte-level partial UTF-8 all
        # render as U+FFFD) — keep the highest logprob per string
        rows = []
        for alts, lp in zip(tops, lps):
            if lp is None:  # echoed first prompt token: null, like upstream
                rows.append(None)
                continue
            d: Dict[str, float] = {}
            for t, v in alts[:n_top]:
                d.setdefault(tokenizer.decode([t]), v)
            rows.append(d)
        out["top_logprobs"] = rows
    return out


def chat_logprobs(toks, lps, tops, n_top: int, tokenizer, eos_id) -> dict:
    """Engine logprob arrays -> the chat-API ``logprobs`` object
    (``content``: one entry per visible token, each with its own
    ``top_logprobs`` list)."""
    toks, lps, tops = _visible(toks, lps, tops, eos_id)
    content = []
    for t, lp, alts in zip(toks, lps, tops):
        content.append({
            "token": tokenizer.decode([t]), "logprob": lp,
            "top_logprobs": [
                {"token": tokenizer.decode([a]), "logprob": v}
                for a, v in alts[:n_top]]})
    return {"content": content}


# ---------------- response bodies ----------------


def _usage(n_prompt: int, n_out: int) -> dict:
    return {"prompt_tokens": n_prompt, "completion_tokens": n_out,
            "total_tokens": n_prompt + n_out}


def make_choice(chat: bool, index: int, text: str, finish: str,
                logprobs: Optional[dict] = None) -> dict:
    """One entry of a response's ``choices`` array (``n`` requests give
    ``n`` of these, index 0..n-1)."""
    if chat:
        return {"index": index,
                "message": {"role": "assistant", "content": text},
                "logprobs": logprobs, "finish_reason": finish}
    return {"index": index, "text": text, "logprobs": logprobs,
            "finish_reason": finish}


def completion_body(rid: int, model: str, created: int,
                    choices: List[dict], n_prompt: int,
                    n_out: int) -> dict:
    """``n_prompt`` is counted once however many choices there are (the
    OpenAI usage convention); ``n_out`` is the total across choices."""
    return {"id": f"cmpl-{rid}", "object": "text_completion",
            "created": created, "model": model, "choices": choices,
            "usage": _usage(n_prompt, n_out)}


SYSTEM_FINGERPRINT = "fp_mop_tpu"
"""Returned on chat responses (the OpenAI field that accompanies
``seed``): one static backend id — this server has no fleet of
heterogeneous backends, so determinism is per-seed, not per-deploy."""


def chat_body(rid: int, model: str, created: int, choices: List[dict],
              n_prompt: int, n_out: int) -> dict:
    return {"id": f"chatcmpl-{rid}", "object": "chat.completion",
            "created": created, "model": model, "choices": choices,
            "system_fingerprint": SYSTEM_FINGERPRINT,
            "usage": _usage(n_prompt, n_out)}


def completion_chunk(rid: int, model: str, created: int, piece: str,
                     finish: Optional[str] = None,
                     index: int = 0) -> dict:
    return {"id": f"cmpl-{rid}", "object": "text_completion",
            "created": created, "model": model,
            "choices": [{"index": index, "text": piece, "logprobs": None,
                         "finish_reason": finish}]}


def chat_chunk(rid: int, model: str, created: int, delta: dict,
               finish: Optional[str] = None, index: int = 0) -> dict:
    return {"id": f"chatcmpl-{rid}", "object": "chat.completion.chunk",
            "created": created, "model": model,
            "system_fingerprint": SYSTEM_FINGERPRINT,
            "choices": [{"index": index, "delta": delta,
                         "finish_reason": finish}]}


def usage_chunk(rid: int, model: str, created: int, chat: bool,
                n_prompt: int, n_out: int) -> dict:
    """The final ``stream_options.include_usage`` chunk: empty
    ``choices``, the request's full usage (prompt counted once,
    completions across choices — same as the blocking body)."""
    if chat:
        return {"id": f"chatcmpl-{rid}",
                "object": "chat.completion.chunk", "created": created,
                "model": model, "choices": [],
                "usage": _usage(n_prompt, n_out)}
    return {"id": f"cmpl-{rid}", "object": "text_completion",
            "created": created, "model": model, "choices": [],
            "usage": _usage(n_prompt, n_out)}


def models_body(model: str, created: int) -> dict:
    return {"object": "list",
            "data": [{"id": model, "object": "model", "created": created,
                      "owned_by": "mop-tpu"}]}
