"""JSON-schema guided decoding: schema -> regex -> token DFA.

``json_schema_to_regex(schema)`` compiles a JSON-schema subset into an
anchored regex (in :mod:`~mop_tpu_torch.serving.regex_dfa`'s syntax) matching
exactly the COMPACT (no-whitespace) JSON serializations that satisfy
the schema; ``json_schema_to_dfa(schema, token_strs)`` lifts it onto a
vocabulary for the engines' batched guided-decoding path. This is the
vLLM/outlines ``guided_json`` pattern.

Supported schema subset (conservative by design — generation needs a
regular language, so the compiler REJECTS anything it cannot enforce
exactly rather than silently loosening):

- ``{"type": "object", "properties": {...}}``: all listed properties,
  in listing order (compact JSON, fixed key order — canonical for
  machine consumption). ``required`` may only name listed properties;
  optional properties are NOT supported (dropping a middle key makes
  the comma language context-dependent).
- ``{"type": "string"}``: double-quoted, any chars except ``"``, ``\\``
  and control chars (no escape sequences — conservative); honors
  ``minLength`` / ``maxLength`` / ``pattern`` (the pattern must use
  regex_dfa's syntax and is wrapped unanchored-free, i.e. fullmatch).
- ``{"type": "integer"}``: ``-?(0|[1-9][0-9]*)``.
- ``{"type": "number"}``: JSON number grammar.
- ``{"type": "boolean"}`` / ``{"type": "null"}``.
- ``{"enum": [...]}``: any JSON scalars; matched as exact literals.
- ``{"type": "array", "items": ...}``: honors ``minItems`` /
  ``maxItems``.
- nesting of all of the above.

Beyond-reference capability: the reference has no generation at all
(SURVEY §0; its GPT stops at teacher-forced logits,
``mop/models/gpt_mop.py:181-207``).
"""

from __future__ import annotations

import json

from .regex_dfa import regex_to_dfa

__all__ = ["json_schema_to_regex", "json_schema_to_dfa",
           "tool_call_regex", "tool_call_to_dfa"]

_META = set(r"\.^$*+?{}[]()|")

# double-quoted string body: anything but the quote, the backslash, and
# control chars (conservative: no escape sequences). The control-char
# range is embedded as REAL characters — regex_dfa has no \xNN syntax.
_STR_CHAR = "[^\"\\\\\x00-\x1f]"
_INT = "-?(0|[1-9][0-9]*)"
_NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+\-]?[0-9]+)?"


def _esc(text: str) -> str:
    """Escape ``text`` so it matches literally in regex_dfa syntax."""
    return "".join("\\" + ch if ch in _META else ch for ch in text)


def _string(schema: dict) -> str:
    lo = int(schema.get("minLength", 0))
    hi = schema.get("maxLength")
    if "pattern" in schema:
        if lo or hi is not None:
            raise ValueError(
                "string 'pattern' cannot combine with min/maxLength "
                "(encode the bounds in the pattern)")
        return f'"({schema["pattern"]})"'
    if lo < 0 or (hi is not None and int(hi) < lo):
        raise ValueError(f"bad string length bounds [{lo}, {hi}]")
    if hi is None:
        rep = f"{{{lo},}}" if lo else "*"
    else:
        rep = f"{{{lo},{int(hi)}}}"
    return f'"{_STR_CHAR}{rep}"'


def _enum(values) -> str:
    if not values:
        raise ValueError("empty enum")
    opts = []
    for val in values:
        if isinstance(val, (dict, list)):
            raise ValueError(
                f"enum of composite values is not supported: {val!r}")
        opts.append(_esc(json.dumps(val, separators=(",", ":"))))
    return "(" + "|".join(opts) + ")"


def _array(schema: dict) -> str:
    item = json_schema_to_regex(schema.get("items", {"type": "number"}))
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if lo == 0 and hi == 0:
        return "\\[\\]"
    if lo < 0 or (hi is not None and int(hi) < max(lo, 1)):
        raise ValueError(f"bad array bounds [{lo}, {hi}]")
    if hi is None:
        body = f"{item}(,{item})*" if lo <= 1 else \
            f"{item}(,{item}){{{lo - 1},}}"
    else:
        hi = int(hi)
        body = f"{item}(,{item}){{{max(lo, 1) - 1},{hi - 1}}}"
    return f"\\[({body})?\\]" if lo == 0 else f"\\[{body}\\]"


def _object(schema: dict) -> str:
    props = schema.get("properties")
    if not props:
        raise ValueError(
            "object schemas need non-empty 'properties' (a free-form "
            "object is not a regular language the mask can enforce)")
    extra = set(schema.get("required", ())) - set(props)
    if extra:
        raise ValueError(f"required names unknown properties: "
                         f"{sorted(extra)}")
    if schema.get("additionalProperties", False):
        raise ValueError("additionalProperties is not supported")
    parts = []
    for name, sub in props.items():
        key = _esc(json.dumps(name, separators=(",", ":")))
        parts.append(f"{key}:{json_schema_to_regex(sub)}")
    return "\\{" + ",".join(parts) + "\\}"


def json_schema_to_regex(schema: dict) -> str:
    """Anchored regex (regex_dfa syntax) for the compact JSON texts
    satisfying ``schema`` (see the module docstring for the subset)."""
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be a dict, got {type(schema)}")
    if "enum" in schema:
        return _enum(schema["enum"])
    typ = schema.get("type")
    if typ == "object":
        return _object(schema)
    if typ == "array":
        return _array(schema)
    if typ == "string":
        return _string(schema)
    if typ == "integer":
        return f"({_INT})"
    if typ == "number":
        return f"({_NUMBER})"
    if typ == "boolean":
        return "(true|false)"
    if typ == "null":
        return "null"
    raise ValueError(f"unsupported schema: {schema!r}")


def json_schema_to_dfa(schema: dict, token_strs):
    """Token DFA enforcing ``schema`` over a vocabulary table (see
    :func:`~mop_tpu_torch.serving.regex_dfa.regex_to_dfa`)."""
    return regex_to_dfa(json_schema_to_regex(schema), token_strs)


def tool_call_regex(tools) -> str:
    """Anchored regex for a forced tool call: the compact JSON object
    ``{"name":"<tool>","arguments":<args>}`` where ``<tool>`` ranges
    over ``tools`` (a regex union — the model picks WHICH tool) and
    each tool's arguments satisfy that tool's parameter schema exactly
    (per-branch coupling a single json-schema ``oneOf`` could not
    express in this compiler).

    ``tools``: sequence of ``(name, parameters)`` pairs; ``parameters``
    is a json-schema dict or None. None / ``{}`` / a bare
    ``{"type": "object"}`` with no properties mean the no-argument
    call ``"arguments":{}``."""
    if not tools:
        raise ValueError("no tools to constrain to")
    opts = []
    for name, params in tools:
        key = _esc(json.dumps(name, separators=(",", ":")))
        if not params or not params.get("properties"):
            if params and params.get("type") not in (None, "object"):
                raise ValueError(
                    f"tool '{name}' parameters must be an object "
                    f"schema, got type {params.get('type')!r}")
            args = "\\{\\}"
        else:
            args = json_schema_to_regex(params)
        opts.append('\\{"name":' + key + ',"arguments":' + args + "\\}")
    return "(" + "|".join(opts) + ")"


def tool_call_to_dfa(tools, token_strs):
    """Token DFA for :func:`tool_call_regex` over a vocabulary table."""
    return regex_to_dfa(tool_call_regex(tools), token_strs)


def tool_call_auto_regex(tools) -> str:
    """Anchored regex for ``tool_choice: "auto"``: the union language
    *free text* ∪ *well-formed tool call*. The model decides naturally —
    nothing is constrained until the output commits to the tool-call
    trigger prefix ``{"`` — and from that point the DFA only enforces
    well-formedness (the call must then complete
    ``{"name":...,"arguments":<schema>}`` for one of ``tools``).

    The free-text branch is everything that does NOT start with ``{"``
    (empty, a lone ``{``, any first char other than ``{``, or ``{`` +
    any char other than ``"``) — including newlines: the regex engine's
    ``.`` excludes ``\\n`` (like re without DOTALL), so the continuation
    is spelled ``(.|\\n)*`` or a multi-line answer would be silently
    banned after its first character. The one documented tradeoff: free
    text beginning with the literal two characters ``{"`` is interpreted
    as starting a tool call and must complete one."""
    any_star = "(.|\\n)*"
    free = "(\\{?|[^{]" + any_star + '|\\{[^"]' + any_star + ")"
    return "(" + tool_call_regex(tools) + "|" + free + ")"


def tool_call_auto_to_dfa(tools, token_strs):
    """Token DFA for :func:`tool_call_auto_regex` over a vocabulary."""
    return regex_to_dfa(tool_call_auto_regex(tools), token_strs)
