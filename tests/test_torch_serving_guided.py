"""Guided decoding in the port: the numpy-only modules (``constrain``,
``regex_dfa``, ``json_schema``) build the automata the JAX package's build,
and the port's ``DecodeEngine`` under a choice, token-set, regex and JSON
schema constraint emits the greedy tokens JAX's ``DecodeEngine`` emits over
the same weights and automata, each output legal for its automaton."""

import json

import jax
import pytest

import mop_tpu.serving as JS
import mop_tpu_torch.serving as PS
from mop_tpu.serving.json_schema import tool_call_auto_to_dfa as jax_tool_auto
from mop_tpu_torch.serving import (DecodeEngine, choices, json_schema_to_dfa,
                                   json_schema_to_regex, regex_to_dfa, token_set)
from mop_tpu_torch.serving.json_schema import tool_call_auto_to_dfa

from _torch_serving_common import _one_torch_thread, lm_pair, prompts_of, to_torch  # noqa: F401

EOS = 0
# id -> text: 0 is EOS (no text), then single characters, then a few longer pieces
ALPHABET = sorted(set('{}[]":,-0123456789truefalsxynokg'))
TOKEN_STRS = [""] + ALPHABET + ['"n":', "true", '"tag":"']
TOKEN_STRS += ["~"] * (40 - len(TOKEN_STRS))
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "n": {"enum": [0, 12, 345]},
                                           "tag": {"enum": ["x", "y"]}}}
TOOLS = [("f", {"type": "object", "properties": {"n": {"enum": [1, 2]}}}), ("g", None)]


def _same(a, b):
    assert a.transitions == b.transitions and a.start == b.start and a.accept == b.accept


def test_automata_equal_jax():
    _same(choices([[3, 4, 5], [3, 4, 9], [7]]), JS.choices([[3, 4, 5], [3, 4, 9], [7]]))
    _same(token_set([2, 3], min_len=2, max_len=3), JS.token_set([2, 3], min_len=2, max_len=3))
    for pattern in ("(ab|a)c*", "[0-9]{2,3}", "x?y+"):
        _same(regex_to_dfa(pattern, TOKEN_STRS), JS.regex_to_dfa(pattern, TOKEN_STRS))
    assert json_schema_to_regex(SCHEMA) == JS.json_schema_to_regex(SCHEMA)
    _same(json_schema_to_dfa(SCHEMA, TOKEN_STRS), JS.json_schema_to_dfa(SCHEMA, TOKEN_STRS))
    _same(tool_call_auto_to_dfa(TOOLS, TOKEN_STRS), jax_tool_auto(TOOLS, TOKEN_STRS))
    with pytest.raises(ValueError):
        choices([])


def _requests(lib):
    return [(lib.choices([[5, 6, 7], [5, 8], [9]]), 6),
            (lib.token_set([10, 11, 12], min_len=2, max_len=4), 6),
            (lib.regex_to_dfa("[0-9]{2,3}x", TOKEN_STRS), 6),
            (lib.json_schema_to_dfa(SCHEMA, TOKEN_STRS), 40)]


def _serve(eng, lib):
    rids = [eng.submit(p, n, constraint=dfa)
            for p, (dfa, n) in zip(prompts_of([3, 5, 4, 6], seed=120), _requests(lib))]
    eng.submit(prompts_of([4], seed=121)[0], 6)  # an unconstrained neighbour
    res = eng.run()
    return [res[r] for r in rids]


def test_constrained_outputs_equal_jax_engine():
    jm, jp, pm = lm_pair("baseline", scale=2.0, block_size=64)
    pp = to_torch(jax.device_get(jp))
    want = _serve(JS.DecodeEngine(jm, jp, max_batch=3, eos_id=EOS, prefill_buckets=[8]), JS)
    got = _serve(DecodeEngine(pm, pp, max_batch=3, eos_id=EOS), PS)
    assert got == want
    for out, (dfa, _) in zip(got, _requests(JS)):  # each output walks its automaton
        state = dfa.init_state()
        for t in out[:-1] if out[-1] == EOS else out:
            state = dfa.advance(state, t)
            assert state is not None
        if out[-1] == EOS:
            assert dfa.accepts(state)
    if got[3][-1] == EOS:
        text = "".join(TOKEN_STRS[t] for t in got[3][:-1])
        assert set(json.loads(text)) <= set(SCHEMA["properties"])


def test_constraint_checks():
    _, _, pm = lm_pair("baseline")
    eng = DecodeEngine(pm, None, max_batch=1)
    with pytest.raises(ValueError, match="eos_id"):
        eng.submit([1, 2], 4, constraint=choices([[3]]))
    with pytest.raises(ValueError, match="transition token"):
        eng.submit([1, 2], 4, eos_id=3, constraint=choices([[3, 4]]))
    with pytest.raises(ValueError, match="outside vocab"):
        eng.submit([1, 2], 4, eos_id=0, constraint=choices([[41]]))
