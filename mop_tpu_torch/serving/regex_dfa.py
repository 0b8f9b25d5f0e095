"""Regex -> token-DFA compilation for guided decoding.

``regex_to_dfa(pattern, token_strs)`` compiles an ANCHORED regular
expression into a :class:`~mop_tpu_torch.serving.constrain.TokenDFA` over the
given vocabulary: the concatenation of the decoded strings of the
emitted token ids must fully match ``pattern``, then EOS. This is the
outlines/vLLM guided-regex pattern (character automaton lifted to token
granularity), feeding the engine's batched 0/-inf logit-mask path — no
per-request device work, constrained rows ride the same fixed-shape
step as everything else (serving/constrain.py).

Pipeline: parse the pattern to an AST -> Thompson-construct an
epsilon-NFA -> run the subset construction LAZILY while lifting to
tokens (a token edge walks the token's characters through the char
automaton; the token is legal iff no step dead-ends) -> iteratively
prune token-level states that cannot terminate (non-accepting, no
outgoing edges) so the resulting DFA never dead-ends mid-decode.

Supported syntax: literals, ``.`` (any char but newline), escapes
(``\\d \\w \\s \\D \\W \\S \\n \\t \\r`` + escaped metachars), char
classes ``[a-z0-9_]`` / negated ``[^...]``, groups ``(...)``,
alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}``. Patterns are
implicitly anchored; ``^``/``$`` are rejected.

Beyond-reference capability: the reference has no generation at all
(SURVEY §0; its GPT stops at teacher-forced logits,
``mop/models/gpt_mop.py:181-207``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List, Sequence, Tuple

from .constrain import TokenDFA

__all__ = ["regex_to_dfa"]

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")
_ESC_CLASS = {"d": ("in", _DIGITS), "D": ("notin", _DIGITS),
              "w": ("in", _WORD), "W": ("notin", _WORD),
              "s": ("in", _SPACE), "S": ("notin", _SPACE)}
_ESC_CHAR = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v", "0": "\0"}

# a predicate is ('in', frozenset) or ('notin', frozenset)
_Pred = Tuple[str, FrozenSet[str]]


def _match(pred: _Pred, ch: str) -> bool:
    kind, chars = pred
    return (ch in chars) if kind == "in" else (ch not in chars)


# ---------------- pattern -> AST ----------------
# AST nodes: ('lit', pred) | ('cat', [nodes]) | ('alt', [nodes])
#          | ('rep', node, min, max|None)

class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str):
        raise ValueError(f"bad pattern at index {self.i}: {msg} "
                         f"(pattern {self.p!r})")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        ch = self.peek()
        if ch is None:
            self.error("unexpected end")
        self.i += 1
        return ch

    def parse(self):
        ast = self._alt()
        if self.i != len(self.p):
            self.error(f"unexpected {self.p[self.i]!r}")
        return ast

    def _alt(self):
        branches = [self._cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items: List = []
        while self.peek() is not None and self.peek() not in "|)":
            items.append(self._repeat())
        return ("cat", items)  # empty cat = empty string (e.g. "(a|)")

    def _repeat(self):
        atom = self._atom()
        ch = self.peek()
        if ch == "*":
            self.take()
            return ("rep", atom, 0, None)
        if ch == "+":
            self.take()
            return ("rep", atom, 1, None)
        if ch == "?":
            self.take()
            return ("rep", atom, 0, 1)
        if ch == "{":
            self.take()
            lo = self._int()
            hi: int | None = lo
            if self.peek() == ",":
                self.take()
                hi = self._int() if self.peek() != "}" else None
            if self.take() != "}":
                self.error("expected '}'")
            if hi is not None and hi < lo:
                self.error(f"bad repetition bounds {{{lo},{hi}}}")
            return ("rep", atom, lo, hi)
        return atom

    def _int(self) -> int:
        ds = ""
        while self.peek() is not None and self.peek().isdigit():
            ds += self.take()
        if not ds:
            self.error("expected a number")
        return int(ds)

    def _atom(self):
        ch = self.take()
        if ch == "(":
            inner = self._alt()
            if self.take() != ")":
                self.error("expected ')'")
            return inner
        if ch == "[":
            return ("lit", self._char_class())
        if ch == ".":
            return ("lit", ("notin", frozenset("\n")))
        if ch == "\\":
            return ("lit", self._escape())
        if ch in "*+?{":
            self.error(f"quantifier {ch!r} with nothing to repeat")
        if ch in "^$":
            self.error("patterns are implicitly anchored; drop ^/$")
        if ch == ")":
            self.error("unmatched ')'")
        return ("lit", ("in", frozenset(ch)))

    def _escape(self) -> _Pred:
        ch = self.take()
        if ch in _ESC_CLASS:
            return _ESC_CLASS[ch]
        return ("in", frozenset(_ESC_CHAR.get(ch, ch)))

    def _char_class(self) -> _Pred:
        negate = self.peek() == "^"
        if negate:
            self.take()
        chars: set = set()
        first = True
        while True:
            ch = self.take()
            if ch == "]" and not first:
                break
            first = False
            if ch == "\\":
                pred = self._escape()
                if pred[0] == "notin":
                    self.error(
                        "negated escape classes (\\D \\W \\S) are not "
                        "supported inside [...]")
                chars |= pred[1]
                continue
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()  # '-'
                hi = self.take()
                if hi == "\\":
                    hi = self._escape()
                    if hi[0] != "in" or len(hi[1]) != 1:
                        self.error("bad range end")
                    (hi,) = hi[1]
                if ord(hi) < ord(ch):
                    self.error(f"bad range {ch}-{hi}")
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)
        if not chars:
            self.error("empty character class")
        return ("notin" if negate else "in", frozenset(chars))


# ---------------- AST -> epsilon-NFA (Thompson) ----------------

class _NFA:
    def __init__(self):
        self.eps: Dict[int, List[int]] = defaultdict(list)
        self.edges: Dict[int, List[Tuple[_Pred, int]]] = defaultdict(list)
        self.n = 0

    def node(self) -> int:
        self.n += 1
        return self.n - 1

    def emit(self, ast) -> Tuple[int, int]:
        """Compile ``ast`` to a fragment; returns (start, end) nodes."""
        kind = ast[0]
        if kind == "lit":
            s, e = self.node(), self.node()
            self.edges[s].append((ast[1], e))
            return s, e
        if kind == "cat":
            s = e = self.node()
            for item in ast[1]:
                fs, fe = self.emit(item)
                self.eps[e].append(fs)
                e = fe
            return s, e
        if kind == "alt":
            s, e = self.node(), self.node()
            for item in ast[1]:
                fs, fe = self.emit(item)
                self.eps[s].append(fs)
                self.eps[fe].append(e)
            return s, e
        assert kind == "rep"
        _, sub, lo, hi = ast
        s = e = self.node()
        for _ in range(lo):  # mandatory copies
            fs, fe = self.emit(sub)
            self.eps[e].append(fs)
            e = fe
        if hi is None:  # Kleene tail
            fs, fe = self.emit(sub)
            self.eps[e].append(fs)
            self.eps[fe].append(e)
        else:
            end = self.node()
            for _ in range(hi - lo):  # optional copies, each may bail out
                self.eps[e].append(end)
                fs, fe = self.emit(sub)
                self.eps[e].append(fs)
                e = fe
            self.eps[e].append(end)
            e = end
        return s, e

    def closure(self, states) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            for nxt in self.eps.get(stack.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return frozenset(seen)

    def step(self, states: FrozenSet[int], ch: str) -> FrozenSet[int]:
        out = set()
        for s in states:
            for pred, dst in self.edges.get(s, ()):
                if _match(pred, ch):
                    out.add(dst)
        return self.closure(out) if out else frozenset()


# ---------------- token lift ----------------

def regex_to_dfa(pattern: str, token_strs: Sequence[str]) -> TokenDFA:
    """Compile ``pattern`` (anchored) into a TokenDFA over a vocabulary
    whose token id ``i`` decodes to ``token_strs[i]``. Empty strings
    (specials, e.g. the EOS slot) get no edges. Raises ValueError if the
    pattern is malformed or the vocabulary cannot realize it."""
    nfa = _NFA()
    s0, accept_node = nfa.emit(_Parser(pattern).parse())
    start = nfa.closure({s0})
    walk_cache: Dict[Tuple[FrozenSet[int], str], FrozenSet[int]] = {}

    def walk(state: FrozenSet[int], ch: str) -> FrozenSet[int]:
        key = (state, ch)
        out = walk_cache.get(key)
        if out is None:
            out = walk_cache[key] = nfa.step(state, ch)
        return out

    trans: Dict[FrozenSet[int], Dict[int, FrozenSet[int]]] = {}
    accept = set()
    stack = [start]
    while stack:
        st = stack.pop()
        if st in trans:
            continue
        edges: Dict[int, FrozenSet[int]] = {}
        for tid, text in enumerate(token_strs):
            if not text:
                continue
            cur = st
            for ch in text:
                cur = walk(cur, ch)
                if not cur:
                    break
            if cur:
                edges[tid] = cur
                stack.append(cur)
        trans[st] = edges
        if accept_node in st:
            accept.add(st)

    # prune states that cannot terminate: non-accepting with no outgoing
    # edges (a mid-decode dead end); edges into pruned states go too,
    # which can cascade
    while True:
        dead = {s for s, e in trans.items() if not e and s not in accept}
        if not dead:
            break
        for s in dead:
            del trans[s]
        for e in trans.values():
            for tid in [t for t, dst in e.items() if dst in dead]:
                del e[tid]
    if start not in trans:
        raise ValueError(
            f"the vocabulary cannot produce any string matching "
            f"{pattern!r} (every path dead-ends)")
    return TokenDFA(trans, start, accept)
