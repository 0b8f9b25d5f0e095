"""Grammar-constrained (guided) decoding for the serving engines.

A constraint is a deterministic finite automaton over TOKEN IDS. The
engine keeps each constrained request's DFA state host-side and folds a
``0 / -inf`` additive mask for the state's allowed tokens into that
slot's logit-bias row — the same per-row bias the batched sampler
already consumes (`engine.DecodeEngine._pick` applies it before the greedy
argmax AND before sampling), so constrained, unconstrained, and
differently-constrained requests all batch into one fixed-shape decode
step with zero recompilation. The mask also applies to the admission
prefill's first sampled token, and paged preemption replays the DFA
over the tokens already emitted, so constraints survive re-admission.

EOS is allowed exactly in ACCEPTING states; an accepting state with no
outgoing edges therefore forces EOS (the constraint is complete).
Because completion is signalled through EOS, a constrained request must
have an ``eos_id`` (submit raises otherwise).

Beyond-reference capability: the reference has no generation at all
(SURVEY §0 — its GPT computes logits+loss only); the guided-decoding
surface follows the vLLM/outlines pattern (token-level automaton →
per-step logit mask): the mask rides the engine's device-resident
(B, vocab) bias row, so no per-request masking pass is needed.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np

__all__ = ["TokenDFA", "choices", "token_set"]


class TokenDFA:
    """DFA over token ids driving constrained decoding.

    ``transitions``: {state: {token_id: next_state}} (states are any
    hashable); ``start``: initial state; ``accept``: states where the
    output may END (EOS becomes legal there). Every state reachable via
    ``transitions`` must either accept or have outgoing edges —
    otherwise decoding would dead-end with no legal token (validated at
    construction).
    """

    def __init__(self, transitions: Dict, start, accept: Iterable):
        self.transitions = {s: dict(e) for s, e in transitions.items()}
        self.start = start
        self.accept = frozenset(accept)
        states = set(self.transitions) | {start} | set(self.accept)
        for edges in self.transitions.values():
            states.update(edges.values())
        for s in states:
            if not self.transitions.get(s) and s not in self.accept:
                raise ValueError(
                    f"DFA state {s!r} has no outgoing edges and does not "
                    "accept: decoding would dead-end")

    def init_state(self):
        return self.start

    def allowed(self, state) -> Iterable[int]:
        """Token ids legal in ``state`` (EOS legality is separate — see
        :meth:`accepts`)."""
        return self.transitions.get(state, {}).keys()

    def advance(self, state, token: int):
        """State after emitting ``token``; None if the token was not
        allowed (the engine never takes that edge — the mask bans it)."""
        return self.transitions.get(state, {}).get(token)

    def accepts(self, state) -> bool:
        return state in self.accept


def choices(sequences: Sequence[Sequence[int]]) -> TokenDFA:
    """DFA forcing the output to be exactly ONE of ``sequences`` (token-id
    lists), then EOS — the guided-choice pattern. States are trie
    prefixes; shared prefixes between choices merge naturally."""
    trans: Dict[tuple, dict] = {(): {}}
    accept = set()
    for seq in sequences:
        seq = tuple(int(t) for t in seq)
        if not seq:
            raise ValueError("empty choice sequence")
        for i, tok in enumerate(seq):
            trans.setdefault(seq[:i], {})[tok] = seq[: i + 1]
        trans.setdefault(seq, {})
        accept.add(seq)
    if not accept:
        raise ValueError("choices() needs at least one sequence")
    return TokenDFA(trans, (), accept)


def token_set(allowed: Iterable[int], min_len: int = 1,
              max_len: int | None = None) -> TokenDFA:
    """DFA allowing only tokens from ``allowed``, with output length in
    ``[min_len, max_len]`` (``max_len=None`` = unbounded: EOS legal any
    time after ``min_len``; at ``max_len`` EOS is forced). E.g. digits-
    only fields: ``token_set(digit_ids, 1, 8)``."""
    toks = sorted({int(t) for t in allowed})
    if not toks:
        raise ValueError("token_set() needs at least one allowed token")
    if min_len < 0 or (max_len is not None and max_len < max(min_len, 1)):
        raise ValueError(f"bad length bounds [{min_len}, {max_len}]")
    if max_len is None:
        # states 0..min_len; the last self-loops forever
        trans = {i: {t: min(i + 1, min_len) for t in toks}
                 for i in range(min_len + 1)}
        accept = {min_len}
    else:
        trans = {i: {t: i + 1 for t in toks} for i in range(max_len)}
        trans[max_len] = {}
        accept = set(range(max(min_len, 1), max_len + 1))
        if min_len == 0:
            accept.add(0)
    return TokenDFA(trans, 0, accept)


def mask_row(constraint, state, vocab: int, eos_id: int) -> np.ndarray:
    """(vocab,) additive fp32 mask for ``state``: 0 where legal, -inf
    where banned (absolute: no finite user logit_bias can override a ban). EOS is unbanned iff the state accepts. Raises if the
    DFA names tokens outside [0, vocab) or (defensively) dead-ends."""
    row = np.full((vocab,), -np.inf, np.float32)
    ids = np.fromiter(constraint.allowed(state), np.int64, -1)
    if ids.size and (ids.min() < 0 or ids.max() >= vocab):
        bad = ids[(ids < 0) | (ids >= vocab)]
        raise ValueError(
            f"constraint allows tokens outside vocab [0, {vocab}): "
            f"{bad[:8].tolist()}")
    row[ids] = 0.0
    if constraint.accepts(state):
        row[eos_id] = 0.0
    elif ids.size == 0:
        raise ValueError(
            f"constraint dead-ends in state {state!r}: no legal token")
    return row
