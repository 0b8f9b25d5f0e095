"""Text tokenizers of the port: byte-level BPE and a character vocabulary,
a copy of ``mop_tpu/data/tokenizer.py`` (plain Python, no framework).

The model's GPT consumes integer ids; a decode or serving stack needs
str <-> ids, and nothing can be downloaded, so both tokenizers train from a
user corpus and serialize to a single JSON file.

- :class:`ByteBPETokenizer` — byte-level BPE (GPT-2 style merge ranks
  over a 256-byte base alphabet). Byte fallback means ANY unicode string
  round-trips exactly, even with characters never seen in training.
- :class:`CharTokenizer` — codepoint vocabulary with optional ``unk``.

Both expose ``encode`` / ``decode`` / ``vocab_size`` / ``eos_id`` and a
``token_strs`` table (id -> decoded string: '' for specials and for byte
tokens that are not text on their own), plus ``save``/``load``.
``stream_decoder()`` returns an incremental decoder that never splits a
multi-byte UTF-8 sequence across streamed events.
"""

from __future__ import annotations

import codecs
import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["ByteBPETokenizer", "CharTokenizer"]

# GPT-2-ish piece splitter (pure re, no regex module): contractions,
# letter runs, digit runs, punctuation runs, whitespace. A leading space
# stays attached to the following word so merges learn " the" etc.
_PIECE_RE = re.compile(
    r"'(?:s|t|re|ve|m|ll|d)| ?[^\W\d_]+| ?\d+| ?(?:[^\w\s]|_)+|\s+",
    re.UNICODE,
)


def _split_pieces(text: str) -> List[bytes]:
    return [p.encode("utf-8") for p in _PIECE_RE.findall(text)]


class _StreamDecoder:
    """Incremental ids -> str decoder that buffers partial UTF-8 tails."""

    def __init__(self, tok: "ByteBPETokenizer"):
        self._tok = tok
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def feed(self, token_id: int) -> str:
        """Decode one more token; returns the newly-completed text (may be
        '' while a multi-byte character is still incomplete)."""
        if token_id in self._tok._special_ids:
            return ""
        return self._dec.decode(self._tok._vocab[token_id])

    def flush(self) -> str:
        return self._dec.decode(b"", True)


class ByteBPETokenizer:
    """Byte-level BPE trained from a corpus; exact unicode round-trip.

    ids 0..255 are the raw bytes, then one id per learned merge, then the
    special tokens (e.g. ``eos``) at the top of the range.
    """

    def __init__(self, merges: Sequence[Tuple[int, int]],
                 specials: Sequence[str] = ("<eos>",)):
        self._vocab: List[bytes] = [bytes([b]) for b in range(256)]
        self._ranks: Dict[Tuple[int, int], int] = {}
        for pair in merges:
            pair = (int(pair[0]), int(pair[1]))
            if pair in self._ranks:
                raise ValueError(f"duplicate merge {pair}")
            for side in pair:
                if not 0 <= side < len(self._vocab):
                    raise ValueError(f"merge {pair} references unknown id")
            self._ranks[pair] = len(self._vocab)
            self._vocab.append(self._vocab[pair[0]] + self._vocab[pair[1]])
        self._specials = list(specials)
        self._special_ids = {
            len(self._vocab) + i for i in range(len(self._specials))}
        self._cache: Dict[bytes, List[int]] = {}

    # ---------------- training ----------------

    @classmethod
    def train(cls, corpus: Iterable[str] | str, vocab_size: int,
              specials: Sequence[str] = ("<eos>",)) -> "ByteBPETokenizer":
        """Learn merges from ``corpus`` until ``vocab_size`` ids exist.

        Deterministic: ties in pair frequency break on the smaller
        (left, right) id pair. ``vocab_size`` counts bytes + merges +
        specials, so it must be >= 256 + len(specials).
        """
        n_merges = vocab_size - 256 - len(specials)
        if n_merges < 0:
            raise ValueError(
                f"vocab_size {vocab_size} < 256 + {len(specials)} specials")
        if isinstance(corpus, str):
            corpus = [corpus]
        words: Counter = Counter()
        for text in corpus:
            words.update(_split_pieces(text))
        # word -> (tuple of current token ids, count)
        seqs: Dict[bytes, List[int]] = {
            w: list(w) for w in words}  # bytes iterate as ints 0..255
        merges: List[Tuple[int, int]] = []
        next_id = 256
        for _ in range(n_merges):
            pairs: Counter = Counter()
            for w, seq in seqs.items():
                c = words[w]
                for a, b in zip(seq, seq[1:]):
                    pairs[(a, b)] += c
            if not pairs:
                break
            best = max(pairs.items(), key=lambda kv: (kv[1], (-kv[0][0],
                                                              -kv[0][1])))
            (a, b), freq = best
            if freq < 2:  # merging singletons just memorizes the corpus
                break
            merges.append((a, b))
            for w, seq in seqs.items():
                if a not in seq:
                    continue
                out: List[int] = []
                i = 0
                while i < len(seq):
                    if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                        out.append(next_id)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                seqs[w] = out
            next_id += 1
        return cls(merges, specials)

    # ---------------- encode / decode ----------------

    def _bpe(self, piece: bytes) -> List[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        seq = list(piece)
        while len(seq) > 1:
            ranked = [
                (self._ranks[p], i)
                for i, p in enumerate(zip(seq, seq[1:]))
                if p in self._ranks
            ]
            if not ranked:
                break
            rank, i = min(ranked)
            seq[i:i + 2] = [rank]  # rank == the merged token's id
        if len(self._cache) < 1 << 16:
            self._cache[piece] = seq
        return seq

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in _split_pieces(text):
            out.extend(self._bpe(piece))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        buf = b"".join(
            self._vocab[i] for i in ids if i not in self._special_ids)
        return buf.decode("utf-8", errors="replace")

    def stream_decoder(self) -> _StreamDecoder:
        return _StreamDecoder(self)

    # ---------------- metadata ----------------

    @property
    def vocab_size(self) -> int:
        return len(self._vocab) + len(self._specials)

    @property
    def eos_id(self) -> Optional[int]:
        for name in ("<eos>", "<|endoftext|>"):
            if name in self._specials:
                return len(self._vocab) + self._specials.index(name)
        return None

    def special_id(self, name: str) -> int:
        return len(self._vocab) + self._specials.index(name)

    @property
    def token_strs(self) -> List[str]:
        """id -> decoded string; '' for specials and for byte tokens that
        are not valid UTF-8 on their own (multi-byte fragments) — exactly
        the table a constrained decoder reads for 'no-text' ids."""
        out = []
        for b in self._vocab:
            try:
                out.append(b.decode("utf-8"))
            except UnicodeDecodeError:
                out.append("")
        out.extend("" for _ in self._specials)
        return out

    # ---------------- persistence ----------------

    def save(self, path: str) -> None:
        merges = sorted(self._ranks, key=self._ranks.__getitem__)
        with open(path, "w") as f:
            json.dump({"kind": "byte_bpe", "merges": merges,
                       "specials": self._specials}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("kind") != "byte_bpe":
            raise ValueError(f"{path} is not a byte_bpe tokenizer file")
        return cls([tuple(m) for m in d["merges"]], d["specials"])


class CharTokenizer:
    """Codepoint vocabulary; optional ``unk`` absorbs unseen characters."""

    def __init__(self, chars: Sequence[str],
                 specials: Sequence[str] = ("<eos>",),
                 unk: Optional[str] = "<unk>"):
        self._chars = list(dict.fromkeys(chars))  # dedupe, keep order
        if any(len(c) != 1 for c in self._chars):
            raise ValueError("chars must be single codepoints")
        self._specials = list(specials) + ([unk] if unk else [])
        self._unk = unk
        self._idx = {c: i for i, c in enumerate(self._chars)}

    @classmethod
    def from_corpus(cls, corpus: Iterable[str] | str,
                    specials: Sequence[str] = ("<eos>",),
                    unk: Optional[str] = "<unk>") -> "CharTokenizer":
        if isinstance(corpus, str):
            corpus = [corpus]
        seen = set()
        for text in corpus:
            seen.update(text)
        return cls(sorted(seen), specials, unk)

    def encode(self, text: str) -> List[int]:
        out = []
        unk_id = (len(self._chars) + self._specials.index(self._unk)
                  if self._unk else None)
        for ch in text:
            i = self._idx.get(ch)
            if i is None:
                if unk_id is None:
                    raise ValueError(f"character {ch!r} not in vocabulary")
                i = unk_id
            out.append(i)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(
            self._chars[i] for i in ids if 0 <= i < len(self._chars))

    @property
    def vocab_size(self) -> int:
        return len(self._chars) + len(self._specials)

    @property
    def eos_id(self) -> Optional[int]:
        if "<eos>" in self._specials:
            return len(self._chars) + self._specials.index("<eos>")
        return None

    def special_id(self, name: str) -> int:
        return len(self._chars) + self._specials.index(name)

    @property
    def token_strs(self) -> List[str]:
        return list(self._chars) + ["" for _ in self._specials]

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"kind": "char", "chars": self._chars,
                       "specials": [s for s in self._specials
                                    if s != self._unk],
                       "unk": self._unk}, f)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("kind") != "char":
            raise ValueError(f"{path} is not a char tokenizer file")
        return cls(d["chars"], d["specials"], d["unk"])
