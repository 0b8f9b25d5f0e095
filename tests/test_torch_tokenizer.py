"""The port's tokenizers (``mop_tpu_torch.data.tokenizer``, a copy of
``mop_tpu.data.tokenizer``) against the JAX package's on
``tests/test_tokenizer.py``'s cases: trained merges, encode, decode, the
stream decoder's pieces, ``token_strs``, specials, save / load, and the
character tokenizer with and without ``unk``."""

import pytest

from mop_tpu.data import tokenizer as JT
from mop_tpu_torch.data import ByteBPETokenizer, CharTokenizer

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "the dog sleeps; the fox runs. pack my box with five dozen jugs. "
    "naive café déjà-vu — übermäßig 東京 🚀 again and again the fox. "
) * 20

TRICKY = [
    "plain ascii text",
    "tabs\tand\nnewlines\r\n",
    "underscores _like_this_ and snake_case",
    "emoji 🚀🎉 and flags 🇯🇵",
    "accents: café déjà naïve øre",
    "CJK: 東京都 新宿区",
    "mixed 123 numbers, 4.5e-6! #hash @at 'quotes' \"double\"",
    "never-seen-in-corpus: zygomorphic QWERTYUIOP ꙮ",
    "",
]


@pytest.fixture(scope="module")
def pair():
    return (ByteBPETokenizer.train(CORPUS, vocab_size=320),
            JT.ByteBPETokenizer.train(CORPUS, vocab_size=320))


def test_trained_merges_equal_jax(pair):
    tok, ref = pair
    assert tok._ranks == ref._ranks and tok._vocab == ref._vocab
    assert tok.vocab_size == ref.vocab_size == 320 and tok.eos_id == ref.eos_id
    assert tok.token_strs == ref.token_strs


@pytest.mark.parametrize("text", TRICKY)
def test_encode_decode_equal_jax(pair, text):
    tok, ref = pair
    ids = tok.encode(text)
    assert ids == ref.encode(text)
    assert tok.decode(ids) == ref.decode(ids) == text
    assert tok.decode(ids + [tok.eos_id]) == text


@pytest.mark.parametrize("text", ["café 🚀 東京 done", TRICKY[3]])
def test_stream_decoder_pieces_equal_jax(pair, text):
    tok, ref = pair
    ids = tok.encode(text)
    dec, rdec = tok.stream_decoder(), ref.stream_decoder()
    pieces = [dec.feed(i) for i in ids]
    assert pieces == [rdec.feed(i) for i in ids]
    assert "".join(pieces) + dec.flush() == text
    assert all("�" not in p for p in pieces)


def test_save_load_and_cross_load(pair, tmp_path):
    tok, ref = pair
    p, q = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tok.save(p)
    ref.save(q)
    assert open(p).read() == open(q).read()
    loaded = ByteBPETokenizer.load(q)
    for text in TRICKY:
        assert loaded.encode(text) == ref.encode(text)
    with pytest.raises(ValueError, match="not a char tokenizer"):
        CharTokenizer.load(p)
    with pytest.raises(ValueError):
        ByteBPETokenizer.train("abc", vocab_size=255)


@pytest.mark.parametrize("unk", ["<unk>", None])
def test_char_tokenizer_equals_jax(unk, tmp_path):
    tok = CharTokenizer.from_corpus("hello world", unk=unk)
    ref = JT.CharTokenizer.from_corpus("hello world", unk=unk)
    assert (tok.vocab_size, tok.eos_id, tok.token_strs) == (ref.vocab_size, ref.eos_id,
                                                            ref.token_strs)
    assert tok.encode("hello") == ref.encode("hello")
    if unk:
        assert tok.encode("hello!") == ref.encode("hello!")
        assert tok.decode(tok.encode("hello!")) == "hello"
    else:
        with pytest.raises(ValueError):
            tok.encode("hello!")
    p = str(tmp_path / "char.json")
    tok.save(p)
    loaded = JT.CharTokenizer.load(p)
    assert loaded.encode("hello world") == tok.encode("hello world")
