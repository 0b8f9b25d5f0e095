"""Embeddings in the port against the JAX package: ``EmbeddingModel``'s
vectors (masked-mean and last-token pools, unit norm) equal to JAX's for
the four GPT kinds over a ragged batch, a sequence's vector the same alone
and co-batched (the pads masked out of every row statistic), the batch
split by ``max_chunk``; and ``parse_embedding_input`` / ``embeddings_body``
giving JAX's answers. Vectors at rtol 2e-4 / atol 2e-5."""

import jax
import numpy as np
import pytest

from mop_tpu.serving import EmbeddingModel as JaxEmbedding
from mop_tpu.serving import embeddings_body as jax_body
from mop_tpu.serving import parse_embedding_input as jax_parse
from mop_tpu_torch.data.tokenizer import CharTokenizer
from mop_tpu_torch.serving import EmbeddingModel, embeddings_body, parse_embedding_input

from _torch_serving_common import ATOL, RTOL, _one_torch_thread, lm_pair, prompts_of, to_torch  # noqa: F401,E501

SEQS = prompts_of([3, 9, 1, 16, 6], seed=140)


@pytest.mark.parametrize("kind,pool", [("quartet", "mean"), ("baseline", "last"),
                                       ("mop", "mean"), ("mop_causal", "last")])
def test_vectors_equal_jax(kind, pool):
    jm, jp, pm = lm_pair(kind, scale=2.0)
    pp = to_torch(jax.device_get(jp))
    want = JaxEmbedding(jm, jp, pool=pool).embed(SEQS)
    emb = EmbeddingModel(pm, pp, pool=pool, max_chunk=2)  # three forwards
    got = emb.embed(SEQS)
    assert got.shape == (len(SEQS), 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    for i, s in enumerate(SEQS):  # alone, as in the batch
        np.testing.assert_allclose(emb.embed([s])[0], got[i], rtol=RTOL, atol=ATOL)


def test_checks_parse_and_body_equal_jax():
    _, _, pm = lm_pair("quartet")
    emb = EmbeddingModel(pm, None, normalize=False)
    assert emb.embed([]).shape == (0, 32)
    for bad in ([[]], [list(range(17))], [[1, 40]], [[True]]):
        with pytest.raises(ValueError):
            emb.embed(bad)
    with pytest.raises(ValueError, match="pool"):
        EmbeddingModel(pm, None, pool="max")
    tok = CharTokenizer("abcdefgh ")
    for req in ({"input": "abc"}, {"input": ["ab", "hg fa"]}, {"input": [3, 4]},
                {"input": [[1, 2], [3]]}):
        assert parse_embedding_input(req, tok) == jax_parse(req, tok)
    for req in ({}, {"input": []}, {"input": 3}, {"input": [[1], "a", 2.5]}):
        with pytest.raises(ValueError):
            parse_embedding_input(req, tok)
    vecs = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    for kw in ({}, {"encoding_format": "base64"}, {"dimensions": 3}):
        got, want = embeddings_body(vecs, "m", 5, **kw), jax_body(vecs, "m", 5, **kw)
        assert got["usage"] == want["usage"] and len(got["data"]) == 2
        for a, b in zip(got["data"], want["data"]):
            if isinstance(a["embedding"], str):
                assert a["embedding"] == b["embedding"]
            else:
                np.testing.assert_allclose(a["embedding"], b["embedding"], rtol=1e-6)
