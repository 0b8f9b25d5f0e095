"""Tensor-parallel serving on the port, over gloo on the CPU, the counterpart
of ``tests/test_serving_tp.py``: a model through ``tp_shard_params`` at
model_parallel 4 (one 4-process group) serves exactly the tokens of the JAX
package's engines on the same weights (and so of the port's plain engine)
in the dense engine, with the head-split ``cache_sharding`` (each process's
pools holding its heads), in the paged engine, in the speculative engine (a
tensor-parallel target, a plain draft) and for the causal GPT-MoP; sampled
tokens are, on every process, those of a plain engine seeded as the model
group's first process's generator. And the repair, at 2 processes: a
tensor-parallel Quartet LM in ``DecodeEngine`` (its decode tree once split
heads by the whole head count and skipped the row products' all-reduces,
and raised)."""

import jax
import jax.numpy as jnp
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.serving as JS
import mop_tpu_torch as P
from mop_tpu_torch.serving import DecodeEngine, PagedDecodeEngine, SpecDecodeEngine
from mop_tpu_torch.utils.jax_weights import load_jax_params
from tests._torch_parallel_common import run_ranks

VOCAB = 50
JOBS = [([3, 1, 4, 1, 5], 12), ([2, 7, 9], 8), ([11], 10)]
PAGED = dict(n_pages=16, page_size=16)
SAMPLED_SEED = 100  # the first process's generator; process r's is 100 + r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(fac, seed, n_layer=2, n_embd=64, n_head=4, **cfg):
    """A JAX family's seeded init with its blocks' matrices scaled x 4 (so
    that its greedy tokens vary: at the init's scale each stream repeats one
    id), and the port's model with those weights: ``(port model, what a
    process builds it from, (JAX model, JAX params))``."""
    cfg = dict(n_layer=n_layer, n_head=n_head, n_embd=n_embd, dropout=0.0, block_size=64, **cfg)
    jm = getattr(J, fac)(VOCAB, J.TransformerConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, w: w * 4.0 if "blocks" in jax.tree_util.keystr(path) and w.ndim == 2
        else w, params)
    model = load_jax_params(getattr(P, fac)(VOCAB, P.TransformerConfig(**cfg), device="cpu"),
                            params)
    return (model.eval(), (fac, cfg, {}, model.state_dict()),
            (jm, jax.tree_util.tree_map(jnp.asarray, params)))


def _serve(engine):
    rids = [engine.submit(*j) for j in JOBS]
    res = engine.run()
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def models():
    return dict(quartet=_model("create_gpt_quartet", 1), target=_model("create_gpt_quartet", 1,
                                                                          n_layer=3),
                draft=_model("create_gpt_quartet", 7, n_layer=1, n_embd=32, n_head=2),
                mop=_model("create_gpt_mop_causal", 3, use_quartet=False))


@pytest.fixture(scope="module")
def want(models):
    """The JAX package's engines on the same weights and jobs (one prefill
    bucket bounds their compiles; the tokens are those without it)."""
    (jq, pq), (jt, pt), (jd, pd), (jmop, pmop) = (models[k][2] for k in
                                                  ("quartet", "target", "draft", "mop"))
    b = dict(max_batch=3, prefill_buckets=[8])
    return dict(quartet=_serve(JS.DecodeEngine(jq, pq, **b)),
                paged=_serve(JS.PagedDecodeEngine(jq, pq, **PAGED, **b)),
                spec=_serve(JS.SpecDecodeEngine(jt, pt, jd, pd, gamma=3, **b)),
                mop=_serve(JS.DecodeEngine(jmop, pmop, **b)))


@pytest.fixture(scope="module")
def plain(models):
    q = _serve(DecodeEngine(models["quartet"][0], max_batch=3))
    spec = _serve(SpecDecodeEngine(models["target"][0], None, models["draft"][0], None,
                                   max_batch=3, gamma=3))
    sampled = _serve(DecodeEngine(models["quartet"][0], max_batch=3, temperature=0.9,
                                  generator=torch.Generator().manual_seed(SAMPLED_SEED)))
    return dict(quartet=q, spec=spec, mop=_serve(DecodeEngine(models["mop"][0], max_batch=3)),
                paged=_serve(PagedDecodeEngine(models["quartet"][0], max_batch=3, **PAGED)),
                sampled=sampled)


def _inputs(models, t):
    return dict(jobs=JOBS, vocab=VOCAB, tp=t, paged=PAGED, sampled_seed=SAMPLED_SEED,
                **{k: v[1] for k, v in models.items()})


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    return run_ranks("serving_tp", _inputs(models, 4), tmp_path_factory.mktemp("serving_tp"))


def test_plain_tokens_vary(plain):
    """The streams the tests compare are not one repeated id each."""
    for toks in plain.values():
        assert all(len(set(t)) > 1 for t in toks[:2]), toks


@pytest.mark.parametrize("kind", ["quartet", "paged", "spec", "mop"])
def test_plain_engine_matches_jax(plain, want, kind):
    """The port's plain engines serve the JAX engines' tokens, so every
    tensor-parallel case below is held to JAX's too."""
    assert plain[kind] == want[kind]


def test_repair_tp_quartet_decode_engine_at_two_processes(models, want, tmp_path):
    r2 = run_ranks("serving_tp", _inputs(models, 2), tmp_path, nproc=2)
    for r in r2:
        assert r["dense"] == want["quartet"]


def test_tp_sharded_params_match_plain_engine(ranks, want):
    for r in ranks:
        assert r["dense"] == want["quartet"]


def test_tp_with_head_sharded_kv_cache(ranks, want):
    for r in ranks:
        toks, shape = r["head_split"]
        assert toks == want["quartet"]
        assert shape == (2, 3, 1, 64, 16)  # (L, B, H / 4, W, dk): one head a process


def test_tp_paged_engine_matches_plain(ranks, want):
    for r in ranks:
        toks, shape = r["paged"]
        assert toks == want["paged"]
        assert shape == (2, 17, 1, 16, 16)


def test_tp_speculative_engine_matches_plain(ranks, want):
    for r in ranks:
        assert r["spec"] == want["spec"]


def test_tp_sharded_gpt_mop_matches_plain_engine(ranks, want):
    for r in ranks:
        assert r["mop"] == want["mop"]


def test_tp_sampled_tokens_are_the_first_process(ranks, plain):
    """Every process serves the stream of a plain engine whose generator is
    seeded as the first process's (each process's own is seeded apart)."""
    for r in ranks:
        assert r["sampled"] == plain["sampled"]
    assert plain["sampled"] != plain["quartet"]


def test_other_cache_sharding_raises(ranks):
    for r in ranks:
        assert "(None, None, 'model', None, None)" in r["bad_spec"]
