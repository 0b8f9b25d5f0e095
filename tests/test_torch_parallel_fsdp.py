"""FSDP and ZeRO-1 on the port, over gloo on the CPU (one 4-process group for
the file): the fully-sharded and ZeRO-1 steps against the replicated
data-parallel step in the same group, for ViT-MoP and GPT-MoP, with
``tests/test_parallel_fsdp.py``'s tolerances; the classifier also against
JAX's one-device step. The sharding rule (``fsdp_spec``, and the parameter
and dimension it picks) against the JAX package's, exactly; each sharded
parameter's local slice and its moments at 1/W; the collectives of a step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_mesh as jax_make_mesh
from mop_tpu.parallel.fsdp import fsdp_param_shardings as jax_fsdp_param_shardings
from mop_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from mop_tpu_torch.ops.preprocess import CIFAR100_MEAN as MEAN, CIFAR100_STD as STD
from mop_tpu_torch.parallel import fsdp
from mop_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from mop_tpu_torch.parallel.paths import jax_axes
from mop_tpu_torch.utils.jax_weights import _flatten, load_jax_params, torch_name
from tests._torch_parallel_common import assert_params_close, jax_init, run_ranks

VIT_KW = dict(dim=64, depth=2, heads=4, n_classes=10, n_views=3, n_kernels=2, drop_path=0.0)
GPT_CFG = dict(n_layer=2, n_head=4, n_embd=64, dropout=0.0, block_size=16)
GPT_KW = dict(n_views=3, n_kernels=2)
MIN_SIZE = 256  # shard even the small test model's weights
CLIP = 0.5
W = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1)
    xs = rng.integers(0, 256, (3, 16, 3, 32, 32), dtype=np.uint8)
    ys = rng.integers(0, 10, (3, 16)).astype(np.int64)
    jm = J.ViT_MoP(**VIT_KW)
    vit_params = jax_init(jm, 0, jnp.zeros((1, 3, 32, 32)))
    jg = J.create_gpt_mop(64, J.TransformerConfig(**GPT_CFG), **GPT_KW)
    idx = rng.integers(0, 64, (3, 16, 16)).astype(np.int64)
    gpt_params = jax_init(jg, 1, jnp.asarray(idx[0], jnp.int32))
    inputs = dict(
        xs=torch.from_numpy(xs), ys=torch.from_numpy(ys), min_size=MIN_SIZE, clip=CLIP,
        vit_kw=VIT_KW, gpt_cfg=GPT_CFG, gpt_kw=GPT_KW, gpt_vocab=64,
        vit_sd=load_jax_params(P.ViT_MoP(**VIT_KW, device="cpu"), vit_params).state_dict(),
        gpt_sd=load_jax_params(P.create_gpt_mop(64, P.TransformerConfig(**GPT_CFG),
                                                device="cpu", **GPT_KW), gpt_params).state_dict(),
        idx=torch.from_numpy(idx), tgt=torch.from_numpy(np.roll(idx, -1, axis=-1)))
    # JAX's one-device step with the same clip: what every layout must give.
    mesh = jax_make_mesh(n_devices=1)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    with mesh:
        step = jax_train_step(jm, tx, mesh, MEAN, STD, augment=False, compute_dtype=None,
                              grad_clip=CLIP)
        p, o = vit_params, tx.init(vit_params)
        losses = []
        for i in range(3):
            p, o, m = step(p, o, jnp.asarray(xs[i]), jnp.asarray(ys[i].astype(np.int32)),
                           jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
    want = load_jax_params(P.ViT_MoP(**VIT_KW, device="cpu"), jax.device_get(p)).state_dict()
    return inputs, (losses, want), dict(vit=(jm, vit_params), gpt=(jg, gpt_params))


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks("fsdp", case[0], tmp_path_factory.mktemp("fsdp"))


@pytest.mark.parametrize("shard", [True, False], ids=["fsdp", "zero1"])
def test_classifier_equals_replicated(ranks, shard):
    want_l, want_p = ranks[0]["cls_dp"]
    for r in ranks:
        got_l, got_p, _ = r[("cls", shard)]
        np.testing.assert_allclose(got_l[-1], want_l[-1], rtol=1e-5)
        # AdamW divides by sqrt(v): reduction-order grad diffs amplify early.
        assert_params_close(got_p, want_p, 2e-3, 1e-6)


@pytest.mark.parametrize("shard", [True, False], ids=["fsdp", "zero1"])
def test_classifier_equals_jax(case, ranks, shard):
    (want_l, want_p) = case[1]
    got_l, got_p, _ = ranks[0][("cls", shard)]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert_params_close(got_p, want_p, 2e-3, 1e-6)


@pytest.mark.parametrize("shard", [True, False], ids=["fsdp", "zero1"])
def test_gpt_equals_replicated(ranks, shard):
    want_l, want_p = ranks[0]["lm_dp"]
    for r in ranks:
        got_l, got_p = r[("lm", shard)]
        np.testing.assert_allclose(got_l[-1], want_l[-1], rtol=1e-5)
        assert_params_close(got_p, want_p, 2e-3, 5e-4)


def test_params_and_moments_sharded(ranks):
    """Each sharded parameter's slice and its Adam moments are 1/W of the
    whole along the rule's dim; the small ones stay whole."""
    for r in ranks:
        shapes = r["local_shapes"]
        n_sharded = 0
        for name, (local, full, dim) in shapes.items():
            if dim is None:
                assert local == full, name
                continue
            n_sharded += 1
            assert local[dim] * W == full[dim], name
            assert all(a == b for i, (a, b) in enumerate(zip(local, full)) if i != dim), name
        assert n_sharded >= 8
        assert sorted(r["moment_shapes"].values()) == sorted(s[0] for s in shapes.values())
        qkv = shapes["enc.blocks.0.attn.qkv.parametrizations.weight.original"]
        assert qkv[0] == (192 // W, 64) and qkv[2] == 0  # JAX's (64, 192) splits 192
        ln = shapes["enc.blocks.0.ln1.parametrizations.weight.original"]
        assert ln[0] == ln[1] == (64,)
        # ZeRO-1: the weights whole, the moments sharded likewise.
        assert sorted(r["zero1_moments"]) == sorted(s[0] for s in shapes.values())
        assert sorted(r["zero1_full"]) == sorted(s[1] for s in shapes.values())


@pytest.mark.parametrize("shard", [True, False], ids=["fsdp", "zero1"])
def test_step_collectives(ranks, shard):
    """FSDP all-gathers the sharded weights and reduce-scatters their grads;
    ZeRO-1 reduce-scatters the grads and all-gathers the updated slices."""
    s = ranks[0][("cls", shard)][2]
    assert s["all-gather"]["count"] >= 8 and s["reduce-scatter"]["count"] >= 8, s
    n_bytes = 4 * sum(int(np.prod(f)) for _, f, _ in ranks[0]["local_shapes"].values())
    assert s["all-gather"]["bytes"] <= 4 * n_bytes, (s, n_bytes)
    assert "all-to-all" not in s, s


GRID = [(512, 64), (64, 512), (100, 64), (7, 9), (64,), (), (4096,), (3, 4, 64, 64),
        (96, 96), (4, 1024), (6, 10, 100), (8, 8, 8, 8), (1, 4096), (4095,)]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("min_size", [1, 2**12])
def test_fsdp_spec_equals_jax(n, min_size):
    for shape in GRID:
        assert fsdp.fsdp_spec(shape, n, min_size) == tuple(jax_fsdp_spec(shape, n, min_size)), \
            shape


@pytest.mark.parametrize("model", ["vit", "gpt"])
@pytest.mark.parametrize("min_size", [MIN_SIZE, 2**12])
def test_param_shardings_equal_jax(case, model, min_size):
    """Leaf by leaf: whether the port shards a parameter, and the dim of the
    JAX leaf it splits, are JAX's."""
    jmodel, params = case[2][model]
    port = (P.ViT_MoP(**VIT_KW, device="cpu") if model == "vit" else
            P.create_gpt_mop(64, P.TransformerConfig(**GPT_CFG), device="cpu", **GPT_KW))
    mesh = Mesh(torch.device("cpu"), ("data", "model"), (W, 1))
    got = fsdp.fsdp_param_shardings(port, mesh, min_size)
    want = jax_fsdp_param_shardings(params, jax_make_mesh(n_devices=W), min_size)
    flat = _flatten(jax.tree_util.tree_map(lambda s: s.spec, want)["params"])
    assert len(flat) == len(got)
    n_split = 0
    for key, jspec in flat.items():
        name = torch_name(key)
        spec = got[name].spec
        if not tuple(jspec):
            assert spec == (), key
            continue
        n_split += 1
        axes = jax_axes(port, name, len(spec))
        assert axes.index(spec.index(DATA_AXIS)) == tuple(jspec).index("data"), key
    assert n_split >= 4
