"""Tensor parallelism on the port, over gloo on the CPU (one 4-process group
for the file): ViT-MoP (64 / 2 / 4, 3 views, 2 kernels) at tp 2 (dp 2) and tp
4 against the data-parallel step (itself held to JAX's one-device step), and
GPT-MoP at tp
2, with and without sequence parallelism, dropout 0 and 0.1, against the
replicated step — ``tests/test_parallel_tp.py``'s tolerances. The rule's
sharded-or-replicated decision against JAX's ``tp_param_shardings`` leaf by
leaf; the packed qkv split by head; the MoP gate's ``ViewsLinear.proj``
(row-split on D, its input whole) against the JAX module's values; the
collectives of a step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.models.components as JC
import mop_tpu_torch as P
from mop_tpu.parallel import make_classifier_train_step as jax_train_step
from mop_tpu.parallel import make_mesh as jax_make_mesh
from mop_tpu.parallel.tp import tp_param_shardings as jax_tp_param_shardings
from mop_tpu_torch.ops.preprocess import CIFAR100_MEAN as MEAN, CIFAR100_STD as STD
from mop_tpu_torch.parallel import tp
from mop_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from mop_tpu_torch.parallel.paths import jax_axes
from mop_tpu_torch.utils.jax_weights import _flatten, load_jax_params, torch_name
from tests._torch_parallel_common import assert_params_close, jax_init, run_ranks

VIT_KW = dict(dim=64, depth=2, heads=4, n_classes=10, n_views=3, n_kernels=2, drop_path=0.0)
GPT_CFG = dict(n_layer=2, n_head=4, n_embd=64, dropout=0.0, block_size=16)
GPT_KW = dict(n_views=3, n_kernels=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2)
    xs = rng.integers(0, 256, (3, 16, 3, 32, 32), dtype=np.uint8)
    ys = rng.integers(0, 10, (3, 16)).astype(np.int64)
    jm = J.ViT_MoP(**VIT_KW)
    vit_params = jax_init(jm, 3, jnp.zeros((1, 3, 32, 32)))
    jg = J.create_gpt_mop(64, J.TransformerConfig(**GPT_CFG), **GPT_KW)
    idx = rng.integers(0, 64, (3, 16, 16)).astype(np.int64)
    gpt_params = jax_init(jg, 4, jnp.asarray(idx[0], jnp.int32))
    tok = rng.standard_normal((2, 16, 64)).astype(np.float32)
    inputs = dict(
        xs=torch.from_numpy(xs), ys=torch.from_numpy(ys), tok=torch.from_numpy(tok),
        vit_kw=VIT_KW, gpt_cfg=GPT_CFG, gpt_kw=GPT_KW, gpt_vocab=64,
        vit_sd=load_jax_params(P.ViT_MoP(**VIT_KW, device="cpu"), vit_params).state_dict(),
        gpt_sd=load_jax_params(P.create_gpt_mop(64, P.TransformerConfig(**GPT_CFG),
                                                device="cpu", **GPT_KW), gpt_params).state_dict(),
        idx=torch.from_numpy(idx), tgt=torch.from_numpy(np.roll(idx, -1, axis=-1)))
    mesh = jax_make_mesh(n_devices=1)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    with mesh:
        step = jax_train_step(jm, tx, mesh, MEAN, STD, augment=False, compute_dtype=None)
        p, o = vit_params, tx.init(vit_params)
        losses = []
        for i in range(3):
            p, o, m = step(p, o, jnp.asarray(xs[i]), jnp.asarray(ys[i].astype(np.int32)),
                           jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
    want = load_jax_params(P.ViT_MoP(**VIT_KW, device="cpu"), jax.device_get(p)).state_dict()
    views = JC.ViewsLinear(dim=64, n_views=3).apply(
        {"params": vit_params["params"]["views"]}, jnp.asarray(tok), (4, 4))
    return inputs, (losses, want), dict(vit=vit_params, gpt=gpt_params), np.asarray(views)


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks("tp", case[0], tmp_path_factory.mktemp("tp"))


@pytest.mark.parametrize("t", [2, 4])
def test_vit_tp_equals_dp(ranks, t):
    want_l, want_p = ranks[0]["cls_dp"]
    for r in ranks:
        got_l, got_p = r[("cls", t)]
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
        # AdamW divides by sqrt(v): reduction-order grad diffs amplify early.
        assert_params_close(got_p, want_p, 2e-3, 1e-6)


def test_one_device_step_equals_jax(case):
    """The step the modes are held to, the port's one-device step, against
    JAX's at the same init (``tests/test_parallel.py``'s tolerances)."""
    inputs, (want_l, want_p) = case[0], case[1]
    model = P.ViT_MoP(**VIT_KW, device="cpu")
    model.load_state_dict(inputs["vit_sd"])
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    step = P.make_classifier_train_step(model, opt, MEAN, STD, augment=False,
                                        compute_dtype=None, device="cpu")
    got_l = [step(inputs["xs"][i], inputs["ys"][i])["loss"].item() for i in range(3)]
    np.testing.assert_allclose(got_l, want_l, rtol=2e-4, atol=2e-5)
    assert_params_close(model.state_dict(), want_p, 2e-4, 2e-5)


@pytest.mark.parametrize("sp,drop", [(False, 0.0), (True, 0.0), (True, 0.1)],
                         ids=["tp", "tp_sp", "tp_sp_dropout"])
def test_gpt_tp_equals_replicated(ranks, sp, drop):
    want_l, want_p = ranks[0][("lm_dp", drop)]
    for r in ranks:
        got_l, got_p = r[("lm", drop, sp)]
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
        # atol 5e-4 = half an Adam step of lr 1e-3: near-zero weights whose
        # tiny grads flip sign under another reduction order move that much.
        assert_params_close(got_p, want_p, 2e-3, 5e-4)


def test_sequence_parallel_is_hooks_on_the_models_forward(ranks):
    """Sequence parallelism keeps the model's own forward: switched off, its
    two pre-hooks are gone and the logits are those it gave with them on;
    with them on, an attention mask is refused."""
    for r in ranks:
        on, off, own_forward, n_block_hooks, n_ln_hooks = r["sp_off"]
        assert not own_forward and n_block_hooks == 0 and n_ln_hooks == 0
        assert on.shape == off.shape and on.shape[1] == 16
        np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-5, atol=1e-6)
        assert "attention_mask" in r["sp_mask_raise"]


def test_packed_qkv_split_by_head(ranks):
    """Each process holds the q, k and v rows of its own heads (2 of 4)."""
    for r in ranks:
        full, local, i, heads = r["qkv_local"]
        assert heads == 2 and local.shape == (96, 64)
        want = full.reshape(3, 2, 32, 64)[:, i].reshape(96, 64)
        assert torch.equal(local, want)
        assert not torch.equal(local, full[96 * i:96 * (i + 1)])  # not a contiguous split


def test_views_linear_gives_jax_values(case, ranks):
    """``ViewsLinear.proj``, row-split on D with its input whole on each
    process, gives the JAX module's view maps."""
    for r in ranks:
        np.testing.assert_allclose(r["views"].numpy(), case[3], rtol=2e-5, atol=2e-6)


def test_lm_step_collectives(ranks):
    """TP: the row products' partial sums are all-reduced; under sequence
    parallelism the tokens are all-gathered into each block and
    reduce-scattered out of it."""
    s = ranks[0][("lm_collectives", False)]
    assert s["all-reduce"]["count"] >= 4 and s["all-reduce"]["bytes"] > 0, s
    assert "all-gather" not in s and "reduce-scatter" not in s, s
    s = ranks[0][("lm_collectives", True)]
    assert s["all-gather"]["count"] >= 4 and s["reduce-scatter"]["count"] >= 4, s


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("model", ["vit", "gpt"])
def test_param_shardings_equal_jax(case, model, t):
    """Leaf by leaf: sharded or replicated, and on which dim, as JAX decides."""
    params = case[2][model]
    port = (P.ViT_MoP(**VIT_KW, device="cpu") if model == "vit" else
            P.create_gpt_mop(64, P.TransformerConfig(**GPT_CFG), device="cpu", **GPT_KW))
    got = tp.tp_param_shardings(port, Mesh(torch.device("cpu"), ("data", "model"), (1, t)))
    want = jax_tp_param_shardings(params, jax_make_mesh(n_devices=8, model_parallel=t))
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
        assert axes.index(spec.index(MODEL_AXIS)) == tuple(jspec).index(MODEL_AXIS), key
    # qkv / fc1 / proj / fc2 per block and the gate's views, or the GPT's six
    # projections, fc, proj and views per block.
    assert n_split == (9 if model == "vit" else 18)
