"""GPT-MoP and the GPT comparison framework: the port's ``Conv1d`` against
the JAX layer through ``load_jax_params``' 3-D rule; ``GPT_MoP`` (from
``create_gpt_mop``, with and without Quartet attention, and
``create_gpt_mop_causal``) against the JAX model with transplanted weights:
logits, loss, grads and ``get_gate_maps``; the ``gpt_mop`` golden;
causality of the causal variant; exact parameter counts and the comparison
framework's counts, component breakdown, matching analysis and model info
against ``mop_tpu``'s at a small config and at the reference comparison
config."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.models.gpt_comparison import ComparisonConfig as JaxComparisonConfig
from mop_tpu.models.gpt_comparison import GPTComparisonFramework as JaxFramework
from mop_tpu.models.layers import Conv1d as JaxConv1d
from mop_tpu.utils.torch_port import load_golden
from mop_tpu_torch.models.layers import init_params
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL, ATOL = 2e-4, 2e-5
M_ATOL, M_RTOL = 1e-4, 1e-3
VOCAB = 50
CFG = dict(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=16, bias=False)
# name -> (JAX factory, port factory, config overrides, factory kwargs)
VARIANTS = {
    "mop": (J.create_gpt_mop, PM.create_gpt_mop, dict(use_quartet=False),
            dict(n_views=2, n_kernels=1)),
    "mop_quartet": (J.create_gpt_mop, PM.create_gpt_mop, {}, dict(n_views=3, n_kernels=2)),
    "mop_causal": (J.create_gpt_mop_causal, PM.create_gpt_mop_causal, {},
                   dict(n_views=3, n_kernels=2)),
}
# tools/bench_lm.py's GPT: create_gpt_mop at its defaults (5 views, 3 kernels)
# over a TransformerConfig whose use_quartet is left at its default (on).
BENCH_LM = dict(n_layer=6, n_head=6, n_embd=384, dropout=0.0, block_size=256)
BENCH_LM_VOCAB, BENCH_LM_PARAMS = 8192, 15652230


# ------------------------------ Conv1d ------------------------------


class _Holder(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv


@pytest.mark.parametrize("padding,bias", [(1, True), ((2, 0), False), ((0, 1), True), (0, False)])
def test_conv1d_matches_jax(padding, bias):
    """The port's Conv1d (NCL) against the JAX one (NLC) with its kernel
    moved by load_jax_params (LIO -> OIL): int and (left, right) padding,
    with and without a bias."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 4)).astype(np.float32)  # (B, L, C)
    jc = JaxConv1d(3, 3, padding=padding, use_bias=bias)
    params = jax.device_get(jc.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    holder = load_jax_params(_Holder(PM.Conv1d(4, 3, 3, padding=padding, bias=bias)),
                             {"conv": params["params"]})
    got = holder.conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_conv1d_init_draws_kaiming_uniform_from_the_generator():
    convs = [init_params(PM.Conv1d(5, 3, 3, bias=True), torch.Generator().manual_seed(seed))
             for seed in (7, 7, 8)]
    assert torch.equal(convs[0].weight, convs[1].weight)
    assert torch.equal(convs[0].bias, convs[1].bias)
    assert not torch.equal(convs[0].weight, convs[2].weight)
    bound = 1 / np.sqrt(5 * 3)
    assert convs[0].weight.abs().max() <= bound and convs[0].bias.abs().max() <= bound


# ------------------------------ GPT_MoP vs JAX ------------------------------


def _mop_pair(name, seed=0):
    jfac, pfac, extra, kw = VARIANTS[name]
    cfg = {**CFG, **extra}
    jm = jfac(VOCAB, J.TransformerConfig(**cfg), **kw)
    pm = pfac(VOCAB, PM.TransformerConfig(**cfg), device="cpu", **kw)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    tgt = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(idx)))
    for blk in params["params"].values():  # move the raw scalars off their init
        if isinstance(blk, dict) and "fuse" in blk:
            blk["fuse"]["alpha"] = rng.uniform(0.5, 1.5, (2,)).astype(np.float32)
            if "mixture" in blk["attn"]:
                blk["attn"]["mixture"] = rng.uniform(-1.0, 1.0, (1,)).astype(np.float32)
    return jm, params, load_jax_params(pm, params), idx, tgt


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gpt_mop_matches_jax(name):
    """Eval mode: logits and loss at rtol 2e-4 / atol 2e-5, every grad, and
    the three gate-map tensors of get_gate_maps."""
    jm, params, pm, idx, tgt = _mop_pair(name)

    def loss(p):
        logits, l_ = jm.apply(p, jnp.asarray(idx), targets=jnp.asarray(tgt), train=False)
        return l_, logits

    (want_loss, want_logits), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pm.eval()
    logits, got_loss = pm(torch.from_numpy(idx).long(), targets=torch.from_numpy(tgt).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=RTOL)
    got_loss.backward()
    want_g = jax_state_dict(jax.device_get(gp))
    got_g = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k], atol=M_ATOL, rtol=M_RTOL, err_msg=k)

    want_maps = jax.jit(lambda p: jm.apply(p, jnp.asarray(idx), method=jm.get_gate_maps))(params)
    pm.train()  # get_gate_maps runs the eval forward whatever the mode
    with torch.no_grad():
        got_maps = pm.get_gate_maps(torch.from_numpy(idx).long())
    assert pm.training
    n_views, n_kernels = VARIANTS[name][3]["n_views"], VARIANTS[name][3]["n_kernels"]
    shapes = [(2, 2, 1, 16), (2, 2, n_views, 16), (2, 2, n_kernels, 16)]
    for label, g, w, shape in zip(("gates", "views", "kernels"), got_maps, want_maps, shapes):
        assert tuple(g.shape) == shape, label
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=label)


def test_gpt_mop_golden():
    ins, ws, outs = load_golden(os.path.join(GOLDEN, "gpt_mop.npz"))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in ws.items()}
    assert torch.equal(sd.pop("lm_head.weight"), sd["wte.weight"])  # the tied head is wte
    model = PM.create_gpt_mop(VOCAB, PM.TransformerConfig(**CFG, use_quartet=False),
                              n_views=2, n_kernels=1, device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        logits, loss = model(torch.from_numpy(ins["idx"]).long(),
                             targets=torch.from_numpy(ins["targets"]).long())
    np.testing.assert_allclose(logits.numpy(), outs["logits"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), outs["loss"], rtol=RTOL)


@pytest.mark.parametrize("name,causal", [("mop_causal", True), ("mop_quartet", False)])
def test_causal_variant_sees_no_later_token(name, causal):
    """create_gpt_mop_causal: changing the token at t leaves every logit
    before t as it was. The reference-exact model leaks (its gate convs are
    centred and its scores standardized over every column)."""
    _, _, pm, idx, _ = _mop_pair(name)
    idx = torch.from_numpy(idx).long()
    t = 9
    idx2 = idx.clone()
    idx2[:, t] = (idx2[:, t] + 1) % VOCAB
    with torch.no_grad():
        a, _ = pm.eval()(idx)
        b, _ = pm(idx2)
    before = (a[:, :t] - b[:, :t]).abs().max().item()
    if causal:
        assert before == 0.0
        assert (a[:, t] - b[:, t]).abs().max().item() > 1e-3
    else:
        assert before > 1e-6


def test_gpt_mop_dropout_draws_from_the_generator_and_checks_the_block():
    cfg = PM.TransformerConfig(**{**CFG, "dropout": 0.1})
    pm = PM.create_gpt_mop(VOCAB, cfg, n_views=2, n_kernels=1, device="cpu",
                           generator=torch.Generator().manual_seed(0)).train()
    idx = torch.randint(0, VOCAB, (2, 16), generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="generator"):
        pm(idx, targets=idx)
    losses = []
    for _ in range(2):
        PM.set_generator(pm, torch.Generator().manual_seed(5))
        before = torch.get_rng_state()
        losses.append(pm(idx, targets=idx)[1].item())
        assert torch.equal(torch.get_rng_state(), before)
    assert losses[0] == losses[1] != pm.eval()(idx, targets=idx)[1].item()
    with pytest.raises(ValueError, match="block size"):
        pm(torch.zeros(1, 17, dtype=torch.long))


# ------------------------------ counts ------------------------------


def _jax_count(model, t=16):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, t), jnp.int32)))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def _meta_count(factory, vocab, cfg, **kw):
    with torch.device("meta"):
        model = factory(vocab, PM.TransformerConfig(**cfg), device="meta", **kw)
    return sum(p.numel() for p in model.parameters())


def test_bench_lm_config_param_count_matches_jax():
    """tools/bench_lm.py's GPT-MoP (Quartet attention: its config keeps
    use_quartet on); the count is also chip_smoke.py's."""
    want = _jax_count(J.create_gpt_mop(BENCH_LM_VOCAB, J.TransformerConfig(**BENCH_LM)))
    assert want == BENCH_LM_PARAMS
    assert _meta_count(PM.create_gpt_mop, BENCH_LM_VOCAB, BENCH_LM) == want


def _configs(small):
    if small:
        kw = dict(n_layer=2, n_head=2, n_embd=32, block_size=16, n_views=3, n_kernels=2)
        return JaxComparisonConfig(**kw), PM.ComparisonConfig(**kw), VOCAB
    return JaxComparisonConfig(), PM.ComparisonConfig(), 8192


@pytest.mark.parametrize("small", [True, False], ids=["small", "comparison"])
def test_comparison_framework_counts_match_jax(small):
    """param_counts, the component breakdown (the reference's substring
    rules: the gate convs count under no component), the matching analysis
    and the model info equal the JAX framework's."""
    jcfg, pcfg, vocab = _configs(small)
    jf = JaxFramework(jcfg)
    jf.build_models(vocab)
    pf = PM.create_comparison_framework(pcfg, device="cpu")
    models = pf.build_models(vocab)
    assert all(p.is_meta for m in models.values() for p in m.parameters())
    assert pf.param_counts == jf.param_counts
    summary, want = pf.get_param_summary(), jf.get_param_summary()
    for name in want:
        assert summary[name] == want[name], name
    assert pf.parameter_matching_analysis() == jf.parameter_matching_analysis()
    assert pf.get_model_info() == jf.get_model_info()
    if not small:
        assert pf.param_counts == {"baseline": 44750080, "quartet": 51303696, "mop": 44776184}
        assert summary["mop"]["components"] == {
            "embeddings": 5406720, "attention": 13107200, "mlp": 26214400,
            "layer_norm": 21760, "lm_head": 0, "mop_components": 25600}


def test_comparison_framework_forward_pass_and_summary(capsys):
    jcfg, pcfg, vocab = _configs(small=True)
    pf = PM.create_comparison_framework(pcfg, device="cpu")
    pf.build_models(vocab)
    params = pf.init_params(seed=3)
    assert set(params) == {"baseline", "quartet", "mop"}
    assert all(p.device.type == "cpu" for ps in params.values() for p in ps.values())
    res = pf.test_forward_pass(batch_size=2, seq_len=8, vocab_size=vocab)
    jf = JaxFramework(jcfg)
    jf.build_models(vocab)
    want = jf.test_forward_pass(batch_size=2, seq_len=8, vocab_size=vocab)
    for name, w in want.items():
        assert "error" not in res[name], res[name]
        assert res[name]["logits_shape"] == w["logits_shape"] == (2, 8, vocab)
        assert np.isfinite(res[name]["loss_value"])
        assert res[name].get("mop_maps") == w.get("mop_maps")
    assert res["mop"]["mop_maps"]["views_shape"] == (2, 2, 3, 8)
    # A token beyond the vocabulary is reported for each model, not raised.
    bad = pf.test_forward_pass(batch_size=1, seq_len=4, vocab_size=10 * vocab)
    assert all("error" in r for r in bad.values())
    pf.print_comparison_summary()
    out = capsys.readouterr().out
    assert "PARAMETER MATCHING" in out and "quartet" in out


def test_comparison_framework_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.GPTComparisonFramework(PM.ComparisonConfig())
