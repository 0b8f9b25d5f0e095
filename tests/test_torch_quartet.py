"""K5 and the Quartet causal LM: the port's quartet op (its plain forward,
which CPU tensors run, and its recompute backward) against the JAX Pallas
kernel in TPU interpret mode and ``jax.grad`` through it; the statistics
order of K5's kept-rows kernels (``quartet_rows_schedule``) against the JAX
kernel in fp32 and bf16; the LM
(``TinyTransformerLM`` from ``create_gpt_quartet`` and
``create_gpt_baseline``) against the JAX model with transplanted weights,
for the Quartet, baseline and ``causal_std`` configs and with an additive
mask, with the kernel route's conditions; the reference goldens."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mop_tpu.models as J
import mop_tpu.ops.fused as JF
import mop_tpu_torch as P
import mop_tpu_torch.models as PM
import mop_tpu_torch.ops.fused as TF
from mop_tpu.models.gpt_comparison import ComparisonConfig
from mop_tpu.utils.torch_port import load_golden, port_torch_state_dict
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params
from tools.trajectory_parity import GPT_CONFIGS, LR, WD, make_token_batches


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
G_RTOL, G_ATOL = 10 * RTOL, 10 * ATOL
M_ATOL, M_RTOL = 1e-4, 1e-3
NAMES = ("q", "k", "v", "q2", "k2", "mixture", "quartet_scale")
VOCAB = 50


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
            + [np.float32(0.3), np.float32(1.2)])


def _jax_op(arrays, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        return JF.fused_quartet_attention(*[jnp.asarray(a, dtype) for a in arrays[:5]],
                                          jnp.asarray(arrays[5]), jnp.asarray(arrays[6]),
                                          force=True)


# ------------------------------ (a) the op ------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 16, 8), (1, 3, 13, 20)])
def test_quartet_op_matches_jax_kernel(shape):
    arrays = _inputs(shape, seed=shape[2])
    want = _jax_op(arrays)
    before = [f.launches for f in TF.KERNELS]
    got = TF.fused_quartet_attention(*[torch.from_numpy(np.asarray(a)) for a in arrays[:5]],
                                     float(arrays[5]), torch.tensor(arrays[6]))
    assert [f.launches for f in TF.KERNELS] == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_quartet_op_bf16_matches_jax_kernel():
    arrays = _inputs((2, 2, 16, 8), seed=3)
    want = np.asarray(_jax_op(arrays, jnp.bfloat16), np.float32)
    got = TF.fused_quartet_attention(
        *[torch.from_numpy(np.asarray(a)).bfloat16() for a in arrays[:5]], 0.3, 1.2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=5e-2)


def _oct_sum(x):
    """The sum over the last axis in the order of K5's kept-rows kernels: lane
    g of an eight-lane group sums columns g, g + 8, ... in order, then the
    lanes combine as ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)).
    Zero columns pad the last group (adding 0 is exact)."""
    x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 8))
    p = torch.zeros(*x.shape[:-1], 8, dtype=torch.float32)
    for c0 in range(0, x.shape[-1], 8):
        p = p + x[..., c0:c0 + 8]
    a = p[..., :4] + p[..., 4:]
    b = a[..., :2] + a[..., 2:]
    return b[..., 0] + b[..., 1]


def quartet_rows_schedule(q, k, v, q2, k2, mixture, quartet_scale, eps=1e-5):
    """K5's kept-rows kernels (``csrc/quartet_fwd.cu``) over (..., N, dk)
    inputs in fp32 or bf16, with their statistics in the kernels' order:
    each row's mean is an eight-lane sum (``_oct_sum``) over every column
    divided by N, its M2 the same order over the squared deviations (each
    added by one fused multiply-add, emulated in fp64), the row max, the sum
    of exponentials over the causal columns in the same order, and the
    normalised probabilities rounded to the compute dtype before P V. The
    products keep the compute dtype's rounding points (q * scale rounded,
    fp32 accumulation)."""
    cdt, f32 = q.dtype, torch.float32
    n, dk = q.shape[-2:]
    sc = torch.tensor(1.0 / np.sqrt(dk), dtype=cdt)
    s1 = (q * sc).to(f32) @ k.to(f32).transpose(-1, -2)
    s2 = (q2 * sc).to(f32) @ k2.to(f32).transpose(-1, -2)

    def standardize(s):
        mu = (_oct_sum(s) / n)[..., None]
        d = (s - mu).double()
        sq = torch.nn.functional.pad(d * d, (0, -n % 8))
        p = torch.zeros(*s.shape[:-1], 8, dtype=f32)
        for c0 in range(0, sq.shape[-1], 8):  # fma(d, d, p): one rounding
            p = (sq[..., c0:c0 + 8] + p.double()).to(f32)
        a = p[..., :4] + p[..., 4:]
        b = a[..., :2] + a[..., 2:]
        m2 = b[..., 0] + b[..., 1]
        den = torch.sqrt(m2 / max(1, n - 1)) + eps
        return (s - mu) / den[..., None]

    s1n, s2n = standardize(s1), standardize(s2)
    m = torch.tensor(mixture, dtype=f32)
    qs = torch.tensor(quartet_scale, dtype=f32)
    x = (1.0 - m) * s1n + m * (s1n * s2n) * qs
    keep = torch.ones(n, n, dtype=torch.bool).tril()
    x = x.masked_fill(~keep, float("-inf"))
    e = torch.exp(x - x.amax(-1, keepdim=True))
    p = (e / _oct_sum(e)[..., None]).to(cdt)
    return (p.to(f32) @ v.to(f32)).to(cdt)


@pytest.mark.parametrize("n", [1, 100, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_statistics_schedule_matches_jax_kernel(n, dtype):
    """K5's kept-rows kernels take each row's statistics in one pass over the
    kept rows (eight-lane sums) where the streaming kernel merged tiles by
    Chan's update: that order, mirrored by ``quartet_rows_schedule``, against
    the JAX kernel in interpret mode and the plain version, at one row, a
    ragged key block and the LM's N. fp32 within the forward tolerance; bf16
    within the bf16 tolerance, with at most 1% of the outputs differing (the
    probabilities are rounded at the same point)."""
    arrays = _inputs((1, 2, n, 80), seed=50 + n)
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(np.asarray(a)).to(tdt) for a in arrays[:5]]
    got = quartet_rows_schedule(*ts, 0.3, 1.2)
    want = np.asarray(_jax_op(arrays, getattr(jnp, dtype)), np.float32)
    plain = TF.fused_quartet_attention_plain(*ts, 0.3, 1.2)
    assert got.dtype == tdt and got.shape == (1, 2, n, 80)
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got, plain, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=5e-2)
        assert (got.float().numpy() != want).mean() <= 0.01
        assert (got != plain).float().mean().item() <= 0.01


def test_quartet_statistics_run_over_the_masked_columns():
    """Changing a key that every row masks but row N-1 still moves the
    earlier rows, through the standardization's mean and std."""
    arrays = _inputs((1, 1, 12, 8), seed=4)
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays[:5]]
    y0 = TF.fused_quartet_attention(*ts, 0.3, 1.2)
    k = ts[1].clone()
    k[..., -1, :] += 3.0
    y1 = TF.fused_quartet_attention(ts[0], k, *ts[2:], 0.3, 1.2)
    assert (y1[..., :-1, :] - y0[..., :-1, :]).abs().max() > 1e-3


def test_quartet_strided_views_match_contiguous():
    arrays = _inputs((2, 16, 2, 8), seed=5)
    strided = [torch.from_numpy(a).transpose(1, 2) for a in arrays[:5]]
    want = TF.fused_quartet_attention(*[t.contiguous() for t in strided], 0.3, 1.2)
    got = TF.fused_quartet_attention(*strided, 0.3, 1.2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_quartet_kernel_refuses_wide_heads():
    t = torch.zeros(1, 1, 16, 129)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        TF._quartet_fwd_cuda(t, t, t, t, t, 0.3, 1.2, 1e-5)


def test_quartet_function_grads_match_jax_grad():
    arrays = _inputs((2, 2, 16, 8), seed=6)
    dy = np.random.default_rng(7).standard_normal((2, 2, 16, 8)).astype(np.float32)

    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            y = JF.fused_quartet_attention(*a, force=True)
        return jnp.sum(y * dy)

    want = jax.grad(loss, argnums=tuple(range(7)))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    y = TF.fused_quartet_attention(*ts)
    assert len(y.grad_fn.saved_tensors) == 7
    got = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=G_RTOL, atol=G_ATOL,
                                   err_msg=name)


# ------------------------------ (b) the LM ------------------------------

LMS = {
    "quartet": (J.create_gpt_quartet, PM.create_gpt_quartet, {}),
    "baseline": (J.create_gpt_baseline, PM.create_gpt_baseline, {}),
    "quartet_causal_std": (None, None, dict(causal_std=True)),
    "quartet_dropout": (J.create_gpt_quartet, PM.create_gpt_quartet, dict(dropout=0.1)),
}


def _lm_pair(name, seed=0):
    jfac, pfac, extra = LMS[name]
    cfg = dict(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=16, bias=False)
    cfg.update(extra)
    if jfac is None:  # the factories drop causal_std: build the model directly
        jm = J.TinyTransformerLM(vocab_size=VOCAB, config=J.TransformerConfig(**cfg))
        pm = PM.TinyTransformerLM(VOCAB, PM.TransformerConfig(**cfg), device="cpu")
    else:
        jm = jfac(VOCAB, J.TransformerConfig(**cfg))
        pm = pfac(VOCAB, PM.TransformerConfig(**cfg), device="cpu")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    tgt = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(idx)))
    for blk in params["params"].values():  # move the Quartet scalars off their init
        if isinstance(blk, dict) and "mixture" in blk.get("attn", {}):
            blk["attn"]["mixture"] = rng.uniform(-1.0, 1.0, (1,)).astype(np.float32)
            blk["attn"]["quartet_scale"] = rng.uniform(0.5, 1.5, (1,)).astype(np.float32)
    return jm, params, load_jax_params(pm, params), idx, tgt


def _lm_check(name, mask=None):
    jm, params, pm, idx, tgt = _lm_pair(name)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(p):
        logits, l_ = jm.apply(p, jnp.asarray(idx), attention_mask=jmask,
                              targets=jnp.asarray(tgt), train=False)
        return l_, logits

    (want_loss, want_logits), gp = jax.value_and_grad(loss, has_aux=True)(params)
    pm.eval()
    logits, got_loss = pm(torch.from_numpy(idx).long(),
                          attention_mask=None if mask is None else torch.from_numpy(mask),
                          targets=torch.from_numpy(tgt).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=RTOL)
    got_loss.backward()
    want_g = jax_state_dict(jax.device_get(gp))
    got_g = {k: p.grad for k, p in pm.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[k], atol=M_ATOL, rtol=M_RTOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(LMS))
def test_lm_logits_loss_and_grads_match_jax(name):
    """Eval mode: the Quartet configs run K5's plain version (recompute
    backward), causal_std and the baseline the composed path."""
    _lm_check(name)


@pytest.mark.parametrize("name", ["quartet", "baseline"])
def test_lm_with_additive_mask_matches_jax(name):
    mask = np.zeros((2, 1, 1, 16), np.float32)
    mask[1, ..., 10:] = -1e4  # the second sequence's keys from 10 on are padding
    _lm_check(name, mask)


def _k5_calls(model, idx, **kw):
    plain = TF.fused_quartet_attention_plain
    calls = []
    TF.fused_quartet_attention_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        with torch.no_grad():
            model(idx, **kw)
    finally:
        TF.fused_quartet_attention_plain = plain
    return len(calls)


def test_k5_route_follows_the_jax_conditions():
    _, _, pm, idx, _ = _lm_pair("quartet_dropout")
    idx = torch.from_numpy(idx).long()
    assert _k5_calls(pm.eval(), idx) == 2  # once a block
    assert _k5_calls(pm.eval(), idx, attention_mask=torch.zeros(1, 1, 1, 16)) == 0
    pm.train()
    P.set_generator(pm, torch.Generator().manual_seed(0))
    assert _k5_calls(pm, idx) == 0  # training with dropout on composes
    _, _, pm0, _, _ = _lm_pair("quartet")
    assert _k5_calls(pm0.train(), idx) == 2  # dropout 0: the kernel trains too
    _, _, pmc, _, _ = _lm_pair("quartet_causal_std")
    assert _k5_calls(pmc.eval(), idx) == 0


def test_need_weights_matches_jax_and_composes():
    cfg = dict(n_layer=1, n_head=2, n_embd=32, dropout=0.0, block_size=16)
    x = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
    jm = J.CausalSelfAttention(J.TransformerConfig(**cfg))
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    pm = load_jax_params(PM.CausalSelfAttention(PM.TransformerConfig(**cfg)), params).eval()
    want_y, want_att = jm.apply(params, jnp.asarray(x), need_weights=True)
    plain = TF.fused_quartet_attention_plain
    TF.fused_quartet_attention_plain = None  # the op must not run
    try:
        with torch.no_grad():
            y, att = pm(torch.from_numpy(x), need_weights=True)
    finally:
        TF.fused_quartet_attention_plain = plain
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), rtol=RTOL, atol=ATOL)


def test_dropout_trains_from_the_generator_only():
    _, _, pm, idx, tgt = _lm_pair("quartet_dropout")
    idx, tgt = torch.from_numpy(idx).long(), torch.from_numpy(tgt).long()
    pm.train()
    with pytest.raises(RuntimeError, match="generator"):
        pm(idx, targets=tgt)
    losses = []
    for _ in range(2):
        P.set_generator(pm, torch.Generator().manual_seed(5))
        losses.append(pm(idx, targets=tgt)[1].item())
    assert losses[0] == losses[1] != pm.eval()(idx, targets=tgt)[1].item()


def test_lm_refuses_sequences_longer_than_the_block():
    _, _, pm, _, _ = _lm_pair("baseline")
    with pytest.raises(ValueError, match="block size"):
        pm(torch.zeros(1, 17, dtype=torch.long))


def test_lm_scalar_leaves_round_trip_exactly():
    """JAX -> port -> JAX gives the shape-(1,) leaves back bit for bit."""
    _, params, pm, _, _ = _lm_pair("quartet", seed=4)
    back = port_torch_state_dict({k: v.detach().numpy() for k, v in pm.state_dict().items()},
                                 params)["params"]
    for i in range(2):
        leaf = params["params"][f"blocks_{i}"]["attn"]
        attn = pm.blocks[i].attn
        for key in ("mixture", "quartet_scale"):
            got = getattr(attn, key).detach().numpy()
            assert got.shape == (1,) and np.array_equal(got, leaf[key]), key
            assert np.array_equal(np.asarray(back[f"blocks_{i}"]["attn"][key]), leaf[key]), key


def test_lm_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.create_gpt_quartet(VOCAB, PM.TransformerConfig(n_layer=1, n_embd=32, n_head=2))


def test_comparison_config_param_counts_match_jax():
    """The reference comparison config (8 layers, 8 heads, 640 wide, block
    256) at vocab 8192, as chip_smoke.py runs it (built on the meta device).
    The quartet count is also chip_smoke.py's ``LM_JAX_PARAMS``."""
    c = ComparisonConfig()
    cfg = dict(n_layer=c.n_layer, n_head=c.n_head, n_embd=c.n_embd, dropout=c.dropout,
               block_size=c.block_size, bias=c.bias)
    counts = {}
    for name, jfac, pfac in (("quartet", J.create_gpt_quartet, PM.create_gpt_quartet),
                             ("baseline", J.create_gpt_baseline, PM.create_gpt_baseline)):
        jm = jfac(8192, J.TransformerConfig(**cfg))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 16), jnp.int32)))
        counts[name] = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        with torch.device("meta"):
            model = pfac(8192, PM.TransformerConfig(**cfg), device="meta")
        assert sum(p.numel() for p in model.parameters()) == counts[name]
    assert counts["quartet"] == 51303696


# ------------------------------ (c) goldens ------------------------------


def _golden_state(ws):
    """The reference's state dict without its tied head, which is ``wte``."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in ws.items()}
    head = sd.pop("lm_head.weight")
    assert torch.equal(head, sd["wte.weight"])
    return sd


def test_quartet_lm_golden():
    ins, ws, outs = load_golden(os.path.join(GOLDEN, "quartet_lm.npz"))
    cfg = PM.TransformerConfig(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=16,
                               bias=False, use_quartet=True)
    model = PM.TinyTransformerLM(VOCAB, cfg, device="cpu").eval()
    model.load_state_dict(_golden_state(ws), strict=True)
    with torch.no_grad():
        logits, loss = model(torch.from_numpy(ins["idx"]).long(),
                             targets=torch.from_numpy(ins["targets"]).long())
    np.testing.assert_allclose(logits.numpy(), outs["logits"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), outs["loss"], rtol=RTOL)


@pytest.mark.parametrize("name,factory", [("quartet", PM.create_gpt_quartet),
                                          ("base", PM.create_gpt_baseline),
                                          ("mop", PM.create_gpt_mop)])
def test_gpt_trajectory_matches_torch_reference(name, factory):
    """The reference's lockstep run (eval mode, AdamW + cosine, 30 steps):
    the Quartet LM trains through K5's plain forward and its recompute
    backward, and so does GPT-MoP, whose config keeps Quartet attention on."""
    cfg = GPT_CONFIGS["small"]
    data = np.load(os.path.join(GOLDEN, f"trajectory_gpt_{name}.npz"))
    model = factory(cfg["vocab"], PM.TransformerConfig(
        n_layer=cfg["n_layer"], n_head=cfg["n_head"], n_embd=cfg["n_embd"], dropout=0.0,
        block_size=cfg["block_size"]), device="cpu")
    model.load_state_dict(_golden_state({k[3:]: data[k] for k in data.files
                                         if k.startswith("w__")}), strict=True)
    xs, ys = make_token_batches(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    sch = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=xs.shape[0])
    model.eval()
    losses = []
    for x, y in zip(xs, ys):
        opt.zero_grad(set_to_none=True)
        _, loss = model(torch.from_numpy(x), targets=torch.from_numpy(y))
        loss.backward()
        opt.step()
        sch.step()
        losses.append(loss.item())
    golden = data["out__losses"]
    np.testing.assert_allclose(losses[:10], golden[:10], rtol=2e-4)
    np.testing.assert_allclose(losses[10:], golden[10:], rtol=5e-3)
