"""The port's LM train step (``make_lm_train_step``) against ``mop_tpu``'s for
the baseline GPT, the Quartet LM and GPT-MoP, in fp32 (bf16 in
``test_torch_lm_train_step_bf16.py``); its
accumulation, generator, integer-id and K5-route rules; the JAX step's clip
of 0; the character-LM CLI and its corpus.

The JAX Quartet attention runs here as the JAX package runs it on the CPU:
its dispatcher takes the composed reference (``_quartet_reference``) off
the TPU, the function K5 computes; the port's quartet runs K5's plain
version (CPU tensors) with K5's recompute backward."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch as P
import mop_tpu_torch.models as PM
import mop_tpu_torch.ops.fused as TF
from mop_tpu.parallel import make_lm_train_step as jax_lm_step
from mop_tpu.parallel import make_mesh
from mop_tpu_torch.cli import train_gpt_char
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB, B, T, STEPS = 64, 4, 16, 3
LR, WD, CLIP = 3e-4, 0.1, 1.0
CFG = dict(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=T, bias=False)
MODELS = {
    "baseline": (J.create_gpt_baseline, PM.create_gpt_baseline, {}),
    "quartet": (J.create_gpt_quartet, PM.create_gpt_quartet, {}),
    "mop": (J.create_gpt_mop, PM.create_gpt_mop, dict(n_views=3, n_kernels=2)),
}
# fp32: the forward tolerance on the losses; the params after three AdamW
# steps within 1e-3 of each tensor's largest magnitude, as chip_smoke.py
# holds fp32 grads.
F32_LOSS_RTOL, F32_PARAM_FRAC = 2e-4, 1e-3
# bf16: both steps round the params, activations and products to bf16 at the
# same points, but XLA's CPU backend fuses elementwise chains and may keep
# their intermediates in fp32 where PyTorch rounds each op's output, so the
# two differ by about one bf16 rounding (2^-8 relative) at many places. The
# loss, a mean over B*T tokens, averages that down (measured: 2e-5 relative
# at most). The params cannot be held per tensor: AdamW's first steps move
# each weight by about lr whatever its grad's size, so a grad within bf16
# noise of zero (a bias starting at 0; the first layer's quartet_scale,
# whose grad cancels to 1% of the second layer's and differs by 0.4% even
# in fp32) flips its weight's step. So the bf16 check is the update of the
# whole model, ||dP_port - dP_jax|| / ||dP_jax|| over every parameter
# (measured 0.054-0.056 for the three models); a wrong grad in any large
# tensor gives an uncorrelated update there, about 1.4. The fp32 case holds
# each tensor.
BF16_LOSS_RTOL, BF16_UPDATE_REL = 1e-3, 0.15


def _batches(seed=0, n=STEPS):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, VOCAB, (n, B, T)).astype(np.int32)
    return idx, np.roll(idx, -1, axis=-1)


def _pair(name, seed=0, **cfg_over):
    jfac, pfac, kw = MODELS[name]
    cfg = {**CFG, **cfg_over}
    jm = jfac(VOCAB, J.TransformerConfig(**cfg), **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, T), jnp.int32)))
    for blk in params["params"].values():  # move the raw scalars off their init
        if isinstance(blk, dict) and "mixture" in blk.get("attn", {}):
            blk["attn"]["mixture"] = np.array([-1.0], np.float32)
        if isinstance(blk, dict) and "fuse" in blk:
            blk["fuse"]["alpha"] = np.array([1.3, 0.7], np.float32)
    pm = load_jax_params(pfac(VOCAB, PM.TransformerConfig(**cfg), device="cpu", **kw), params)
    return jm, params, pm


def _jax_run(jm, params, xs, ys, compute_dtype):
    tx = optax.adamw(LR, weight_decay=WD)
    step = jax_lm_step(jm, tx, make_mesh(n_devices=1), grad_clip=CLIP,
                       compute_dtype=compute_dtype)
    opt = tx.init(params)
    losses = []
    for i, (x, y) in enumerate(zip(xs, ys)):
        params, opt, m = step(params, opt, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return losses, jax_state_dict(jax.device_get(params))


def _port_run(pm, xs, ys, compute_dtype, **kw):
    opt = torch.optim.AdamW(pm.parameters(), lr=LR, weight_decay=WD)
    step = P.make_lm_train_step(pm, opt, grad_clip=CLIP, compute_dtype=compute_dtype,
                                device="cpu", **kw)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
              for x, y in zip(xs, ys)]
    return losses, {k: v.detach().numpy() for k, v in pm.state_dict().items()}


def _assert_params_close(got, want, frac):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= frac * np.abs(w).max(), f"{k}: max-abs {err:.3e} of {np.abs(w).max():.3e}"


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dtype", ["float32"])
def test_lm_train_step_matches_jax(name, dtype):
    """Three steps on the same batches at dropout 0, AdamW(3e-4, wd 0.1)
    against optax.adamw(3e-4, weight_decay=0.1), grad clip 1.0: the
    per-step losses and the params after the last step. The bf16 cases are
    in ``test_torch_lm_train_step_bf16.py`` (each file's JAX compiles on one
    worker)."""
    check_lm_train_step(name, dtype)


def check_lm_train_step(name, dtype):
    jm, params, pm = _pair(name)
    xs, ys = _batches(seed=1)
    fp32 = dtype == "float32"
    want_losses, want_params = _jax_run(jm, params, xs, ys, None if fp32 else jnp.bfloat16)
    losses, got_params = _port_run(pm, xs, ys, None if fp32 else torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    np.testing.assert_allclose(losses, want_losses,
                               rtol=F32_LOSS_RTOL if fp32 else BF16_LOSS_RTOL)
    if fp32:
        _assert_params_close(got_params, want_params, F32_PARAM_FRAC)
    else:
        before = jax_state_dict(params)
        diff, upd = (np.concatenate([(p[k] - before[k]).ravel() for k in sorted(before)])
                     for p in (got_params, want_params))
        rel = np.linalg.norm(diff - upd) / np.linalg.norm(upd)
        assert rel <= BF16_UPDATE_REL, f"update of the whole model: relative error {rel:.3f}"


def test_bf16_mix_is_rounded_where_jax_rounds_it():
    """Under a bf16 compute dtype the mixture is a bf16 parameter, so
    m = sigmoid(mixture) is a bf16 scalar before K5 reads it in fp32, as in
    the JAX module (``jax.nn.sigmoid`` of the bf16 leaf, then the fused op's
    cast to fp32)."""
    _, params, pm = _pair("quartet")
    seen = []
    plain = TF.fused_quartet_attention_plain
    TF.fused_quartet_attention_plain = lambda *a, **k: seen.append(a[5]) or plain(*a, **k)
    try:
        xs, ys = _batches(seed=2, n=1)
        P.make_lm_train_step(pm, torch.optim.SGD(pm.parameters(), lr=0.0), device="cpu")(
            torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
    finally:
        TF.fused_quartet_attention_plain = plain
    assert len(seen) == CFG["n_layer"]
    for i, m in enumerate(seen):
        mixture = params["params"][f"blocks_{i}"]["attn"]["mixture"]
        want = float(jnp.asarray(jax.nn.sigmoid(jnp.asarray(mixture, jnp.bfloat16))[0],
                                 jnp.float32))
        assert m.dtype == torch.bfloat16 and m.item() == want
        assert want != float(jax.nn.sigmoid(mixture[0]))  # the rounding shows


def test_accum_steps_equal_one_big_step():
    xs, ys = _batches(seed=3, n=1)
    out = []
    for accum in (1, 2):
        _, _, pm = _pair("mop")
        out.append(_port_run(pm, xs, ys, None, accum_steps=accum))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    _assert_params_close(out[1][1], out[0][1], F32_PARAM_FRAC)
    _, _, pm = _pair("baseline")
    step = P.make_lm_train_step(pm, torch.optim.SGD(pm.parameters(), 0.1), accum_steps=3,
                                device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        step(torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))


def test_dropout_draws_only_from_the_step_generator():
    xs, ys = _batches(seed=4, n=2)
    runs = []
    for _ in range(2):
        _, _, pm = _pair("mop", dropout=0.1)
        step = P.make_lm_train_step(pm, torch.optim.AdamW(pm.parameters(), LR), device="cpu")
        g = torch.Generator().manual_seed(6)
        before = torch.get_rng_state()
        runs.append([float(step(torch.from_numpy(x), torch.from_numpy(y), g)["loss"])
                     for x, y in zip(xs, ys)])
        assert torch.equal(torch.get_rng_state(), before)
    assert runs[0] == runs[1]
    with pytest.raises(RuntimeError, match="generator"):
        step(torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))


def test_token_ids_stay_integer_under_bf16():
    _, _, pm = _pair("baseline")
    seen = []
    pm.wte.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    xs, ys = _batches(seed=5, n=1)
    m = P.make_lm_train_step(pm, torch.optim.SGD(pm.parameters(), 0.1), device="cpu")(
        torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
    assert seen == [torch.int32] and m["loss"].dtype == torch.float32


@pytest.mark.parametrize("dropout,calls", [(0.0, 2), (0.1, 0)])
def test_quartet_trains_through_k5_only_without_dropout(dropout, calls):
    """In train mode at dropout 0 the Quartet attention calls K5's fused op
    (its plain version on the CPU) once a layer; at dropout 0.1 it composes,
    as the JAX module does."""
    _, _, pm = _pair("quartet", dropout=dropout)
    n = []
    plain = TF.fused_quartet_attention_plain
    TF.fused_quartet_attention_plain = lambda *a, **k: n.append(1) or plain(*a, **k)
    try:
        xs, ys = _batches(seed=6, n=1)
        P.make_lm_train_step(pm, torch.optim.SGD(pm.parameters(), 0.1), device="cpu")(
            torch.from_numpy(xs[0]), torch.from_numpy(ys[0]), torch.Generator().manual_seed(0))
    finally:
        TF.fused_quartet_attention_plain = plain
    assert len(n) == calls


def test_clip_of_zero_zeroes_the_grads_as_the_jax_lm_step():
    jm, params, pm = _pair("baseline")
    xs, ys = _batches(seed=7, n=1)
    step = jax_lm_step(jm, optax.sgd(1.0), make_mesh(n_devices=1), grad_clip=0.0,
                       compute_dtype=None)
    jp, _, _ = step(params, optax.sgd(1.0).init(params), jnp.asarray(xs[0]),
                    jnp.asarray(ys[0]), jax.random.PRNGKey(0))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(jp),
                                                    jax.tree_util.tree_leaves(params)))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    P.make_lm_train_step(pm, torch.optim.SGD(pm.parameters(), 1.0), grad_clip=0.0,
                         compute_dtype=None, device="cpu")(
        torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
    assert all(torch.equal(v, before[k]) for k, v in pm.state_dict().items())


def test_lm_train_step_defaults_to_the_gpu(monkeypatch):
    _, _, pm = _pair("baseline")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_lm_train_step(pm, torch.optim.SGD(pm.parameters(), 0.1))


# ------------------------------ the CLI ------------------------------


def test_cli_corpus_is_the_jax_examples():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
    try:
        import train_gpt_char as jax_example
    finally:
        sys.path.pop(0)
    want = jax_example.synthetic_corpus(n_chars=20_000)
    got = train_gpt_char.synthetic_corpus(n_chars=20_000)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cli_trains_and_prints_a_finite_loss(capsys):
    loss = train_gpt_char.main(["--steps", "2", "--device", "cpu", "--n_layer", "1",
                                "--n_head", "2", "--n_embd", "32", "--block", "16",
                                "--batch", "4"])
    out = capsys.readouterr().out
    first = [ln for ln in out.splitlines() if ln.startswith("step    1 loss")]
    assert len(first) == 1 and np.isfinite(float(first[0].split()[-1]))
    assert np.isfinite(loss) and f"mop: final loss {loss:.4f}" in out
