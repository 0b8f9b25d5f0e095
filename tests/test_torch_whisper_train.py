"""Training Whisper-MoP in the port against the JAX package: five steps of
``tools/bench_lm.py``'s Whisper recipe (AdamW 3e-4 / 0.1, a
``RandomState(0)`` mel, targets the ids rolled by one) in fp32 at the
golden's size, losses and parameters in lockstep with JAX's; the demo CLI
(``mop_tpu_torch.cli.whisper_demo``): its tone data equal to the JAX
example's, and three steps with ``--device cpu``; and (in the slow lane) the
``trajectory_whisper_base`` / ``trajectory_whisper_mop`` goldens, the
reference's 30-step lockstep runs, replayed."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu_torch.cli import whisper_demo
from mop_tpu_torch.utils.jax_weights import jax_state_dict, load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
GOLDEN_CFG = dict(n_layer_enc=2, n_layer_dec=2, n_head=2, n_embd=32, n_mels=16, n_audio_ctx=32,
                  n_text_ctx=32, dropout=0.0, bias=False, n_views=2, n_kernels=1,
                  kernel_size=3, vocab_size=50)
STEPS, BATCH, T_AUDIO, T_TEXT = 5, 4, 24, 12
LR, WD = 3e-4, 0.1  # tools/bench_lm.py's Whisper optimizer
LOSS_RTOL = 2e-4
# The params after the last step, each tensor within this fraction of its
# largest magnitude (tests/test_torch_lm_train_step.py's F32_PARAM_FRAC).
PARAM_FRAC = 1e-3


def _bench_batch():
    """tools/bench_lm.py's batch at the golden's size."""
    rs = np.random.RandomState(0)
    mel = rs.randn(BATCH, T_AUDIO, GOLDEN_CFG["n_mels"]).astype(np.float32)
    ids = rs.randint(0, GOLDEN_CFG["vocab_size"], (BATCH, T_TEXT)).astype(np.int32)
    return mel, ids, np.roll(ids, -1, axis=-1)


@pytest.mark.parametrize("kind", ["mop", "baseline"])
def test_bench_recipe_lockstep_with_jax(kind):
    jfac = {"mop": J.create_whisper_mop, "baseline": J.create_whisper_baseline}[kind]
    pfac = {"mop": PM.create_whisper_mop, "baseline": PM.create_whisper_baseline}[kind]
    mel, ids, tgt = _bench_batch()
    jm = jfac(J.WhisperConfig(**GOLDEN_CFG))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel[:2]), jnp.asarray(ids[:2]))
    tx = optax.adamw(LR, weight_decay=WD)

    @jax.jit
    def jstep(p, o):
        def lf(pp):
            return jm.apply(pp, jnp.asarray(mel), jnp.asarray(ids), targets=jnp.asarray(tgt),
                            train=True)[1]
        loss, g = jax.value_and_grad(lf)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    pm = load_jax_params(pfac(PM.WhisperConfig(**GOLDEN_CFG), device="cpu"),
                         jax.device_get(params)).train()
    opt = torch.optim.AdamW(pm.parameters(), lr=LR, weight_decay=WD)
    o = tx.init(params)
    want, got = [], []
    for _ in range(STEPS):
        params, o, loss = jstep(params, o)
        want.append(float(loss))
        opt.zero_grad(set_to_none=True)
        loss_t = pm(torch.from_numpy(mel), torch.from_numpy(ids).long(),
                    targets=torch.from_numpy(tgt).long())[1]
        loss_t.backward()
        opt.step()
        got.append(loss_t.item())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    final = jax_state_dict(jax.device_get(params))
    for k, p in pm.named_parameters():
        err = np.abs(p.detach().numpy() - final[k]).max()
        assert err <= PARAM_FRAC * np.abs(final[k]).max(), f"{k}: max-abs {err:.3e}"


# ------------------------------ the demo CLI ------------------------------


def test_demo_tone_dataset_is_the_jax_examples():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import whisper_demo as jax_example
    finally:
        sys.path.pop(0)
    want_audio, want_tokens = jax_example.tone_dataset(16)
    got_audio, got_tokens = whisper_demo.tone_dataset(16)
    np.testing.assert_array_equal(got_audio, want_audio)
    np.testing.assert_array_equal(got_tokens, want_tokens)


def test_demo_trains_on_the_cpu(capsys):
    losses = whisper_demo.main(["--steps", "3", "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "step   1 loss" in out and f"final loss {losses[-1]:.4f}" in out


def test_demo_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        whisper_demo.main(["--steps", "1"])


# ------------------------------ trajectory goldens ------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name,factory", [("base", PM.create_whisper_baseline),
                                          ("mop", PM.create_whisper_mop)])
def test_whisper_trajectory_matches_torch_reference(name, factory):
    """The reference's lockstep run (eval mode, AdamW + cosine, 30 steps,
    tools/trajectory_parity.py --family whisper) from its own weights."""
    from tools.trajectory_parity import LR as T_LR
    from tools.trajectory_parity import WD as T_WD
    from tools.trajectory_parity import WHISPER_CONFIGS, make_whisper_batches, whisper_cfgs

    cfg = WHISPER_CONFIGS["small"]
    data = np.load(os.path.join(GOLDEN, f"trajectory_whisper_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("w__")}
    assert torch.equal(sd.pop("lm_head.weight"), sd["wte.weight"])
    model = factory(PM.WhisperConfig(**whisper_cfgs(cfg)), device="cpu")
    model.load_state_dict(sd, strict=True)
    mels, idss, ys = make_whisper_batches(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=T_LR, weight_decay=T_WD)
    sch = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=mels.shape[0])
    model.eval()
    losses = []
    for mel, ids, y in zip(mels, idss, ys):
        opt.zero_grad(set_to_none=True)
        loss = model(torch.from_numpy(mel), torch.from_numpy(ids), targets=torch.from_numpy(y))[1]
        loss.backward()
        opt.step()
        sch.step()
        losses.append(loss.item())
    golden = data["out__losses"]
    np.testing.assert_allclose(losses[:10], golden[:10], rtol=2e-4)
    np.testing.assert_allclose(losses[10:], golden[10:], rtol=5e-3)
    assert golden[-1] < golden[0] - 0.1
