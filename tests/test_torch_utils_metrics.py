"""The port's ``utils.metrics``, ``utils.debug``, ``utils.profiling`` and
``visualization`` against the JAX package's, on the CPU.

- ``lm_nll`` and ``lm_perplexity`` on a small GPT (2 layers, 32 wide) with the
  JAX init's weights: the JAX functions' values within the forward's
  tolerance (rtol 2e-4), unmasked and masked, a padded last batch too;
  ``topk_accuracy`` on random logits with ties; ``wer``, ``cer`` and
  ``_edit_distance`` on ``tests/test_metrics.py``'s cases.
- ``tree_isfinite``, ``guard_nans``, ``check_finite`` (the same message) and
  ``checkify_step`` (a NaN made in a backward raises, naming its op).
- ``ThroughputMeter``'s warmup rule against JAX's over the same step
  sequence, ``chip_peak_bf16_flops`` with no card, ``trace`` writing a
  Chrome trace of host events, ``annotate``'s span in it.
- ``visualize_gates`` writes ``tests/test_visualization.py``'s PNG set from
  tensors.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.utils.debug as JD
import mop_tpu.utils.metrics as JM
import mop_tpu.utils.profiling as JP
import mop_tpu_torch.utils.debug as TD
import mop_tpu_torch.utils.metrics as TM
import mop_tpu_torch.utils.profiling as TP
from _torch_decode_common import _one_torch_thread, lm_pair  # noqa: F401


def _tokens(n=6, t=16, vocab=40, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, t)).astype(np.int32)


@pytest.fixture(scope="module")
def gpt():
    return lm_pair("baseline", seed=1)


def test_lm_nll_matches_jax(gpt):
    jm, params, pm = gpt
    idx = _tokens()
    want = float(JM.lm_nll(jm, params, jnp.asarray(idx)))
    got = float(TM.lm_nll(pm, torch.from_numpy(idx)).detach())
    np.testing.assert_allclose(got, want, rtol=2e-4)
    mask = np.ones(idx.shape, np.float32)
    mask[:, 10:] = 0.0
    mask[2] = 0.0
    want = float(JM.lm_nll(jm, params, jnp.asarray(idx), jnp.asarray(mask)))
    got = TM.lm_nll(pm, torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), want, rtol=2e-4)
    # Differentiable, as the JAX function is under jax.grad.
    got.backward()
    assert all(p.grad is not None for p in pm.parameters() if p.requires_grad)


@pytest.mark.parametrize("batch_size,masked", [(6, False), (4, False), (4, True)])
def test_lm_perplexity_matches_jax(gpt, batch_size, masked):
    jm, params, pm = gpt
    idx = _tokens()
    mask = None
    if masked:
        mask = np.ones(idx.shape, np.float32)
        mask[:, 10:] = 0.0
        mask[2] = 0.0
    want = JM.lm_perplexity(jm, params, idx, batch_size=batch_size, mask=mask)
    got = TM.lm_perplexity(pm, idx, batch_size=batch_size, mask=mask)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_allclose(got[0], math.exp(got[1]), rtol=1e-12)


def test_topk_accuracy_matches_jax_ties_included():
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 4, (64, 10)).astype(np.float32)  # many ties
    labels = rng.integers(0, 10, (64,))
    for k in (1, 2, 3, 5, 10):
        want = float(JM.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), k))
        got = float(TM.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k))
        assert got == want, k
    logits = torch.tensor([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1], [0.2, 0.3, 0.5]])
    labels = torch.tensor([1, 2, 1])
    assert [float(TM.topk_accuracy(logits, labels, k)) for k in (1, 2, 3)] == pytest.approx(
        [1 / 3, 2 / 3, 1.0])


def test_wer_cer_and_edit_distance_cases():
    for a, b in (("kitten", "sitting"), ("", "abc"), ("abc", ""), ([1, 2, 3], [1, 2, 3])):
        assert TM._edit_distance(a, b) == JM._edit_distance(a, b)
    assert TM._edit_distance("kitten", "sitting") == 3
    cases = [("a b c", "a x c"), ("a b c", "a b"), ("a b", "a x b y"),
             ([[1, 2, 3], [4, 5]], [[1, 2], [4, 5]])]
    for r, h in cases:
        assert TM.wer(r, h) == JM.wer(r, h)
    assert TM.wer("a b c", "a x c") == pytest.approx(1 / 3)
    for r, h in (("abc", "abc"), ("abc", "axc"), (["hello world", "ab"], ["hello word", "b"])):
        assert TM.cer(r, h) == JM.cer(r, h)
    with pytest.raises(ValueError):
        TM.wer("", "x")
    with pytest.raises(ValueError):
        TM.cer("", "x")


def test_tree_isfinite_and_guards():
    model = torch.nn.Linear(3, 2)
    tree = {"a": torch.ones(2), "b": [torch.arange(3), (torch.zeros(1),)], "c": 1.5}
    jtree = {"a": jnp.ones(2), "b": [jnp.arange(3), (jnp.zeros(1),)], "c": 1.5}
    assert bool(TD.tree_isfinite(tree)) == bool(JD.tree_isfinite(jtree)) is True
    assert bool(TD.tree_isfinite(model)) and bool(TD.tree_isfinite({"i": torch.arange(2)}))
    bad = {**tree, "a": torch.tensor([1.0, float("inf")])}
    assert bool(TD.tree_isfinite(bad)) == bool(JD.tree_isfinite({**jtree, "a": jnp.array(
        [1.0, jnp.inf])})) is False
    with torch.no_grad():
        model.weight[0, 0] = float("nan")
    assert not bool(TD.tree_isfinite(model))

    step = TD.guard_nans(lambda x: {"loss": x.sum()})
    out, flag = step(torch.ones(3))
    assert float(out["loss"]) == 3.0 and bool(flag)
    TD.check_finite(flag)
    _, flag = TD.guard_nans(lambda x: {"loss": x.sum()}, params=model)(torch.ones(3))
    with pytest.raises(FloatingPointError) as got:
        TD.check_finite(flag, "unit")
    with pytest.raises(FloatingPointError) as want:
        JD.check_finite(jnp.asarray(False), "unit")
    assert str(got.value) == str(want.value)


def test_checkify_step_names_the_op_that_made_a_nan():
    w = torch.tensor([0.0, 1.0], requires_grad=True)

    def step(x):
        loss = (torch.sqrt(w) * 0.0 * x).sum()  # sqrt's backward at 0: 0 / 0
        loss.backward()
        return loss

    step(torch.ones(2))  # unchecked: the NaN grad passes silently
    assert torch.isnan(w.grad).any()
    w.grad = None
    with pytest.raises(RuntimeError, match="SqrtBackward"):
        TD.checkify_step(step)(torch.ones(2))


def test_throughput_meter_follows_the_jax_warmup_rule(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.5))
    now = {"t": 0.0}

    def tick():
        now["t"] = next(clock)
        return now["t"]

    got, want = TP.ThroughputMeter(warmup_steps=3), JP.ThroughputMeter(warmup_steps=3)
    for n in (8, 8, 8, 16, 16, 4):
        monkeypatch.setattr(TP.time, "perf_counter", lambda: now["t"])
        monkeypatch.setattr(JP.time, "perf_counter", lambda: now["t"])
        tick()
        got.step(n)
        want.step(n)
        assert (got._steps, got._samples, got._t0) == (want._steps, want._samples, want._t0)
    tick()
    assert got.steps_per_sec == want.steps_per_sec == 3 / (now["t"] - got._t0)
    assert got.samples_per_sec == want.samples_per_sec == 36 / (now["t"] - got._t0)
    assert TP.ThroughputMeter().samples_per_sec == 0.0
    assert got.per_chip(10.0) == 10.0  # no card: one device
    synced = []
    monkeypatch.setattr(TP.torch.cuda, "synchronize", lambda *a: synced.append(a))
    monkeypatch.setattr(TP.torch.cuda, "is_initialized", lambda: False)
    got.steps_per_sec
    assert synced == []  # no card touched: no barrier
    monkeypatch.setattr(TP.torch.cuda, "is_initialized", lambda: True)
    got.steps_per_sec
    assert synced == [()]  # a card in use: the host waits for it before it reads the clock


def test_peak_trace_and_annotate(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TP.chip_peak_bf16_flops() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")
    assert TP.chip_peak_bf16_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "some other card")
    assert TP.chip_peak_bf16_flops() is None
    monkeypatch.undo()
    with TP.trace(str(tmp_path / "tr")) as prof:
        with TP.annotate("my_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "my_span" for e in prof.key_averages())
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "my_span" in names and "aten::mm" in names
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_visualize_gates_writes_the_jax_png_set(tmp_path):
    from mop_tpu_torch.visualization import visualize_gates

    b = 3
    g = torch.Generator().manual_seed(0)
    images = torch.rand(b, 3, 32, 32, generator=g)
    gates = torch.rand(b, 1, 8, 8, generator=g, requires_grad=True)  # detached inside
    views = torch.rand(b, 2, 8, 8, generator=g)
    kernels = torch.rand(b, 1, 8, 8, generator=g)
    out = str(tmp_path / "maps.png")
    visualize_gates(images, gates, views, kernels, save_path=out)
    want = {"maps.png"} | {f"maps.{kind}.{i}.png" for kind in ("gates", "sample")
                           for i in range(b)}
    assert set(os.listdir(tmp_path)) == want
    assert all(os.path.getsize(tmp_path / f) > 0 for f in want)
    visualize_gates(images.numpy(), gates.detach().numpy(), save_path=str(tmp_path / "n.png"))
    assert os.path.exists(tmp_path / "n.png")
