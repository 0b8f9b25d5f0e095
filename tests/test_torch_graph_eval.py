"""The classifier eval step's ``cuda_graph=True`` form, and ``ModelRun``'s
evals through it, on the CPU, where no CUDA graph can be captured.

- The refusals: a CPU device, a mesh, ``ModelRun`` asked for a graph on the
  CPU.
- With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly
  over the same static buffers, the form a replay computes): a graphed
  ``ModelRun``'s eval step counts and ``predict_correct`` /
  ``per_sample_correct`` hits against JAX's ``make_classifier_eval_step``
  and JAX's forward on the same weights (``load_jax_params``), for A, E
  (lowrank) and D, over two batches, the second padded with a part-valid
  mask; a second batch shape gets a graph of its own; the model goes to
  eval mode on every call; the graphed step against the eager one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu.ops.preprocess as jpp
import mop_tpu_torch as P
from mop_tpu.parallel import make_classifier_eval_step as jax_eval_step
from mop_tpu.parallel import make_mesh as jax_mesh
from mop_tpu_torch.experiments import common as TC
from mop_tpu_torch.parallel import train_step as TS
from mop_tpu_torch.parallel.mesh import make_mesh
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lifted(monkeypatch):
    """The graphed eval step on the CPU: ``require_graph`` accepts any device."""
    for mod in (TS, TC):
        monkeypatch.setattr(mod, "require_graph", lambda *a, **k: None)


MEAN, STD = jpp.CIFAR100_MEAN, jpp.CIFAR100_STD
SMALL = dict(dim=32, depth=2, heads=4, n_classes=10, drop_path=0.0)
GATES = dict(base=0.9, and_=1.0, or_=0.5, not_=0.25, chain=0.75)
MODELS = {
    "A": (J.ViT_Baseline, P.ViT_Baseline, {}),
    "E": (J.ViTEdgewise, P.ViTEdgewise, dict(n_views=3, gate_mode="lowrank")),
    "D": (J.ViTMultiHop, P.ViTMultiHop, dict(gates=GATES, hops=3)),
}
B = 16


def _pair(name):
    jcls, pcls, kw = MODELS[name]
    jm = jcls(**SMALL, **kw)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 3, 32, 32))))
    return jm, params, load_jax_params(pcls(**SMALL, **kw, device="cpu"), params)


def _batches(seed=0, b=B):
    """Two eval batches, the second padded: its last five rows masked out."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2):
        mask = np.ones(b, np.float32)
        if i == 1:
            mask[b - 5:] = 0.0
        out.append((rng.integers(0, 256, (b, 3, 32, 32), dtype=np.uint8),
                    rng.integers(0, 10, (b,)).astype(np.int32), mask))
    return out


def test_cuda_graph_refuses_the_cpu_and_a_mesh():
    model = P.ViT_Baseline(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="make_classifier_eval_step: cuda_graph=True needs a "
                                         "CUDA device, not cpu"):
        P.make_classifier_eval_step(model, MEAN, STD, device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match="does not take a mesh"):
        P.make_classifier_eval_step(model, MEAN, STD, mesh=make_mesh(device="cpu"),
                                    cuda_graph=True)
    run = TC.ModelRun("A", model, 3e-3, MEAN, STD, 10, 0.1, 0.05, seed=0, device="cpu")
    assert not run.graphed and run.eval_step.graphs is None
    with pytest.raises(ValueError, match="CUDA device"):
        TC.ModelRun("A", model, 3e-3, MEAN, STD, 10, 0.1, 0.05, seed=0, device="cpu",
                    cuda_graph=True)


@pytest.mark.parametrize("name", list(MODELS))
def test_graphed_model_run_evals_equal_jax(name, lifted):
    """Counts per batch equal JAX's eval step's; ``predict_correct``'s hits
    equal JAX's forward's argmax against the labels, ``per_sample_correct``
    those of the valid rows; one graph serves every call of the shape."""
    jm, params, pm = _pair(name)
    batches = _batches()
    jstep = jax_eval_step(jm, jax_mesh(n_devices=1), MEAN, STD)
    want = [tuple(float(v) for v in jstep(params, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(m))) for x, y, m in batches]
    logits = jax.jit(lambda p, x: jm.apply(p, jpp.cifar_eval_transform(x, MEAN, STD),
                                           train=False))
    want_hits = [np.asarray(jnp.argmax(logits(params, jnp.asarray(x)), -1)) == y
                 for x, y, _ in batches]
    assert 0 < sum(w.sum() for w in want_hits) < 2 * B  # hits and misses both

    run = TC.ModelRun(name, pm, 3e-3, MEAN, STD, 10, 0.1, 0.05, seed=0, device="cpu",
                      cuda_graph=True)
    assert run.graphed and run.eval_step.graphs is not None
    for (x, y, m), w in zip(batches, want):
        pm.train()
        got = tuple(float(v) for v in run.eval_step(*run._rows(x, y, m)))
        assert not pm.training and got == w
    assert run.evaluate(batches) == sum(c for c, _ in want) / sum(t for _, t in want)
    for (x, y, _), w in zip(batches, want_hits):
        np.testing.assert_array_equal(run.predict_correct(x, y), w)
    np.testing.assert_array_equal(run.per_sample_correct(batches),
                                  np.concatenate([w[m > 0] for w, (_, _, m) in
                                                  zip(want_hits, batches)]))
    (graph,) = run.eval_step.graphs.graphs.values()
    assert graph.calls == 2 + 2 + 2 + 2  # counts, evaluate, predict_correct, per_sample_correct


def test_a_second_batch_shape_gets_its_own_graph(lifted):
    """Batches of 16 and 8 in turns: two graphs, each called for its shape,
    the counts and hits of the eager step."""
    _, _, pm = _pair("A")
    eager = P.make_classifier_eval_step(pm, MEAN, STD, device="cpu")
    graphed = P.make_classifier_eval_step(pm, MEAN, STD, device="cpu", cuda_graph=True)
    batches = _batches(1) + _batches(2, b=8) + _batches(3)
    for x, y, m in batches:
        args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
        assert [float(v) for v in graphed(*args)] == [float(v) for v in eager(*args)]
        torch.testing.assert_close(graphed.hits(*args[:2]), eager.hits(*args[:2]), rtol=0,
                                   atol=0)
    shapes = {key[0][0][0]: g for key, g in graphed.graphs.graphs.items()}
    assert sorted(shapes) == [8, 16]
    assert shapes[16].calls == 8 and shapes[8].calls == 4
