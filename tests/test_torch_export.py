"""Model export over ``torch.export`` in the port (the counterparts of
``tests/test_export.py``): an artifact deserialized from bytes reproduces the
eager forward bit for bit, at batch sizes it was not exported at (a symbolic
batch dimension); a fixed-batch artifact refuses other sizes; the GPT LM;
``export_fn`` with a path round trip and the ``platforms`` metadata (the
CPU and the shape-only ``meta`` device: these tests run without a card).
Each of the six registered kernel ops (``ops.fused.EXPORT_OPS``)
is refused in a program without ``allow_custom_calls``, by name, and kept
with it, its fake giving the launch's output layout. And the port's
artifact agrees with JAX's ``export_apply`` artifact over the same
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
from mop_tpu.serving import export_apply as jax_export_apply
from mop_tpu.serving import load_exported as jax_load_exported
from mop_tpu_torch.models import TransformerConfig, ViT_Baseline, create_gpt_quartet
from mop_tpu_torch.ops import fused as F
from mop_tpu_torch.serving import export_apply, export_fn, load_exported, save_exported
from mop_tpu_torch.utils.jax_weights import load_jax_params

from _torch_decode_common import ATOL, RTOL, _one_torch_thread  # noqa: F401

SMALL = dict(dim=32, depth=1, heads=2, n_classes=7)


@pytest.fixture(scope="module")
def vit():
    torch.manual_seed(0)
    model = ViT_Baseline(**SMALL, device="cpu").eval()
    return model, dict(model.state_dict())


def _x(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, 3, 32, 32))
                            .astype(np.float32))


def test_export_roundtrip_bit_exact(vit):
    model, params = vit
    x = _x(2)
    blob = export_apply(model, params, x)
    assert isinstance(blob, bytes) and len(blob) > 0
    with torch.no_grad():
        assert torch.equal(load_exported(blob)(params, x), model(x))


def test_export_polymorphic_batch(vit):
    model, params = vit
    fn = load_exported(export_apply(model, params, torch.zeros(2, 3, 32, 32)))
    with torch.no_grad():
        for b in (1, 3, 8):
            x = _x(b, seed=b)
            out = fn(params, x)
            assert out.shape == (b, 7) and torch.equal(out, model(x))


def test_export_fixed_batch_rejects_other_sizes(vit):
    model, params = vit
    fn = load_exported(export_apply(model, params, torch.zeros(2, 3, 32, 32), poly_batch=False))
    assert fn(params, torch.zeros(2, 3, 32, 32)).shape == (2, 7)
    with pytest.raises(ValueError):
        fn(params, torch.zeros(3, 3, 32, 32))


def test_export_gpt_lm():
    torch.manual_seed(1)
    cfg = TransformerConfig(n_layer=2, n_head=2, n_embd=32, dropout=0.0, block_size=16)
    model = create_gpt_quartet(50, cfg, device="cpu").eval()
    params = dict(model.state_dict())
    fn = load_exported(export_apply(model, params, torch.zeros(2, 8, dtype=torch.long)))
    t = torch.from_numpy(np.random.default_rng(3).integers(0, 50, (4, 8)))
    logits, loss = fn(params, t)  # (logits, loss); loss is None without targets
    with torch.no_grad():
        assert torch.equal(logits, model(t)[0]) and loss is None


def test_export_fn_general_and_save_load(tmp_path):
    def fwd(w, x):
        return torch.tanh(x @ w).sum(-1)

    w = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32))
    blob = export_fn(fwd, w, torch.zeros(2, 4), poly_batch_args=(1,))
    path = str(tmp_path / "fn.mopx")
    save_exported(path, blob)
    fn = load_exported(path)  # from a path
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32))
    assert torch.equal(fn(w, x), fwd(w, x))
    assert fn.exported.platforms == ("cpu",)


def test_export_dual_platform_artifact(vit):
    """One artifact, a program per device named; it runs the one of its
    inputs' device and refuses a device it has none for."""
    model, params = vit
    x = torch.zeros(2, 3, 32, 32)
    fn = load_exported(export_apply(model, params, x, platforms=("cpu", "meta")))
    assert sorted(fn.exported.platforms) == ["cpu", "meta"]
    assert sorted(fn.exported.programs) == ["cpu", "meta"]
    with torch.no_grad():
        assert torch.equal(fn(params, x), model(x))
    only_cpu = load_exported(export_apply(model, params, x))
    with pytest.raises(ValueError, match="meta"):
        only_cpu({k: v.to("meta") for k, v in params.items()}, x.to("meta"))


def _op_inputs(name):
    """(op, args) of one registered op at a small shape, on the CPU."""
    g = torch.Generator().manual_seed(0)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    bhnd = (2, 2, 5, 8)
    views = [rn(2, 2, 3, 5, 8) for _ in range(3)]
    lowrank = (rn(8, 4, scale=0.3), torch.linspace(-0.5, 0.5, 4), rn(8, 4, scale=0.3),
               torch.linspace(0.5, -0.5, 4), 0.5, torch.tensor(0.4))
    ops = torch.ops.mop_tpu_torch
    return {
        "flash_fwd": (ops.flash_fwd, [rn(*bhnd) for _ in range(3)] + [True]),
        "edgewise_lowrank_fwd": (ops.edgewise_lowrank_fwd, views + list(lowrank)),
        "edgewise_lowrank_wide_fwd": (ops.edgewise_lowrank_wide_fwd, views + list(lowrank)),
        "edgewise_dense_fwd": (ops.edgewise_dense_fwd, views + [
            rn(8, F.DENSE_HIDDEN, scale=0.3), torch.linspace(-0.5, 0.5, F.DENSE_HIDDEN),
            rn(F.DENSE_HIDDEN, 4, scale=0.5), torch.tensor([-1.0, 0.5, -0.5, 1.0]), 0.5,
            torch.tensor(0.4)]),
        "multihop_fwd": (ops.multihop_fwd, [rn(*bhnd) for _ in range(6)]
                         + [[0.9, 1.0, 0.5, 0.25, 0.75], 0.5, 3, torch.tensor(0.4)]),
        "quartet_fwd": (ops.quartet_fwd, [rn(*bhnd) for _ in range(5)]
                        + [torch.tensor(0.3), torch.tensor(1.2), 1e-5]),
    }[name]


@pytest.mark.parametrize("name", [n.split("::")[1] for n in F.EXPORT_OPS])
def test_registered_op_refused_then_kept(name):
    op, args = _op_inputs(name)
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]

    def fn(*ts):
        full = list(args)
        for i, t in zip(tensors, ts):
            full[i] = t
        return op(*full) * 2.0

    ins = [args[i] for i in tensors]
    with pytest.raises(ValueError, match=f"mop_tpu_torch::{name}"):
        export_fn(fn, *ins)
    loaded = load_exported(export_fn(fn, *ins, allow_custom_calls=True))
    want = fn(*ins)
    assert torch.equal(loaded(*ins), want)
    prog = loaded.exported.programs["cpu"]
    out = [n for n in prog.graph.nodes if n.op == "call_function"
           and getattr(n.target, "name", lambda: "")().startswith("mop_tpu_torch::")]
    assert len(out) == 1
    fake = out[0].meta["val"]  # the fake's (B, H, N, dk) view of a (B, N, H, dk) buffer
    b, h, n, dk = want.shape
    assert tuple(fake.shape) == (b, h, n, dk) and fake.stride() == (n * h * dk, dk, h * dk, 1)


def test_exported_vit_equals_jax_artifact():
    jm = J.ViT_Baseline(**SMALL)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))))
    pm = load_jax_params(ViT_Baseline(**SMALL, device="cpu"), params).eval()
    x = _x(3, seed=5)
    want = jax_load_exported(jax_export_apply(jm, params, jnp.zeros((2, 3, 32, 32))))(
        params, jnp.asarray(x.numpy()))
    pp = dict(pm.state_dict())
    got = load_exported(export_apply(pm, pp, torch.zeros(2, 3, 32, 32)))(pp, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
