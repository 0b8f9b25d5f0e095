"""The VOC localizer of the port (``ViTLocalizer`` modes A, B and E,
``bbox_iou``, ``smooth_l1``) and its data (``synthetic_voc``,
``load_voc_boxes``) against the JAX package: the reference goldens
``vit_localizer_B`` and ``vit_localizer_E`` loaded with ``load_state_dict``,
each mode with transplanted JAX weights, the box metrics on swapped corners
and disjoint boxes, the synthetic set byte for byte and a two-image
VOCdevkit written here with PIL."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.data.voc as jvoc
import mop_tpu.models.vit_localizer as jloc
import mop_tpu_torch.data.voc as tvoc
import mop_tpu_torch.models.vit_localizer as tloc
from mop_tpu.utils.torch_port import load_golden, port_torch_state_dict
from mop_tpu_torch.utils.jax_weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 2e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# The goldens' configs (tests/test_golden_numerics.py's).
E_KW = dict(n_views=2, share_qkv=False, gate_mode="lowrank", gate_rank=2, gate_init="and")
GOLDEN_CASES = {"B": None, "E": E_KW}
SMALL = dict(dim=32, depth=2, heads=4, mlp_ratio=2.0, drop_path=0.0, patch=16, img_size=32,
             mop_views=2, mop_kernels=1)


@pytest.mark.parametrize("mode", sorted(GOLDEN_CASES))
def test_reference_golden_loads_with_load_state_dict(mode):
    ins, ws, outs = load_golden(os.path.join(GOLDEN, f"vit_localizer_{mode}.npz"))
    model = tloc.ViTLocalizer(**SMALL, attn_mode=mode, attn_kwargs=GOLDEN_CASES[mode],
                              device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in ws.items()},
                          strict=True)
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(ins["x"]))
    np.testing.assert_allclose(y.numpy(), outs["y"], rtol=RTOL, atol=ATOL)


MODES = {"A": None, "B": None, "E": E_KW,
         "E_dense": dict(n_views=3, gate_mode="dense", gate_init="neutral")}


def _pair(mode):
    kw = dict(SMALL, attn_mode=mode[0], attn_kwargs=MODES[mode])
    jm = jloc.ViTLocalizer(**kw)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 3, 32, 32))))
    return jm, params, load_jax_params(tloc.ViTLocalizer(**kw, device="cpu"), params)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_localizer_matches_jax(mode):
    """Each mode's boxes and its SmoothL1 loss's grads, and the weights'
    round trip back through the JAX package's ``port_torch_state_dict``."""
    jm, params, pm = _pair(mode)
    rs = np.random.RandomState(2)
    x = rs.randn(3, 3, 32, 32).astype(np.float32)
    box = rs.uniform(0, 1, (3, 4)).astype(np.float32)

    def jloss(p):
        pred = jm.apply(p, jnp.asarray(x))
        return jnp.mean(jloc.smooth_l1(pred, jnp.asarray(box))), pred

    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    pm.eval()
    pred = pm(torch.from_numpy(x))
    loss = tloc.smooth_l1(pred, torch.from_numpy(box)).mean()
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    want = load_jax_params(tloc.ViTLocalizer(**SMALL, attn_mode=mode[0],
                                             attn_kwargs=MODES[mode], device="cpu"),
                           jax.device_get(jg)).state_dict()
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    back = port_torch_state_dict({k: v.numpy() for k, v in pm.state_dict().items()},
                                 jax.eval_shape(lambda: params))
    for (path, leaf), (_, got) in zip(jax.tree_util.tree_leaves_with_path(params),
                                      jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(got), leaf, err_msg=str(path))


def test_localizer_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        tloc.ViTLocalizer(**SMALL, attn_mode="C", device="cpu")


# Boxes: a plain pair, swapped corners (x1 < x0), corners outside [0, 1],
# disjoint boxes, touching edges, a degenerate (zero-area) pair, identical.
BOXES = np.array([
    [[0.1, 0.1, 0.5, 0.5], [0.3, 0.3, 0.7, 0.7]],
    [[0.5, 0.6, 0.1, 0.2], [0.2, 0.1, 0.6, 0.5]],
    [[-0.2, 0.1, 1.3, 0.9], [0.0, 0.0, 1.0, 1.0]],
    [[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9]],
    [[0.0, 0.0, 0.5, 0.5], [0.5, 0.0, 1.0, 0.5]],
    [[0.3, 0.3, 0.3, 0.3], [0.3, 0.3, 0.3, 0.3]],
    [[0.2, 0.4, 0.6, 0.9], [0.2, 0.4, 0.6, 0.9]],
], np.float32)


def test_bbox_iou_matches_jax():
    got = tloc.bbox_iou(torch.from_numpy(BOXES[:, 0]), torch.from_numpy(BOXES[:, 1])).numpy()
    want = np.asarray(jloc.bbox_iou(jnp.asarray(BOXES[:, 0]), jnp.asarray(BOXES[:, 1])))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[3] == 0.0 and got[4] == 0.0 and got[5] == 0.0 and abs(got[6] - 1.0) < 1e-6
    # Random boxes, corners in either order, broadcast over a batch axis.
    rs = np.random.RandomState(0)
    a, b = rs.uniform(-0.1, 1.1, (2, 5, 6, 4)).astype(np.float32)
    np.testing.assert_allclose(tloc.bbox_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jloc.bbox_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("beta", [1.0, 0.25])
def test_smooth_l1_matches_jax(beta):
    rs = np.random.RandomState(1)
    p, t = rs.uniform(-2, 2, (2, 64, 4)).astype(np.float32)
    got = tloc.smooth_l1(torch.from_numpy(p), torch.from_numpy(t), beta).numpy()
    want = np.asarray(jloc.smooth_l1(jnp.asarray(p), jnp.asarray(t), beta))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_synthetic_voc_equals_jax_bytes():
    for n, size, seed in ((6, 32, 0), (3, 224, 1)):
        x, y = tvoc.synthetic_voc(n, size, seed=seed)
        jx, jy = jvoc.synthetic_voc(n, size, seed=seed)
        assert x.dtype == jx.dtype == np.uint8 and x.tobytes() == jx.tobytes()
        assert y.tobytes() == jy.tobytes()


def _write_vocdevkit(root):
    """Two JPEGs with annotations (the first with two objects, the larger
    second), a third id whose annotation has no object, and the split file."""
    from PIL import Image

    d = os.path.join(root, "VOCdevkit", "VOC2007")
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(d, sub))
    rs = np.random.RandomState(0)
    objects = {"000001": (60, 40, [(5, 5, 20, 15), (10, 8, 50, 35)]),
               "000002": (30, 50, [(3, 12, 25, 44)]), "000003": (20, 20, [])}
    for iid, (w, h, boxes) in objects.items():
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, "JPEGImages", f"{iid}.jpg"))
        objs = "".join(
            f"<object><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax>"
            f"<ymax>{y1}</ymax></bndbox></object>" for x0, y0, x1, y1 in boxes)
        with open(os.path.join(d, "Annotations", f"{iid}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>"
                    f"{objs}</annotation>")
    with open(os.path.join(d, "ImageSets/Main/train.txt"), "w") as f:
        f.write("000001\n000002\n000003\n")


def test_load_voc_boxes_on_a_written_vocdevkit(tmp_path):
    root = str(tmp_path)
    assert not tvoc.has_real_voc(root)
    _write_vocdevkit(root)
    assert tvoc.has_real_voc(root, "2007") and not tvoc.has_real_voc(root, "2012")
    x, y = tvoc.load_voc_boxes(root, "2007", "train", img_size=32)
    jx, jy = jvoc.load_voc_boxes(root, "2007", "train", img_size=32)
    assert x.shape == (2, 3, 32, 32) and x.dtype == np.uint8
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    np.testing.assert_allclose(y, [[10 / 60, 8 / 40, 50 / 60, 35 / 40],
                                   [3 / 30, 12 / 50, 25 / 30, 44 / 50]], rtol=1e-6)
    x1, _ = tvoc.load_voc_boxes(root, "2007", "train", img_size=16, limit=1)
    assert x1.shape == (1, 3, 16, 16)
