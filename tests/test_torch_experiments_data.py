"""The port's CIFAR data against ``mop_tpu.data``: the synthetic set, the
split, the batch iterators, the pickle parsing (with and without the
``.tar.gz``), and the harness's ``get_loaders``, whose train batches must
equal the JAX harness's for the same seed, byte for byte."""

import os
import pickle
import tarfile

import numpy as np
import pytest
import torch

import experiments.common as JC
import mop_tpu.data as JD
import mop_tpu.data.cifar as JCIFAR
import mop_tpu_torch.data as TD
import mop_tpu_torch.data.cifar as TCIFAR
import mop_tpu_torch.experiments.common as TC
from mop_tpu.data import native_loader as jnative
from mop_tpu_torch.data import native_loader as tnative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,difficulty", [("cifar10", None), ("cifar100", 0.0),
                                             ("cifar100", 0.6)])
def test_synthetic_cifar_is_byte_equal(name, difficulty):
    kw = dict(n_train=300, n_test=70, seed=3, difficulty=difficulty)
    _same(TD.synthetic_cifar(name, **kw), JD.synthetic_cifar(name, **kw))


def test_synthetic_difficulty_reads_the_environment(monkeypatch):
    monkeypatch.setenv("MOP_SYNTH_DIFFICULTY", "0.4")
    got = TD.synthetic_cifar("cifar100", 64, 16, seed=1)
    _same(got, JD.synthetic_cifar("cifar100", 64, 16, seed=1))
    _same(got, TD.synthetic_cifar("cifar100", 64, 16, seed=1, difficulty=0.4))


def test_split_and_iterators_are_byte_equal():
    x, y, _, _ = TD.synthetic_cifar("cifar10", 203, 8, seed=2)
    _same(TD.train_val_split(x, y, 0.1, 5), JD.train_val_split(x, y, 0.1, 5))
    ti, ji = TD.BatchIterator(x, y, 32, seed=7), JD.BatchIterator(x, y, 32, seed=7)
    for _ in range(14):  # past two epochs: the reshuffle at each epoch's end
        _same(next(ti), next(ji))
    _same([a for b in TD.eval_batches(x, y, 64) for a in b],
          [a for b in JD.eval_batches(x, y, 64) for a in b])
    last = list(TD.eval_batches(x, y, 64))[-1]
    assert last[0].shape[0] == 64 and last[2].sum() == 203 - 3 * 64


def _write_pickles(root, name, rng):
    """Fake CIFAR pickles in the standard layout (latin1-readable dicts)."""
    def dump(path, n, label_key):
        b = {"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
             label_key: rng.randint(0, 10, n).tolist()}
        with open(path, "wb") as f:
            pickle.dump(b, f)

    if name == "cifar10":
        d = os.path.join(root, "cifar-10-batches-py")
        os.makedirs(d)
        for i in range(1, 6):
            dump(os.path.join(d, f"data_batch_{i}"), 4, "labels")
        dump(os.path.join(d, "test_batch"), 3, "labels")
    else:
        d = os.path.join(root, "cifar-100-python")
        os.makedirs(d)
        dump(os.path.join(d, "train"), 6, "fine_labels")
        dump(os.path.join(d, "test"), 3, "fine_labels")
    return d


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
@pytest.mark.parametrize("packed", [False, True], ids=["pickles", "tar.gz"])
def test_pickle_round_trip(tmp_path, name, packed):
    root = tmp_path / "data"
    root.mkdir()
    d = _write_pickles(str(root), name, np.random.RandomState(0))
    if packed:  # only the archive: has_real_data extracts it
        tar = {"cifar10": "cifar-10-python.tar.gz", "cifar100": "cifar-100-python.tar.gz"}[name]
        with tarfile.open(root / tar, "w:gz") as t:
            t.add(d, arcname=os.path.basename(d))
        import shutil
        shutil.rmtree(d)
    assert TD.has_real_data(name, str(root))
    got = TD.load_cifar(name, str(root))
    _same(got, JD.load_cifar(name, str(root)))
    assert got[0].shape[1:] == (3, 32, 32) and got[1].dtype == np.int32


def test_no_data_without_synthetic_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TD.load_cifar("cifar10", str(tmp_path), allow_synthetic=False)
    assert not TD.has_real_data("cifar100", str(tmp_path))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_get_loaders_batches_equal_the_jax_harness(monkeypatch, native):
    """The first three train batches for two seeds, the val and test batches,
    the normalisation constants and the class count: native loader in both
    packages where it builds, ``BatchIterator`` in both without it."""
    if native:
        assert tnative.is_available() == jnative.is_available()
        if not tnative.is_available():
            pytest.skip("no C++ compiler: the harnesses take BatchIterator")
    else:
        monkeypatch.setattr(tnative, "is_available", lambda: False)
        monkeypatch.setattr(jnative, "is_available", lambda: False)
    kw = dict(tiny=True, val_frac=0.1, val_seed=0, synthetic=True)
    t = TC.get_loaders("cifar100", 32, **kw)
    j = JC.get_loaders("cifar100", 32, **kw)
    for seed in (0, 1):
        ti, ji = t[0](seed), j[0](seed)
        assert type(ti).__name__ == type(ji).__name__
        for _ in range(3):
            _same(next(ti), next(ji))
    for k in (1, 2):
        _same([a for b in t[k]() for a in b], [a for b in j[k]() for a in b])
    assert tuple(t[3]) == tuple(j[3]) and tuple(t[4]) == tuple(j[4]) and t[5] == j[5] == 100


def test_native_loader_builds_into_the_port(monkeypatch):
    if not tnative.is_available():
        pytest.skip("no C++ compiler")
    so = tnative._so_path()
    assert so.is_file() and "mop_tpu_torch/_build/native" in so.as_posix()
    x = np.arange(64, dtype=np.uint8).reshape(64, 1, 1, 1)
    it = tnative.NativeBatchIterator(x, np.arange(64, dtype=np.int32), batch=16, seed=3)
    seen = np.concatenate([next(it)[1] for _ in range(4)])
    it.close()
    assert sorted(seen.tolist()) == list(range(64))


def test_module_is_a_copy():
    """The port's module keeps the JAX module's functions (names and code
    bodies), so the byte equality above holds for every argument."""
    for fn in ("synthetic_cifar", "train_val_split", "eval_batches", "_parse_cifar10",
               "_parse_cifar100", "_maybe_extract_tar", "has_real_data", "load_cifar"):
        assert getattr(TCIFAR, fn).__code__.co_code == getattr(JCIFAR, fn).__code__.co_code, fn
