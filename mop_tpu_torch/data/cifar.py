"""CIFAR-10/100 data for the port: local pickle parsing and a synthetic set.

A copy of ``mop_tpu/data/cifar.py`` (numpy only), so that one seed gives the
port and the JAX package the same arrays and the same batches, byte for byte:

- If the standard CIFAR python pickles exist under ``root`` (default
  ``$CIFAR_ROOT`` or ``./data_cache``), they are parsed directly (a
  ``.tar.gz`` beside them is extracted first).
- ``download_cifar`` fetches them, only when asked (the CLIs' ``--download``).
- Otherwise ``synthetic=True`` (or the ``allow_synthetic`` fallback) generates
  a deterministic class-structured synthetic set.

Arrays are uint8 NCHW images and int32 labels; the augment runs on the
device (``mop_tpu_torch.ops.preprocess``).
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


def _default_root() -> str:
    return os.environ.get("CIFAR_ROOT", os.path.join(os.getcwd(), "data_cache"))


def _load_pickle(f) -> dict:
    return pickle.load(f, encoding="latin1")


def _parse_cifar10(root: str):
    d = os.path.join(root, "cifar-10-batches-py")
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
            b = _load_pickle(f)
        xs.append(b["data"])
        ys.extend(b["labels"])
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.uint8)
    train_y = np.asarray(ys, np.int32)
    with open(os.path.join(d, "test_batch"), "rb") as f:
        b = _load_pickle(f)
    test_x = np.asarray(b["data"]).reshape(-1, 3, 32, 32).astype(np.uint8)
    test_y = np.asarray(b["labels"], np.int32)
    return train_x, train_y, test_x, test_y


def _parse_cifar100(root: str):
    d = os.path.join(root, "cifar-100-python")
    with open(os.path.join(d, "train"), "rb") as f:
        b = _load_pickle(f)
    train_x = np.asarray(b["data"]).reshape(-1, 3, 32, 32).astype(np.uint8)
    train_y = np.asarray(b["fine_labels"], np.int32)
    with open(os.path.join(d, "test"), "rb") as f:
        b = _load_pickle(f)
    test_x = np.asarray(b["data"]).reshape(-1, 3, 32, 32).astype(np.uint8)
    test_y = np.asarray(b["fine_labels"], np.int32)
    return train_x, train_y, test_x, test_y


def _maybe_extract_tar(root: str, name: str) -> None:
    tar = {
        "cifar10": "cifar-10-python.tar.gz",
        "cifar100": "cifar-100-python.tar.gz",
    }[name]
    path = os.path.join(root, tar)
    marker = {
        "cifar10": os.path.join(root, "cifar-10-batches-py"),
        "cifar100": os.path.join(root, "cifar-100-python"),
    }[name]
    if os.path.exists(path) and not os.path.exists(marker):
        with tarfile.open(path, "r:gz") as t:
            try:
                t.extractall(root, filter="data")  # reject path escapes
            except TypeError:  # pragma: no cover - Python < 3.12
                t.extractall(root)


_CIFAR_URLS = {
    "cifar10": "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
    "cifar100": "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
}


def download_cifar(name: str, root: Optional[str] = None) -> bool:
    """Opt-in download of the standard CIFAR pickles (the torchvision URLs)
    into ``root``.

    Returns True if the data is present afterwards. Never called
    implicitly — zero-egress environments keep their behavior; pass
    ``download=True`` to ``load_cifar`` (CLI: ``--download``) on
    egress-enabled hosts to make the scripts drop-in."""
    root = root or _default_root()
    if has_real_data(name, root):
        return True
    os.makedirs(root, exist_ok=True)
    url = _CIFAR_URLS[name]
    dest = os.path.join(root, url.rsplit("/", 1)[1])
    try:
        import urllib.request

        print(f"downloading {url} -> {dest}")
        urllib.request.urlretrieve(url, dest)  # noqa: S310 - pinned https URL
    except Exception as e:  # pragma: no cover - needs egress
        print(f"download failed ({e}); falling back")
        return has_real_data(name, root)
    return has_real_data(name, root)


def has_real_data(name: str, root: Optional[str] = None) -> bool:
    root = root or _default_root()
    try:
        _maybe_extract_tar(root, name)
    except Exception:
        return False
    marker = {
        "cifar10": os.path.join(root, "cifar-10-batches-py", "data_batch_1"),
        "cifar100": os.path.join(root, "cifar-100-python", "train"),
    }[name]
    return os.path.exists(marker)


def synthetic_cifar(
    name: str = "cifar10",
    n_train: int = 10_000,
    n_test: int = 2_000,
    seed: int = 0,
    difficulty: Optional[float] = None,
):
    """Deterministic class-structured synthetic images.

    Each class gets a distinct low-frequency template plus per-sample noise and
    a class-coded patch, so models genuinely learn (accuracy rises above
    chance) — good enough for smoke tests, throughput benches, and CI.

    ``difficulty`` in [0, 1] (default 0, or $MOP_SYNTH_DIFFICULTY): raises
    per-sample noise, dims the class-coded patch, and blends in a distractor
    class template so accuracy comparisons do not saturate instantly.
    """
    if difficulty is None:
        difficulty = float(os.environ.get("MOP_SYNTH_DIFFICULTY", "0") or 0)
    difficulty = float(np.clip(difficulty, 0.0, 1.0))
    n_classes = 10 if name == "cifar10" else 100
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0

    templates = np.zeros((n_classes, 3, 32, 32), np.float32)
    for c in range(n_classes):
        fx, fy = 1 + (c % 5), 1 + (c // 5) % 5
        phase = c * 0.7
        base = 0.5 + 0.35 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
        for ch in range(3):
            templates[c, ch] = np.roll(base, shift=ch * (c % 7), axis=ch % 2)
        # class-coded bright patch (dimmed with difficulty)
        px, py = (c * 3) % 24, (c * 7) % 24
        templates[c, c % 3, py : py + 6, px : px + 6] = 1.0 - 0.45 * difficulty

    noise = 0.18 + 0.25 * difficulty
    blend = 0.35 * difficulty

    def make(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        y = r.randint(0, n_classes, n).astype(np.int32)
        x = templates[y].copy()
        if blend > 0:
            distract = templates[r.randint(0, n_classes, n)]
            x = (1 - blend) * x + blend * distract
        x = x + r.normal(0, noise, (n, 3, 32, 32)).astype(np.float32)
        x = np.clip(x, 0, 1)
        return (x * 255).astype(np.uint8), y

    train_x, train_y = make(n_train, 1)
    test_x, test_y = make(n_test, 2)
    return train_x, train_y, test_x, test_y


def load_cifar(
    name: str = "cifar10",
    root: Optional[str] = None,
    synthetic: bool = False,
    allow_synthetic: bool = True,
    synthetic_train: int = 10_000,
    synthetic_test: int = 2_000,
    seed: int = 0,
    download: bool = False,
):
    """Return (train_x u8 NCHW, train_y, test_x, test_y).

    Real data if present under root; else downloaded when ``download=True``
    (egress-enabled hosts only); else synthetic (when allowed).
    """
    root = root or _default_root()
    if download and not synthetic:
        download_cifar(name, root)
    if not synthetic and has_real_data(name, root):
        return _parse_cifar10(root) if name == "cifar10" else _parse_cifar100(root)
    if synthetic or allow_synthetic:
        return synthetic_cifar(name, synthetic_train, synthetic_test, seed)
    raise FileNotFoundError(
        f"No {name} data under {root} and synthetic fallback disabled. "
        f"Place the standard python pickles there (zero-egress environment)."
    )


def train_val_split(train_x, train_y, val_frac: float = 0.1, val_seed: int = 123):
    """Deterministic split via permutation (``val_seed`` picks it)."""
    n = len(train_x)
    n_val = int(n * val_frac)
    perm = np.random.RandomState(val_seed).permutation(n)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    return (
        train_x[tr_idx],
        train_y[tr_idx],
        train_x[val_idx],
        train_y[val_idx],
    )


class BatchIterator:
    """Infinite shuffled batch iterator over host arrays.

    Yields uint8 NCHW image batches + int32 labels; the train step moves
    them to the device and augments them there.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
                 drop_last: bool = True):
        self.x, self.y = x, y
        self.batch = batch
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self._order = None
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        n = len(self.x)
        if self._order is None or self._pos + self.batch > n:
            self._order = self.rng.permutation(n)
            self._pos = 0
        idx = self._order[self._pos : self._pos + self.batch]
        self._pos += self.batch
        return self.x[idx], self.y[idx]


def eval_batches(x: np.ndarray, y: np.ndarray, batch: int):
    """Fixed-order eval batches; the final partial batch is zero-padded with
    a validity mask, so every eval batch has one shape."""
    n = len(x)
    for i in range(0, n, batch):
        xb, yb = x[i : i + batch], y[i : i + batch]
        m = np.ones(len(xb), np.float32)
        if len(xb) < batch:
            pad = batch - len(xb)
            xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
            yb = np.concatenate([yb, np.zeros(pad, yb.dtype)])
            m = np.concatenate([m, np.zeros(pad, np.float32)])
        yield xb, yb, m
