"""ImageNet-style ImageFolder data for the port: a copy of
``mop_tpu/data/imagenet.py`` (numpy, PIL only for real JPEGs), so one seed
gives both packages the same bytes: a minimal ImageFolder parser, a
deterministic class-structured synthetic set and the val -> val/test split.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def has_imagefolder(root: str, split: str = "train") -> bool:
    d = os.path.join(root, split)
    if not os.path.isdir(d):
        return False
    subdirs = [s for s in os.listdir(d) if os.path.isdir(os.path.join(d, s))]
    return len(subdirs) > 0


def load_imagefolder(root: str, split: str, img_size: int = 224,
                     limit_per_class: Optional[int] = None):
    """Parse <root>/<split>/<class>/*.jpg -> (uint8 NCHW, int32 labels)."""
    from PIL import Image

    d = os.path.join(root, split)
    classes = sorted(s for s in os.listdir(d) if os.path.isdir(os.path.join(d, s)))
    xs, ys = [], []
    for ci, cls in enumerate(classes):
        files = sorted(os.listdir(os.path.join(d, cls)))
        if limit_per_class:
            files = files[:limit_per_class]
        for fn in files:
            img = Image.open(os.path.join(d, cls, fn)).convert("RGB")
            img = img.resize((img_size, img_size))
            xs.append(np.asarray(img, np.uint8).transpose(2, 0, 1))
            ys.append(ci)
    return np.stack(xs), np.asarray(ys, np.int32), classes


def synthetic_imagenet(n_train: int = 2000, n_test: int = 500,
                       n_classes: int = 100, img_size: int = 224, seed: int = 0):
    """Class-structured synthetic 224px images (same scheme as synthetic_cifar,
    scaled up); learnable above chance for smoke/bench runs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size

    def template(c):
        fx, fy = 1 + (c % 7), 1 + (c // 7) % 7
        base = 0.5 + 0.35 * np.sin(2 * np.pi * (fx * xx + fy * yy) + c * 0.5)
        t = np.stack([np.roll(base, (c * (ch + 1)) % 31, axis=ch % 2)
                      for ch in range(3)])
        px, py = (c * 13) % (img_size - 32), (c * 29) % (img_size - 32)
        t[c % 3, py:py + 32, px:px + 32] = 1.0
        return t

    templates = np.stack([template(c) for c in range(n_classes)])

    def make(n, off):
        r = np.random.RandomState(seed + off)
        y = r.randint(0, n_classes, n).astype(np.int32)
        out = np.empty((n, 3, img_size, img_size), np.uint8)
        for i in range(n):  # loop keeps peak memory low at 224px
            img = templates[y[i]] + r.normal(0, 0.18, (3, img_size, img_size))
            out[i] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        return out, y

    train = make(n_train, 1)
    test = make(n_test, 2)
    return train[0], train[1], test[0], test[1]


def val_test_split(x, y, test_frac: float, seed: int = 0):
    """Deterministic val -> val/test split: a RandomState(seed) permutation,
    the first ``round(test_frac * n)`` (at least 1, at most n - 1) to test."""
    n = len(x)
    n_test = int(max(1, min(n - 1, round(float(test_frac) * n))))
    perm = np.random.RandomState(seed).permutation(n)
    te, va = perm[:n_test], perm[n_test:]
    return x[va], y[va], x[te], y[te]
