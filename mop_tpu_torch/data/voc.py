"""PASCAL-VOC single-box localization data for the port: a copy of
``mop_tpu/data/voc.py`` (numpy, PIL only for real JPEGs), so one seed gives
both packages the same bytes.

- Real data: the standard VOCdevkit layout (JPEGImages + Annotations XML)
  under ``root``; each image's largest object's box, the image
  square-resized, the box rescaled to [0, 1].
- Synthetic: deterministic images with one bright rectangle on a textured
  background; the box is the label, so the task is learnable.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional, Tuple

import numpy as np


def _largest_box(xml_path: str) -> Optional[Tuple[float, float, float, float, int, int]]:
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    best, best_area = None, -1.0
    for obj in root.findall("object"):
        bb = obj.find("bndbox")
        x0, y0 = float(bb.find("xmin").text), float(bb.find("ymin").text)
        x1, y1 = float(bb.find("xmax").text), float(bb.find("ymax").text)
        area = max(0.0, x1 - x0) * max(0.0, y1 - y0)
        if area > best_area:
            best_area, best = area, (x0, y0, x1, y1)
    if best is None:
        return None
    return (*best, w, h)


def has_real_voc(root: str, year: str = "2007") -> bool:
    d = os.path.join(root, f"VOCdevkit/VOC{year}")
    return os.path.isdir(os.path.join(d, "Annotations")) and os.path.isdir(
        os.path.join(d, "JPEGImages")
    )


def load_voc_boxes(root: str, year: str = "2007", split: str = "train",
                   img_size: int = 224, limit: Optional[int] = None):
    """Parse VOCdevkit: returns (images uint8 NCHW at img_size, boxes [0,1] xyxy).

    Requires PIL for JPEG decoding; raises if neither data nor PIL available.
    """
    from PIL import Image  # lazy; only needed for real data

    d = os.path.join(root, f"VOCdevkit/VOC{year}")
    split_file = os.path.join(d, "ImageSets/Main", f"{split}.txt")
    with open(split_file) as f:
        ids = [ln.strip() for ln in f if ln.strip()]
    if limit:
        ids = ids[:limit]
    xs, ys = [], []
    for iid in ids:
        ann = _largest_box(os.path.join(d, "Annotations", f"{iid}.xml"))
        if ann is None:
            continue
        x0, y0, x1, y1, w, h = ann
        img = Image.open(os.path.join(d, "JPEGImages", f"{iid}.jpg")).convert("RGB")
        img = img.resize((img_size, img_size))
        arr = np.asarray(img, np.uint8).transpose(2, 0, 1)
        xs.append(arr)
        # a square resize rescales each axis independently
        ys.append([x0 / w, y0 / h, x1 / w, y1 / h])
    return np.stack(xs), np.asarray(ys, np.float32)


def synthetic_voc(n: int = 1000, img_size: int = 224, seed: int = 0):
    """One bright rectangle per image over low-frequency noise; the label is
    the rectangle's normalized xyxy box."""
    rng = np.random.RandomState(seed)
    xs = np.zeros((n, 3, img_size, img_size), np.uint8)
    ys = np.zeros((n, 4), np.float32)
    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    for i in range(n):
        bg = 0.3 + 0.2 * np.sin(2 * np.pi * (rng.randint(1, 4) * xx
                                             + rng.randint(1, 4) * yy))
        img = np.stack([bg] * 3) + rng.normal(0, 0.05, (3, img_size, img_size))
        bw = rng.uniform(0.2, 0.6)
        bh = rng.uniform(0.2, 0.6)
        x0 = rng.uniform(0, 1 - bw)
        y0 = rng.uniform(0, 1 - bh)
        x1, y1 = x0 + bw, y0 + bh
        xi0, yi0 = int(x0 * img_size), int(y0 * img_size)
        xi1, yi1 = int(x1 * img_size), int(y1 * img_size)
        c = rng.randint(0, 3)
        img[c, yi0:yi1, xi0:xi1] = 0.95
        xs[i] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        ys[i] = [x0, y0, x1, y1]
    return xs, ys
