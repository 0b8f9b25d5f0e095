"""Gate-map visualization of the port: ``visualize_gates``, the counterpart
of ``mop_tpu/visualization.py``, with its PNG set. It takes tensors on any
device or numpy arrays, and imports matplotlib only when called."""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def visualize_gates(images, gates, views=None, kernels=None,
                    save_path="outputs/attention_maps.png"):
    """Save per-sample image / views / kernels panels (``.sample.{b}.png``),
    per-sample gate heatmaps (``.gates.{b}.png``) and a mosaic of up to 8
    samples' gates (``save_path``).

    images: (B, 3, H, W); gates: (B, 1, h, w); views: (B, V, h, w);
    kernels: (B, K, h, w).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    imgs = _to_numpy(images)
    g = _to_numpy(gates)
    v = _to_numpy(views) if views is not None else None
    k = _to_numpy(kernels) if kernels is not None else None

    b_total = imgs.shape[0]
    cols = 1 + (1 if v is not None else 0) + (1 if k is not None else 0)

    for b in range(b_total):
        fig = plt.figure(figsize=(12, 3.0))
        ax = fig.add_subplot(1, cols, 1)
        ax.imshow(np.clip(imgs[b].transpose(1, 2, 0), 0, 1))
        ax.set_title("image")
        ax.axis("off")
        c = 2
        if v is not None:
            ax = fig.add_subplot(1, cols, c)
            ax.imshow(v[b].sum(0), interpolation="nearest")
            ax.set_title("views (sum)")
            ax.axis("off")
            c += 1
        if k is not None:
            ax = fig.add_subplot(1, cols, c)
            ax.imshow(k[b].sum(0), interpolation="nearest")
            ax.set_title("kernels (sum)")
            ax.axis("off")

        fig2 = plt.figure(figsize=(4, 3))
        ax2 = fig2.add_subplot(1, 1, 1)
        ax2.imshow(g[b, 0], interpolation="nearest")
        ax2.set_title("gates")
        ax2.axis("off")
        fig2.tight_layout()
        fig2.savefig(save_path.replace(".png", f".gates.{b}.png"), bbox_inches="tight")
        plt.close(fig2)

        fig.tight_layout()
        fig.savefig(save_path.replace(".png", f".sample.{b}.png"), bbox_inches="tight")
        plt.close(fig)

    num = min(b_total, 8)
    cols = 4
    rows = int(math.ceil(num / cols))
    fig = plt.figure(figsize=(cols * 3, rows * 3))
    for i in range(num):
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.imshow(g[i, 0], interpolation="nearest")
        ax.set_title(f"gate {i}")
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
