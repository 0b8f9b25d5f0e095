"""Input preprocessing on the device — the CIFAR train and eval transforms
and the ImageNet augment suite (RandAugment, RandomErasing, Mixup, CutMix).

The port of ``mop_tpu/ops/preprocess.py``: batches are NCHW, uint8 in and
float32 out. Every random op takes an explicit ``torch.Generator`` (on the
batch's device) where the JAX op takes a key; the two draw different numbers
from the same seed.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor
# (index, count): this call's rows are block ``index`` of ``count`` equal
# blocks of the global batch. Each per-sample draw is then taken for the
# global batch and this block kept, so a data-parallel step draws what the
# single-device step draws for the same rows.
Shard = Optional[Tuple[int, int]]

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x: Tensor, mean, std) -> Tensor:
    """(B,C,H,W) in [0,1] -> normalized; ``mean`` and ``std`` are sequences
    of floats or tensors (a tensor of x's dtype on its device is taken as it is)."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return (x - mean) / std


def to_float(x: Tensor) -> Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return x.to(torch.float32) / 255.0


def global_rows(b: int, shard: Shard) -> Tuple[int, slice]:
    """The rows a per-sample draw takes for a batch of ``b`` rows that is
    block ``shard`` of a global batch, and the slice of them that is its own."""
    if shard is None:
        return b, slice(0, b)
    index, count = shard
    return b * count, slice(index * b, (index + 1) * b)


def random_crop(generator: torch.Generator, x: Tensor, padding: int = 4,
                shard: Shard = None) -> Tensor:
    """Pad-and-crop (torchvision ``RandomCrop(size, padding)``): per-sample
    offsets in [0, 2 * padding], zero padding, two index gathers on the
    device."""
    b, c, h, w = x.shape
    n, own = global_rows(b, shard)
    xp = torch.nn.functional.pad(x, (padding, padding, padding, padding))
    off_h = torch.randint(0, 2 * padding + 1, (n,), device=x.device, generator=generator)[own]
    off_w = torch.randint(0, 2 * padding + 1, (n,), device=x.device, generator=generator)[own]
    rows = off_h[:, None] + torch.arange(h, device=x.device)  # (B, H)
    cols = off_w[:, None] + torch.arange(w, device=x.device)  # (B, W)
    out = xp.gather(2, rows[:, None, :, None].expand(b, c, h, w + 2 * padding))
    return out.gather(3, cols[:, None, None, :].expand(b, c, h, w))


def random_hflip(generator: torch.Generator, x: Tensor, p: float = 0.5,
                 shard: Shard = None) -> Tensor:
    """Per-sample horizontal flip with probability ``p``."""
    n, own = global_rows(x.shape[0], shard)
    flip = torch.rand(n, device=x.device, generator=generator)[own] < p
    return torch.where(flip[:, None, None, None], x.flip(-1), x)


def cifar_train_augment(generator: torch.Generator, x_uint8: Tensor, mean, std,
                        shard: Shard = None) -> Tensor:
    """The reference CIFAR train transform: RandomCrop(32, pad 4) + flip +
    normalize, on the device. ``shard``: the batch is that block of a global
    batch (the draws are the global batch's)."""
    x = random_crop(generator, to_float(x_uint8), padding=4, shard=shard)
    return normalize(random_hflip(generator, x, shard=shard), mean, std)


def cifar_eval_transform(x_uint8: Tensor, mean, std) -> Tensor:
    return normalize(to_float(x_uint8), mean, std)


def label_smoothing_onehot(y: Tensor, n_classes: int, smoothing: float = 0.0) -> Tensor:
    """One-hot targets with label smoothing, float32."""
    off = smoothing / n_classes
    on = 1.0 - smoothing + off
    return torch.nn.functional.one_hot(y, n_classes).to(torch.float32) * (on - off) + off


# ------------------------- the ImageNet augment suite -------------------------
#
# Each random op is split in two: ``<op>_draws(generator, ...)`` takes every
# random number the op needs from the generator, and a deterministic
# transform maps the batch and those draws to the result. The JAX package's
# ops draw the same quantities from their keys, so its draws fed to the
# transform give its result.


def erasing_draws(generator: torch.Generator, b: int, device, p: float = 0.25,
                  scale: Tuple[float, float] = (0.02, 0.33),
                  ratio: Tuple[float, float] = (0.3, 3.3), shard: Shard = None
                  ) -> Tuple[Tensor, ...]:
    """RandomErasing's draws for ``b`` samples: the box's area as a share of
    the image in [scale), its log aspect ratio in [log ratio), two uniforms
    that place its top and left edges, and whether to erase (probability
    ``p``); each (b,) float32 (bool for the last)."""
    n, own = global_rows(b, shard)

    def uniform(lo, hi):
        return torch.rand(n, device=device, generator=generator)[own] * (hi - lo) + lo

    share = uniform(*scale)
    log_ratio = uniform(math.log(ratio[0]), math.log(ratio[1]))
    u_top, u_left = uniform(0.0, 1.0), uniform(0.0, 1.0)
    apply = torch.rand(n, device=device, generator=generator)[own] < p
    return share, log_ratio, u_top, u_left, apply


def erase(x: Tensor, share: Tensor, log_ratio: Tensor, u_top: Tensor, u_left: Tensor,
          apply: Tensor) -> Tensor:
    """Zero one rectangle of each sample where ``apply``: area ``share * H *
    W``, aspect ``exp(log_ratio)``, sides truncated and clamped to [1, H] and
    [1, W], its top-left corner at ``u * (H - side + 1)`` truncated."""
    b, _, h, w = x.shape
    target = share * (h * w)
    aspect = torch.exp(log_ratio)
    eh = torch.sqrt(target * aspect).to(torch.int32).clamp(1, h)
    ew = torch.sqrt(target / aspect).to(torch.int32).clamp(1, w)
    top = (u_top * (h - eh + 1)).to(torch.int32)
    left = (u_left * (w - ew + 1)).to(torch.int32)
    rows = torch.arange(h, device=x.device)[None, :]
    cols = torch.arange(w, device=x.device)[None, :]
    row_in = (rows >= top[:, None]) & (rows < (top + eh)[:, None])  # (B, H)
    col_in = (cols >= left[:, None]) & (cols < (left + ew)[:, None])  # (B, W)
    box = row_in[:, None, :, None] & col_in[:, None, None, :]  # (B, 1, H, W)
    return torch.where(apply[:, None, None, None] & box, torch.zeros_like(x), x)


def random_erasing(generator: torch.Generator, x: Tensor, p: float = 0.25,
                   scale: Tuple[float, float] = (0.02, 0.33),
                   ratio: Tuple[float, float] = (0.3, 3.3), shard: Shard = None) -> Tensor:
    """RandomErasing: zero a random rectangle of each sample with
    probability ``p`` (static shapes, one mask)."""
    return erase(x, *erasing_draws(generator, x.shape[0], x.device, p, scale, ratio, shard))


def _gamma_draw(generator: torch.Generator, alpha: float, device, tries: int = 32) -> Tensor:
    """One Gamma(alpha, 1) draw, a 0-d float32 tensor on ``device``, by
    Marsaglia and Tsang's method (alpha < 1 through alpha + 1 and a uniform
    to the power 1 / alpha). ``tries`` candidates are drawn at once and the
    first accepted kept (each is accepted with probability above 0.95), so
    nothing waits on the host."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    z = torch.randn(tries, device=device, generator=generator)
    u = torch.rand(tries, device=device, generator=generator)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp(min=1e-30)))
    g = d * v[ok.to(torch.int32).argmax()]
    if alpha < 1.0:
        g = g * torch.rand((), device=device, generator=generator) ** (1.0 / alpha)
    return g


def beta_draw(generator: torch.Generator, alpha: float, device) -> Tensor:
    """One Beta(alpha, alpha) draw, a 0-d float32 tensor on ``device``: the
    share of the first of two Gamma(alpha) draws in their sum."""
    g1 = _gamma_draw(generator, alpha, device)
    g2 = _gamma_draw(generator, alpha, device)
    return g1 / (g1 + g2)


def _flip(t: Tensor) -> Tensor:
    return t.flip(0)


# ``reverse(t)``: the rows of the reversed global batch that pair with this
# batch's rows, in its order. One device: ``t.flip(0)``; a data-parallel
# step passes its exchange with the mirror rank.
Reverse = Callable[[Tensor], Tensor]


def mix(x: Tensor, y_onehot: Tensor, lam: Tensor, reverse: Reverse = _flip
        ) -> Tuple[Tensor, Tensor]:
    """Mixup's transform: ``lam`` of the batch and ``1 - lam`` of its
    reversed copy, images and soft targets alike."""
    return lam * x + (1.0 - lam) * reverse(x), lam * y_onehot + (1.0 - lam) * reverse(y_onehot)


def mixup(generator: torch.Generator, x: Tensor, y_onehot: Tensor, alpha: float = 0.2,
          reverse: Reverse = _flip) -> Tuple[Tensor, Tensor]:
    """Mixup: lam ~ Beta(alpha, alpha); mixes the batch with its reversed copy."""
    return mix(x, y_onehot, beta_draw(generator, alpha, x.device), reverse)


def cutmix_draws(generator: torch.Generator, h: int, w: int, alpha: float, device
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """CutMix's draws: lam ~ Beta(alpha, alpha) and the box centre's row in
    [0, h) and column in [0, w)."""
    lam = beta_draw(generator, alpha, device)
    cy = torch.randint(0, h, (), device=device, generator=generator)
    cx = torch.randint(0, w, (), device=device, generator=generator)
    return lam, cy, cx


def paste_box(x: Tensor, y_onehot: Tensor, lam: Tensor, cy: Tensor, cx: Tensor,
              reverse: Reverse = _flip) -> Tuple[Tensor, Tensor]:
    """CutMix's transform: the box of sides ``trunc(H sqrt(1 - lam))`` and
    ``trunc(W sqrt(1 - lam))`` centred at (cy, cx), clipped to the image
    (half-sides by floor division), taken from the reversed batch; the
    targets mix by the share of the image left outside the box."""
    _, _, h, w = x.shape
    cut_rat = torch.sqrt(1.0 - lam)
    cut_h = (h * cut_rat).to(torch.int32)
    cut_w = (w * cut_rat).to(torch.int32)
    y1, y2 = (cy - cut_h // 2).clamp(0, h), (cy + cut_h // 2).clamp(0, h)
    x1, x2 = (cx - cut_w // 2).clamp(0, w), (cx + cut_w // 2).clamp(0, w)
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    box = ((rows >= y1) & (rows < y2))[:, None] & ((cols >= x1) & (cols < x2))[None, :]
    mixed = torch.where(box[None, None], reverse(x), x)
    lam_adj = 1.0 - ((y2 - y1) * (x2 - x1)).to(torch.float32) / (h * w)
    return mixed, lam_adj * y_onehot + (1.0 - lam_adj) * reverse(y_onehot)


def cutmix(generator: torch.Generator, x: Tensor, y_onehot: Tensor, alpha: float = 1.0,
           reverse: Reverse = _flip) -> Tuple[Tensor, Tensor]:
    """CutMix: paste a random box from the reversed batch; the target weight
    is the share of the image outside the box."""
    return paste_box(x, y_onehot, *cutmix_draws(generator, x.shape[2], x.shape[3], alpha,
                                                x.device), reverse)


# RandAugment's ops: (B, C, H, W) images in [0, 1] and a (B, 1, 1, 1) signed
# magnitude per sample.

def _adjust_brightness(x, mag):
    return (x * (1.0 + mag)).clamp(0.0, 1.0)


def _adjust_contrast(x, mag):
    mean = x.mean(dim=(-3, -2, -1), keepdim=True)
    return ((x - mean) * (1.0 + mag) + mean).clamp(0.0, 1.0)


def _adjust_saturation(x, mag):
    gray = x.mean(dim=-3, keepdim=True)
    return (gray + (x - gray) * (1.0 + mag)).clamp(0.0, 1.0)


def _posterize(x, mag):
    levels = 2.0 ** (8.0 - mag.abs() * 6.0).clamp(2.0, 8.0)
    return torch.floor(x * levels) / levels


def _solarize(x, mag):
    thresh = (1.0 - mag.abs()).clamp(0.1, 1.0)
    return torch.where(x >= thresh, 1.0 - x, x)


def _invert(x, mag):
    return 1.0 - x


def _roll(x, shift, dim):
    """Each sample rolled by its own ``shift`` (B,) along ``dim`` (-1 or -2),
    as ``torch.roll``: out[i] = x[(i - shift) mod n]."""
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device)[None, :] - shift[:, None]) % n  # (B, n)
    shape = [x.shape[0], 1, 1, 1]
    shape[dim] = n
    return x.gather(dim, idx.reshape(shape).expand_as(x))


def _translate_x(x, mag):
    return _roll(x, (mag.flatten() * x.shape[-1] * 0.3).to(torch.int32), -1)


def _translate_y(x, mag):
    return _roll(x, (mag.flatten() * x.shape[-2] * 0.3).to(torch.int32), -2)


RANDAUG_OPS = (_adjust_brightness, _adjust_contrast, _adjust_saturation, _posterize,
               _solarize, _invert, _translate_x, _translate_y)


def rand_augment_draws(generator: torch.Generator, b: int, n: int, device,
                       shard: Shard = None) -> Tuple[Tensor, Tensor]:
    """RandAugment's draws: each sample's op index in [0, 8) and sign (+1 or
    -1, even odds) for each of its ``n`` rounds, both (B, n)."""
    rows, own = global_rows(b, shard)
    ops = torch.randint(0, len(RANDAUG_OPS), (rows, n), device=device, generator=generator)[own]
    signs = torch.where(torch.rand(rows, n, device=device, generator=generator)[own] < 0.5,
                        1.0, -1.0)
    return ops, signs


def apply_rand_augment(x: Tensor, ops: Tensor, signs: Tensor, m: int = 9) -> Tensor:
    """Round i applies op ``ops[:, i]`` at magnitude ``signs[:, i] * m / 30``
    to each sample. Every op runs on the whole batch and each sample keeps
    its own op's result, as the JAX op's per-sample switch runs under vmap."""
    mag = m / 30.0
    for i in range(ops.shape[1]):
        m_i = (signs[:, i] * mag).reshape(-1, 1, 1, 1).to(x.dtype)
        out = x
        for s, op in enumerate(RANDAUG_OPS):
            out = torch.where((ops[:, i] == s).reshape(-1, 1, 1, 1), op(x, m_i), out)
        x = out
    return x


def rand_augment(generator: torch.Generator, x: Tensor, n: int = 2, m: int = 9,
                 shard: Shard = None) -> Tensor:
    """RandAugment on the device: ``n`` random ops per sample at magnitude
    ``m`` / 30 with a random sign, from the photometric and translation
    subset (brightness, contrast, saturation, posterize, solarize, invert,
    translate x and y). x: (B, C, H, W) float in [0, 1]."""
    return apply_rand_augment(x, *rand_augment_draws(generator, x.shape[0], n, x.device, shard),
                              m)
