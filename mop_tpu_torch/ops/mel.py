"""On-device log-mel spectrogram frontend, in PyTorch.

The port of ``mop_tpu/ops/mel.py``: Whisper-style defaults (n_fft 400, hop
160, 80 mels), framing by a gather over the reflect-padded signal, a Hann
window, ``torch.fft.rfft`` on the signal's device, the squared magnitude in
fp32, a fixed HTK-scale triangular filterbank product, log10 with the
dynamic range clamped to max - 8, and ``(x + 4) / 4``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def hann_window(n: int, device=None, dtype: torch.dtype = torch.float32) -> Tensor:
    """The periodic Hann window ``0.5 - 0.5 cos(2 pi i / n)``."""
    i = torch.arange(n, device=device, dtype=torch.float32)
    return (0.5 - 0.5 * torch.cos(2.0 * torch.pi * i / n)).to(dtype)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """(n_freqs, n_mels) triangular mel filterbank (HTK scale), fp32 numpy.

    Cached: callers get one shared array, which they must not write to."""
    fmax = fmax or sample_rate / 2
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def frame_signal(audio: Tensor, n_fft: int, hop: int) -> Tensor:
    """(B, S) -> (B, T, n_fft) overlapping frames of the reflect-padded signal."""
    pad = n_fft // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (x.shape[1] - n_fft) // hop
    starts = torch.arange(n_frames, device=audio.device) * hop
    idx = starts[:, None] + torch.arange(n_fft, device=audio.device)[None, :]  # (T, n_fft)
    return x[:, idx]


def log_mel_spectrogram(audio: Tensor, sample_rate: int = 16_000, n_fft: int = 400,
                        hop: int = 160, n_mels: int = 80) -> Tensor:
    """(B, S) raw audio in [-1, 1] -> (B, T, n_mels) Whisper-style log-mel,
    on the audio's device.

    log10 power through the mel filterbank, clamped per clip to (max - 8),
    then scaled to roughly [-1, 1] by (x + 4) / 4.
    """
    frames = frame_signal(audio, n_fft, hop)  # (B, T, n_fft)
    win = hann_window(n_fft, frames.device, frames.dtype)
    spec = torch.fft.rfft(frames * win, dim=-1)
    power = spec.abs().square().float()  # (B, T, F)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(power.device)
    mel = power @ fb  # (B, T, n_mels)
    log_mel = torch.log10(mel.clamp_min(1e-10))
    log_mel = torch.maximum(log_mel, log_mel.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_mel + 4.0) / 4.0
