"""Audio ingestion: WAV parsing and a Whisper-convention log-mel
frontend on the host, pure numpy + stdlib.

The port's copy of ``mop_tpu/data/audio.py`` (numpy only; the port imports
nothing of the JAX package). It takes an audio file to the (T, n_mels) mel
input of ``WhisperMoP``; the on-device frontend is
``mop_tpu_torch.ops.mel.log_mel_spectrogram``.

Conventions: 16 kHz target rate, 400-sample Hann STFT with hop 160
(25 ms / 10 ms), HTK mel scale, Whisper's dynamic-range normalization
(``log10``, clamp to max-8, ``(x+4)/4``). The models train from scratch on
these features, so the constants are a self-consistent contract rather than
a pretrained-weight requirement.
"""

from __future__ import annotations

import io
import wave
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["load_wav", "resample", "mel_filterbank", "log_mel",
           "wav_bytes", "segment_frames"]


def load_wav(source: Union[str, bytes, io.IOBase]) -> Tuple[
        np.ndarray, int]:
    """Read a PCM WAV file -> (mono float32 waveform in [-1, 1], rate).

    ``source``: a path, raw file bytes (e.g. an HTTP upload body), or a
    binary file object. 8-bit (unsigned), 16-bit, and 32-bit integer
    PCM are supported — the formats the stdlib ``wave`` module emits.
    Multi-channel audio is mixed down by averaging channels.
    """
    if isinstance(source, bytes):
        source = io.BytesIO(source)
    with wave.open(source, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 1:      # unsigned 8-bit
        x = np.frombuffer(raw, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, np.float32), rate


def wav_bytes(audio: np.ndarray, rate: int) -> bytes:
    """Mono float32 [-1, 1] -> 16-bit PCM WAV bytes (the test/demo
    inverse of :func:`load_wav`)."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def resample(x: np.ndarray, rate: int, target_rate: int) -> np.ndarray:
    """Linear-interpolation resample (adequate for speech features —
    the mel filterbank integrates away interpolation artifacts well
    below its bandwidth)."""
    if rate == target_rate:
        return np.asarray(x, np.float32)
    n_out = max(1, int(round(len(x) * target_rate / rate)))
    t_out = np.arange(n_out, dtype=np.float64) * (rate / target_rate)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64),
                     x).astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, rate: int,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular filterbank on the HTK mel
    scale, area-normalized per filter (each row sums to ~1 over its
    triangle) so filter energy is comparable across the scale."""
    fmax = rate / 2 if fmax is None else fmax
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz = _mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, d=1.0 / rate)
    fb = np.zeros((n_mels, len(bins)), np.float64)
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-10)
        down = (hi - bins) / max(hi - ctr, 1e-10)
        tri = np.maximum(0.0, np.minimum(up, down))
        s = tri.sum()
        if s > 0:
            tri /= s
        fb[i] = tri
    return fb.astype(np.float32)


def log_mel(audio: np.ndarray, rate: int = 16000, n_mels: int = 80,
            n_fft: int = 400, hop_length: int = 160,
            n_frames: Optional[int] = None) -> np.ndarray:
    """Waveform -> (T, n_mels) log-mel features, Whisper-normalized.

    Centered Hann STFT (reflect padding), power spectrum, mel
    filterbank, then the Whisper dynamic-range convention: ``log10``,
    clamp to ``max - 8`` (80 dB floor), ``(x + 4) / 4``. With
    ``n_frames`` the WAVEFORM is first zero-padded or trimmed to
    exactly ``n_frames * hop_length`` samples — the fixed 30 s-window
    contract of a Whisper encoder (``n_frames = n_audio_ctx``)."""
    x = np.asarray(audio, np.float32).reshape(-1)
    if n_frames is not None:
        want = n_frames * hop_length
        x = x[:want] if len(x) >= want else np.pad(x, (0, want - len(x)))
    if len(x) < hop_length:
        x = np.pad(x, (0, hop_length - len(x)))
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect" if len(x) > pad
               else "constant")
    t = len(x) - n_fft
    n_t = 1 + t // hop_length if t >= 0 else 1
    if n_frames is not None:
        n_t = min(n_t, n_frames)
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_t)[:, None])
    frames = x[idx] * np.hanning(n_fft + 1)[:-1][None, :]
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    mel = power @ mel_filterbank(n_mels, n_fft, rate).T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    out = ((log_spec + 4.0) / 4.0).astype(np.float32)
    if n_frames is not None and out.shape[0] < n_frames:
        out = np.pad(out, ((0, n_frames - out.shape[0]), (0, 0)))
    return out


def segment_frames(mel: np.ndarray, t_enc: int) -> list:
    """Split a (T, n_mels) log-mel spectrogram into sequential
    ``t_enc``-frame windows, zero-padding the last — the standard Whisper
    long-audio recipe (``WhisperConfig.n_audio_ctx`` defaults to 1500
    frames, about 30 s; anything longer transcribes as consecutive
    windows). The mel is computed ONCE over the whole clip
    (so the Whisper dynamic-range normalization sees the global max)
    and only the FRAMES are windowed. Returns a non-empty list of
    (t_enc, n_mels) arrays."""
    mel = np.asarray(mel, np.float32)
    if mel.ndim != 2:
        raise ValueError(f"mel must be (T, n_mels); got {mel.shape}")
    t = mel.shape[0]
    segs = []
    for lo in range(0, max(t, 1), t_enc):
        seg = mel[lo:lo + t_enc]
        if seg.shape[0] < t_enc:
            seg = np.pad(seg, ((0, t_enc - seg.shape[0]), (0, 0)))
        segs.append(seg)
    return segs
