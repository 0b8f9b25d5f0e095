"""The Whisper audio frontends of the port against the JAX package's: the
on-device ``log_mel_spectrogram`` (``ops/mel.py``) against ``mop_tpu.ops.mel``
on the same audio (atol 1e-4 on the normalized scale) with the filterbanks
equal to 1e-7, and the host-side copy ``data/audio.py`` against
``mop_tpu.data.audio`` on the cases of ``tests/test_audio.py``, exactly."""

import io
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.data.audio as JA
import mop_tpu.ops.mel as JM
import mop_tpu_torch.data.audio as PA
import mop_tpu_torch.ops.mel as PMEL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MEL_ATOL = 1e-4


def _tone(freq, sr=16000, secs=0.5, amp=0.5):
    t = np.arange(int(sr * secs)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.mark.parametrize("n_mels,n_fft,sr", [(80, 400, 16000), (16, 400, 16000),
                                             (40, 512, 8000)])
def test_mel_filterbank_equals_jax(n_mels, n_fft, sr):
    np.testing.assert_allclose(PMEL.mel_filterbank(n_mels, n_fft, sr),
                               JM.mel_filterbank(n_mels, n_fft, sr), rtol=0, atol=1e-7)


def test_hann_window_and_frames_equal_jax():
    np.testing.assert_allclose(PMEL.hann_window(400).numpy(), np.asarray(JM.hann_window(400)),
                               rtol=0, atol=1e-7)
    audio = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_array_equal(PMEL.frame_signal(torch.from_numpy(audio), 400, 160).numpy(),
                                  np.asarray(JM.frame_signal(jnp.asarray(audio), 400, 160)))


@pytest.mark.parametrize("case", ["noise", "tones", "demo_n_mels_16"])
def test_log_mel_spectrogram_matches_jax(case):
    rng = np.random.default_rng(1)
    kw = {}
    if case == "noise":
        audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    elif case == "tones":
        audio = np.stack([_tone(440, secs=1.0), _tone(3000, secs=1.0, amp=0.2)])
    else:  # a short clip at another filterbank width
        audio = (rng.standard_normal((3, 4000)) * 0.3).astype(np.float32)
        kw = dict(n_mels=16)
    want = np.asarray(JM.log_mel_spectrogram(jnp.asarray(audio), **kw))
    got = PMEL.log_mel_spectrogram(torch.from_numpy(audio), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MEL_ATOL)


def test_log_mel_spectrogram_range_and_pitch():
    """tests/test_ops.py's checks: the frame count, finite values, a tone's
    energy in the lower mel range; and the (max - 8) floor per clip."""
    mel = PMEL.log_mel_spectrogram(torch.from_numpy(
        (np.random.default_rng(2).standard_normal((2, 16000)) * 0.1).astype(np.float32)))
    assert tuple(mel.shape) == (2, 1 + 16000 // 160, 80) and torch.isfinite(mel).all()
    m = PMEL.log_mel_spectrogram(torch.from_numpy(_tone(440, secs=1.0, amp=1.0)[None]))
    assert 0 < int(m[0].mean(0).argmax()) < 40
    assert float(m.max() - m.min()) <= 2.0 + 1e-6


def _wav_cases(tmp_path):
    """Every WAV of tests/test_audio.py: 16-bit, 8-bit, 32-bit, stereo, a path."""
    x = _tone(440, secs=0.1)
    out = {"16bit": PA.wav_bytes(_tone(440), 16000)}
    assert out["16bit"] == JA.wav_bytes(_tone(440), 16000)
    for name, width, frames in (
            ("8bit", 1, (np.clip(x, -1, 1) * 127 + 128).astype(np.uint8).tobytes()),
            ("32bit", 4, (x * 2147483647).astype("<i4").tobytes())):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1), w.setsampwidth(width), w.setframerate(16000)
            w.writeframes(frames)
        out[name] = buf.getvalue()
    inter = np.empty(2 * len(x), np.float32)
    inter[0::2], inter[1::2] = x, -x
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2), w.setsampwidth(2), w.setframerate(16000)
        w.writeframes((inter * 32767).astype("<i2").tobytes())
    out["stereo"] = buf.getvalue()
    p = tmp_path / "t.wav"
    p.write_bytes(PA.wav_bytes(x, 16000))
    out["path"] = str(p)
    return out


def test_load_wav_equals_jax(tmp_path):
    for name, src in _wav_cases(tmp_path).items():
        (got, sr), (want, sr_j) = PA.load_wav(src), JA.load_wav(src)
        assert sr == sr_j and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1), w.setsampwidth(3), w.setframerate(16000)
        w.writeframes(b"\x00\x00\x00" * 10)
    with pytest.raises(ValueError):
        PA.load_wav(buf.getvalue())


def test_resample_equals_jax():
    for x, rate, target in ((_tone(440, sr=8000, secs=0.25), 8000, 16000),
                            (_tone(440, sr=8000, secs=0.25), 8000, 8000),
                            (_tone(440, sr=48000), 48000, 16000)):
        np.testing.assert_array_equal(PA.resample(x, rate, target), JA.resample(x, rate, target))


def test_host_mel_filterbank_and_log_mel_equal_jax():
    np.testing.assert_array_equal(PA.mel_filterbank(80, 400, 16000),
                                  JA.mel_filterbank(80, 400, 16000))
    cases = [(_tone(440, secs=1.0), dict(n_frames=100)), (_tone(300, secs=1.0), dict(n_frames=100)),
             (_tone(4000, secs=1.0), dict(n_frames=100)), (_tone(440, secs=0.05), dict(n_frames=100)),
             (_tone(440, secs=0.5), {}), (_tone(440, secs=0.001), {})]
    for audio, kw in cases:
        got, want = PA.log_mel(audio, 16000, **kw), JA.log_mel(audio, 16000, **kw)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_segment_frames_equals_jax():
    mel = np.random.default_rng(3).standard_normal((130, 8)).astype(np.float32)
    for t_enc in (50, 130, 200):
        got, want = PA.segment_frames(mel, t_enc), JA.segment_frames(mel, t_enc)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        PA.segment_frames(mel[0], 10)
