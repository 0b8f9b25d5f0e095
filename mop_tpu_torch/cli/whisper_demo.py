"""Whisper-MoP demo: raw audio -> log-mel on the device -> encoder-decoder.

The port's counterpart of ``examples/whisper_demo.py``, with its data, model
and optimizer: sequences of four tones from an 8-note scale, whose note ids
are the target tokens (a toy transcription task); the log-mel frontend
(``ops.mel.log_mel_spectrogram``) runs on the model's device inside the step;
the decoder input is the targets shifted right behind a BOS token; AdamW at
1e-3 with optax's default weight decay 1e-4, fp32. A few steps show the loss
dropping below the uniform ln(16). Runs on the GPU unless given
``--device cpu``.

Usage: python -m mop_tpu_torch.cli.whisper_demo [--steps 30] [--batch 16]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.whisper_mop import WhisperConfig, create_whisper_mop
from ..ops.mel import log_mel_spectrogram
from ..utils.device import resolve_device

SAMPLE_RATE = 16_000
SECONDS = 0.5
VOCAB = 16  # 8 notes + BOS and padding room
BOS = 8


def tone_dataset(n: int, seconds: float = SECONDS, sr: int = SAMPLE_RATE, seed: int = 0):
    """Each sample: 4 sequential tones from an 8-note scale; the target token
    sequence is the note ids. The JAX example's data, draw for draw."""
    rng = np.random.RandomState(seed)
    notes = 220.0 * 2 ** (np.arange(8) / 8.0)
    t = np.arange(int(seconds * sr)) / sr
    seg = len(t) // 4
    audio = np.zeros((n, len(t)), np.float32)
    tokens = rng.randint(0, 8, (n, 4))
    for i in range(n):
        for j in range(4):
            f = notes[tokens[i, j]]
            audio[i, j * seg:(j + 1) * seg] = 0.5 * np.sin(2 * np.pi * f * t[:seg])
    return audio, tokens.astype(np.int64)


def demo_config() -> WhisperConfig:
    """The example's model: 64 wide, 4 heads, 2 + 2 layers, 3 views, 2 kernels."""
    n_frames = 1 + int(SECONDS * SAMPLE_RATE) // 160
    return WhisperConfig(n_mels=80, n_audio_ctx=n_frames, vocab_size=VOCAB, n_text_ctx=8,
                         n_embd=64, n_head=4, n_layer_enc=2, n_layer_dec=2, dropout=0.0,
                         bias=False, n_views=3, n_kernels=2, kernel_size=3)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Run the demo; returns the loss of every step."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    audio, tokens = tone_dataset(256)
    model = create_whisper_mop(demo_config(), device=device,
                               generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)

    def step(wav: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        mel = log_mel_spectrogram(wav, SAMPLE_RATE)  # on the model's device
        dec_in = torch.cat([torch.full_like(tgt[:, :1], BOS), tgt[:, :-1]], dim=1)
        opt.zero_grad(set_to_none=True)
        loss = model(mel, dec_in, targets=tgt)[1]
        loss.backward()
        opt.step()
        return loss.detach()

    sampler = np.random.RandomState(0)
    losses = []
    for s in range(1, args.steps + 1):
        sel = sampler.randint(0, len(audio), args.batch)
        loss = step(torch.from_numpy(audio[sel]).to(device),
                    torch.from_numpy(tokens[sel]).to(device))
        losses.append(loss.item())
        if s % 5 == 0 or s == 1:
            print(f"step {s:3d} loss {losses[-1]:.4f}", flush=True)
    print(f"\nfinal loss {losses[-1]:.4f} (uniform={np.log(VOCAB):.3f})")
    return losses


if __name__ == "__main__":
    main()
