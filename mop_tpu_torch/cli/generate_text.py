"""Text generation demo: train a tiny Quartet character LM, then sample with
both decoders, the exact full-window sampler (``generate``, K5 in every
layer of every step on the GPU) and the KV-cached one (``generate_cached``).

The port's counterpart of ``examples/generate_text.py``, with its flags and
defaults: 4 layers, 4 heads, 128 wide, dropout 0, block
``max(128, seq + tokens)``, AdamW 1e-3 (optax.adamw's weight decay 1e-4) on
random windows of a repeated sentence. Runs on the GPU unless given
``--device cpu``; on the GPU each decode step of either decoder is one CUDA
graph.

Usage: python -m mop_tpu_torch.cli.generate_text [--steps 300] [--tokens 64]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import TransformerConfig, create_gpt_quartet, generate, generate_cached
from ..utils.device import resolve_device

CORPUS = (
    "the quick brown fox jumps over the lazy dog while the cat naps in the "
    "warm sun and the birds sing in the tall green trees by the clear blue "
    "river that flows gently down to the wide open sea "
) * 50
PROMPT = "the quick brown "


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, sample, print; returns the printed losses (``losses``, step ->
    loss) and both samplers' text and seconds."""
    args = _parser().parse_args(argv)

    device = resolve_device(args.device)
    vocab = sorted(set(CORPUS))
    stoi = {c: i for i, c in enumerate(vocab)}
    data = np.asarray([stoi[c] for c in CORPUS], np.int64)
    cfg = TransformerConfig(n_layer=4, n_head=4, n_embd=128, dropout=0.0,
                            block_size=max(128, args.seq + args.tokens))
    model = create_gpt_quartet(len(vocab), cfg, device=device,
                               generator=torch.Generator().manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)  # optax.adamw
    rs = np.random.RandomState(0)
    losses = {}
    for s in range(args.steps):
        starts = rs.randint(0, len(data) - args.seq - 1, args.batch)
        idx = torch.from_numpy(np.stack([data[i:i + args.seq] for i in starts])).to(device)
        tgt = torch.from_numpy(np.stack([data[i + 1:i + args.seq + 1] for i in starts])).to(device)
        loss = model(idx, targets=tgt)[1]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if s % 100 == 0 or s == args.steps - 1:
            losses[s] = loss.item()
            print(f"step {s}: loss {losses[s]:.3f}")

    prompt = torch.tensor([[stoi[c] for c in PROMPT]], device=device)

    def text(t):
        return "".join(vocab[i] for i in t[0].tolist())

    out = {"losses": losses}
    for name, fn in (("full", lambda: generate(model, prompt, args.tokens,
                                               cuda_graph=device.type == "cuda")),
                     ("cached", lambda: generate_cached(model, None, prompt, args.tokens,
                                                        cuda_graph=device.type == "cuda"))):
        t0 = time.perf_counter()
        toks = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[name], out[name + "_s"] = text(toks), time.perf_counter() - t0
    print(f"\nfull-window ({out['full_s']:.2f}s): {out['full']!r}")
    print(f"kv-cached   ({out['cached_s']:.2f}s): {out['cached']!r}")
    return out


if __name__ == "__main__":
    main()
