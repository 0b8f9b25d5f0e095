"""Tiny character-LM training run: GPT-MoP, the baseline GPT or Quartet, on a
synthetic structured character corpus, through ``make_lm_train_step``.

The port's counterpart of ``examples/train_gpt_char.py``, with its flags and
defaults: vocab 32, dropout 0, AdamW with a cosine schedule and weight decay
0.1, grad clip 1.0, bf16 compute; ``mop`` has 4 views and 2 kernels. A loss
well below the uniform ln(32) shows real sequence learning. Runs on the GPU
unless given ``--device cpu``; on the GPU each step is one CUDA graph.

Usage: python -m mop_tpu_torch.cli.train_gpt_char [--steps 200] [--model mop]
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import TransformerConfig, create_gpt_baseline, create_gpt_mop, create_gpt_quartet
from ..parallel import make_lm_train_step
from ..utils.device import resolve_device

VOCAB = 32


def synthetic_corpus(n_chars: int = 200_000, seed: int = 0) -> np.ndarray:
    """Markov-ish character stream over a 32-symbol alphabet with strong
    bigram structure plus repeated motifs, so a causal LM has signal. The
    same stream as the JAX example's: each next character is the bigram
    row's cumulative distribution searched at one uniform draw, which is
    what ``RandomState.choice(v, p=row)`` computes."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(VOCAB) * 0.1, size=VOCAB)  # peaky bigram table
    motif = rng.randint(0, VOCAB, 12)
    cdf = trans.cumsum(axis=1)
    cdf /= cdf[:, -1:]
    out = np.empty(n_chars, np.int32)
    c = 0
    i = 0
    while i < n_chars:
        if rng.rand() < 0.05 and i + len(motif) < n_chars:
            out[i:i + len(motif)] = motif
            i += len(motif)
            c = motif[-1]
        else:
            c = int(cdf[c].searchsorted(rng.random_sample(), side="right"))
            out[i] = c
            i += 1
    return out


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model", choices=["baseline", "quartet", "mop"], default="mop")
    ap.add_argument("--n_layer", type=int, default=4)
    ap.add_argument("--n_head", type=int, default=4)
    ap.add_argument("--n_embd", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = TransformerConfig(n_layer=args.n_layer, n_head=args.n_head, n_embd=args.n_embd,
                            dropout=0.0, block_size=args.block, bias=False)
    factory = {"baseline": create_gpt_baseline, "quartet": create_gpt_quartet,
               "mop": lambda v, c, **kw: create_gpt_mop(v, c, n_views=4, n_kernels=2, **kw)}
    model = factory[args.model](VOCAB, cfg, device=device,
                                generator=torch.Generator().manual_seed(0))
    # On the card the step is one CUDA graph: AdamW capturable, its lr a
    # tensor that the scheduler fills in place.
    graphed = device.type == "cuda"
    lr = torch.tensor(args.lr, device=device) if graphed else args.lr
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.1, capturable=graphed)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=args.steps)
    step = make_lm_train_step(model, opt, grad_clip=1.0, device=device, cuda_graph=graphed)
    gen = torch.Generator(device=device).manual_seed(0)

    corpus = synthetic_corpus()
    sampler = np.random.RandomState(0)
    loss = float("nan")
    for s in range(1, args.steps + 1):
        starts = sampler.randint(0, len(corpus) - args.block - 1, args.batch)
        xb = np.stack([corpus[i:i + args.block] for i in starts])
        yb = np.stack([corpus[i + 1:i + args.block + 1] for i in starts])
        m = step(torch.from_numpy(xb), torch.from_numpy(yb), gen)
        sched.step()
        if s % 25 == 0 or s == 1:
            loss = m["loss"].item()
            print(f"step {s:4d} loss {loss:.4f}", flush=True)
    loss = m["loss"].item()
    print(f"\n{args.model}: final loss {loss:.4f} (uniform={math.log(VOCAB):.3f})")
    return loss


if __name__ == "__main__":
    main()
