#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mop_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --phases 12,15`` builds, then runs only the named
phases of 10-17 (15 runs 10 first, for its CSVs), and prints neither the
kernels line nor the last line's ok: a quicker check of a later phase.

Phases, one line each (a failed phase makes the script exit non-zero):

1. the device, with ``nvidia-smi``'s name and power limit;
2. build every kernel of the path from ``mop_tpu_torch/csrc`` with nvcc,
   print each kernel's registers and spills (both K2 kernels and both K3b
   instantiations among them, and whether K3b spills), and hold the Python byte counts the wrappers
   launch with and the modules route by (K1's, K2's, K3's, K4's (over its
   whole envelope), K5's, K2b's and K3b's shared memory per dtype, K2b's, K3b's and K3's workspace, where K5
   keeps its score rows) to the libraries' own;
3. K1 ``flash_attention`` against its plain PyTorch version on the card:
   fp32 and bf16 at the path shape, at B's strided dk-54 views, causal,
   ragged and long (N 1500, several key blocks) cases, and at Whisper's
   three attention sites (phase 11): the 20M config's encoder (8, 6, 750,
   64), causal decoder (8, 6, 112, 64) and cross-attention (112 queries
   against 750 keys), and the reference width's 1500, 448-causal and 448 x
   1500 shapes;
4. K2 ``fused_edgewise_lowrank_attention`` against its plain version: fp32
   and bf16 at the path shape, off shapes (two and eight views, N < 64,
   dk > 64) and strided views;
   4b. K3 ``fused_edgewise_dense_attention`` against its plain version:
   fp32 and bf16 at the path shape, strided views, off shapes (two and eight
   views, N < 64, dk > 64, the fp32 maps in the workspace);
   4c. K4 ``fused_multihop_attention`` against its plain version: hops 3
   and 2 with every gate on, fp32 and bf16, strided views (hops 3 and 2,
   and at dk 54 with 8-byte copies); fp32 off the main shape (N 1, 33, 40,
   dk 8, 100, 128, hops 2 to 4), with the default gates and with chain_w 0;
   and at phase 10's D (dk 50, the harness's gates, strided views);
   4d. K5 ``fused_quartet_attention`` against its plain version: the LM's
   shape, N = 1 and 100, both sides of the kept-rows threshold at dk 80
   and 128, fp32 and bf16, strided views, and GPT-MoP's train shape
   (64, 6, 256, 64);
5. K2b ``fused_edgewise_lowrank_attention_bwd`` against its plain backward
   (autograd through the plain forward), all eight grads, fp32 and bf16, at
   the path shape, off shapes (dk > 64 too) and the strided view inputs;
   5b. K3b ``fused_edgewise_dense_attention_bwd`` likewise, both dtypes at
   the off shapes and the strided views;
6. K1's autograd (kernel forward, recompute backward) against autograd
   through the plain version, at the ViT path's shape and Whisper's 20M
   encoder shape; 6b. K4's and K5's (kernel forward, recompute
   backward) against autograd through their composed references;
7. the eval path: CIFAR-100 eval steps of the full-width 5M-parameter A, B,
   E (lowrank gates) and E_dense (the dense gate head) configurations, B at
   the bench.py config, and the 256/8/4 D (multi-hop, K4), Gated (two-hop,
   K4) and C (cross-view, no kernel) ViTs of the experiments, batch 256,
   fp32, with kernel launch counts and the logits held against the plain
   path; an E, E_dense and D layer at N = 196 (224/16 images): E's through
   K2w (and K2bw for its gradient), E_dense's and D's, beyond K3's and K4's
   N, composed with no launch; each matches its plain path;
   7b. gradients through the eval forward of E, E_dense (the edgewise
   backward kernels) and D (K4's recompute backward), launches counted,
   grads held against the plain path;
   7c. the Quartet LM at the reference's comparison config (8 layers, 8
   heads, 640 wide, block 256, vocab 8192): one eval forward with targets
   at 64 sequences of 256 tokens, K5 launches (8, and 0 with
   ``need_weights`` or ``causal_std``), logits and loss held against the
   plain path;
8. the train path: the bench.py recipe (augment, bf16 compute, AdamW 3e-3 /
   0.05) for the ViT configs at batch 256: launches per step, one step's
   fp32 grads held against the plain path, 20 steps on one repeated batch
   whose loss must fall, images/s of the scanned step (K = 20) with a
   torch.profiler breakdown (E_dense through its composed route too), and
   an eval step after training;
   8b. the LM train path through ``make_lm_train_step`` (bf16 compute,
   AdamW 3e-4 / 0.1, 64 sequences of 256 tokens, vocab 8192): the Quartet LM
   at the comparison config at dropout 0, as ``examples/train_gpt_char.py``
   and ``tools/bench_lm.py`` train (grad clip 1.0): K5 launches per step (8,
   and no other kernel), one step's fp32 grads and one bf16 step's loss held
   against the plain path, 20 steps on one batch whose loss must fall,
   tokens/s over timed windows with a torch.profiler breakdown; the same
   model at the comparison config's dropout 0.1 (composed: no launch, a
   finite loss); GPT-MoP at ``tools/bench_lm.py``'s config (6 layers, 6
   heads, 384 wide, Quartet attention, no clip): its parameter count, K5
   launches per step (6), fp32 grads, the falling loss and tokens/s; and the
   comparison framework's GPT-MoP (Quartet off): no launch; the whole
   Quartet LM step through K5 with its recompute backward and composed, by
   the kernel switch ``config.fused_quartet``, in turns, with each route's
   peak memory;
9. timings: each kernel at its path shape beside its plain version, its
   bound and one library call where there is one, and K2's, K3's, K4's and
   K5's times before their redesign (K1, K2, K2b, K3, K3b, K4 and K5 in
   bf16 too, K5 also at GPT-MoP's shape, K1 also at Whisper's encoder and
   cross-attention shapes beside sdpa; K4 also with a device chain_w, as
   the models pass it, and K1's, sdpa's and K4's fp32 time replayed from a
   CUDA graph, without the host's launch path); one E_dense attention layer's
   bf16 forward and backward in training through the kernel route (K3, K3b)
   and the composed route, and one D layer's through K4 with its recompute
   backward and the composed route, and which was faster; each ViT's eval
   images/s, the LM's eval forward and the gradient through E's, E_dense's
   and D's eval forward (7b), with a torch.profiler breakdown of their
   device time;
10. the CIFAR experiment harness through its entry point,
   ``mop_tpu_torch.experiments.cifar100_ab5_param_budgets.run``: A, B, C, D
   and E (lowrank and dense gate heads) matched at the 5M target on the
   synthetic tiny set, 20 lockstep steps at batch 256 with evals at steps 1,
   10 and 20; the matched configs and parameter counts held to the JAX
   matcher's, every loss finite and falling, the four output files with the
   JAX harness's names and headers, and the launches of K1, K2, K2b, K3,
   K3b and K4 in that run (the kernels line's ``launches_ab5``); the trained
   D's logits on a val batch through K4 and with ``fused_multihop`` off; the
   device's busy share over 10 more lockstep steps of the run's models;
   10b. the single-model CLI ``cifar100_multihop_gates`` at its default width
   (256 / 8 / 4) for 10 steps: finite losses and its ``seed,acc`` CSV;
11. Whisper-MoP, ``tools/bench_lm.py``'s 20M config (384 wide, 6 heads, 4 + 4
   layers, 750 frames, 112 tokens, vocab 8192, batch 8) and the reference
   width (``WhisperConfig``'s defaults, batch 4): parameter counts against
   mop_tpu's; an fp32 eval forward with targets at both widths, K1 launches
   (12 and 36) and the logits, loss and gates against the plain path; the
   20M train step by ``tools/bench_lm.py``'s recipe (bf16 compute, fp32
   grads, AdamW 3e-4 / 0.1): 12 K1 launches and no other kernel, one step's
   fp32 grads and a bf16 loss and logits against the plain path, 20 steps on
   one batch whose loss must fall, audio frames/s over three timed windows
   with a torch.profiler breakdown, the busy share and the peak memory, one
   layer's MoP2D gate forward + backward in both dtypes; two bf16 train steps
   at the reference width; greedy transcription at the reference width by a
   fresh model with its kernels scaled (4 clips, 32 varied tokens): the full
   window's 24 K1 launches a step, each cached step's logits teacher-forced
   on the full window's tokens, the cached route's tokens against the full
   window's with fp32 and bf16 KV, int8 KV; the full-window vs cached
   crossover at
   ``tools/bench_whisper_dispatch.py``'s config; the demo CLI for 10 steps.
   K1's ``launches`` in the kernels line add one 20M train step's and one
   reference-width forward's;
12. the MoE ViT, VOC localization and the ImageNet path: ``ViT_MoP(use_moe=True,
   moe_experts=4)`` at B_bench's width, batch 256, dense and routed: an fp32 eval
   forward (K1 6 launches, logits against the plain path), routed at capacity factor 4
   against dense (fp32), the share of tokens dropped at 1.25, a bf16 train step (K1 6),
   20 steps on one batch whose loss must fall, ms/step, images/s, busy share and peak
   memory; the op at ``tools/bench_moe.py``'s shapes (16,384 tokens, 256 -> 1024, 4 / 8 /
   16 experts, bf16), dense against routed, forward and forward + backward; the VOC CLI
   ``voc_localization_vit.main`` at its defaults (224/16, 256 x 6 x 4, batch 64,
   ``--synthetic --tiny --epochs 2``) for A, B and E: the loss falling, IoU in [0, 1],
   its CSV, K1 66 launches in A's and B's runs, K2w 66 and K2bw 48 in E's, after K2w and
   K2bw at E's attention shape (64, 4, 4, 196, 64) r=4 and off it against their plain
   versions, with their times, each kernel's device time by name (torch.profiler's
   records, held to the library's own launch count) and the products' achieved
   TFLOP/s, the fp32 bound at the 3xTF32 rate (495 / 3 TFLOP/s); K1 at A's and B's
   (64, 4, 196, 64) against its plain
   version and sdpa; the ImageNet
   CLI ``imagenet_ab_param_budgets.main`` (``--synthetic --tiny --targets 50000000
   --steps 20 --ema``) with A and B at batch 256 and E at 128 (at 256 its step does not
   fit): the JAX matcher's configs, finite losses, the EMA off the params, the three files,
   no launch (A and B compose at dk 160 and 158, E's dense gate at N = 196); and the
   ImageNet bf16 step alone (RandAugment, erasing, Mixup / CutMix at their defaults): A at
   batch 256 with each remat mode (none, full, dots, dots_nb: per-block checkpoints), B at
   256, E at 128, each with ms/step, images/s, busy share and peak memory. The kernels
   line's ``launches`` add the MoE's counted steps and forwards and the VOC runs'; K1's
   holds the (64, 4, 196, 64) timings as ``voc_fp32`` and ``voc_bf16``; K2w and K2bw
   are timed at VOC E's shape, their records carrying ``products_tflops``;
13. decode (``mop_tpu_torch.models.generate``, ``beam``, ``speculative``, ``ops.quant``):
   13a, ``tools/bench_decode.py``'s GPT-Quartet (6 x 384, vocab 512, batch 8, a 16-token
   prompt, block 256): the exact full-window ``generate`` for 240 tokens, K5 6 x 240
   launches, its greedy tokens with ``fused_quartet`` off equal up to each row's first near
   tie (top-two margin under 1e-4) and each step's logits teacher-forced on them against
   the plain path; ``generate_cached`` with fp32, bf16 and int8 KV: tokens/s and greedy
   agreement with the full window, ``benchmarks/decode.md``'s table with the port's
   numbers, and both samplers' busy share; 13b, the 170M GPT-Quartet (12 x 1024, 16 heads,
   block 512, batch 1) of ``tools/bench_speculative.py``: ``generate`` for 32 tokens through
   K5's streaming kernel (``quartet_keeps_rows`` false at (1, 16, 512, 64) fp32), 12 x 32
   launches, its logits teacher-forced against the plain path; ``generate_cached`` with
   fp32, int8 and int4 weights (stored MB, ms a step, teacher-forced agreement with fp32);
   ``decode_chunk`` against the same tokens one ``decode_step`` at a time; greedy
   ``speculative_generate`` with the 2 x 128 draft at gamma 4 and ``generate_beam`` with
   one beam giving ``generate_cached``'s tokens up to the first near tie, with the
   acceptance and tokens/s; four beams sorted; K5 timed at both decode shapes; 13c,
   Whisper_20M beam transcription (4 beams, 32 tokens, batch 8): K1's 4 encoder launches,
   one beam giving ``whisper_transcribe_cached``'s tokens, int8 KV refused; 13d, the demo
   ``mop_tpu_torch.cli.generate_text`` for 50 steps: the loss falling, both samplers'
   text. The kernels line's ``launches`` add the exact samplers' K5 launches and the beam
   encoder's K1 launches; K5's record holds the decode shapes' timings
   (``decode_8x6x256x64``, ``decode_1x16x512x64``).
14. serving (``mop_tpu_torch.serving``, ``cli.serve_http``): 14a, ``DecodeEngine`` at
   ``tools/bench_serving.py``'s GPT-Quartet (6 x 512, 8 heads, vocab 512, block 512, buckets
   64 / 128 / 256 / 512, 8 slots) over its 32 ``mixed_jobs`` (prompts of 48 to 249 tokens, 64
   new): no kernel launch (K5 0), tokens/s, busy share and peak memory, every row against its
   single-stream ``generate_cached`` up to the first near tie; ``step(n_tokens=4)`` giving
   the single steps' tokens; ``chunk_prefill`` 64 and a 192-token system prompt through the
   prefix cache, each held to the single-stream ``decode_chunk`` feed it computes (with the
   share of tokens equal to the monolithic prefill's); a 4-beam request equal to
   ``generate_beam``; int8 KV; 14b, the 170M of ``tools/bench_serving_slo.py`` (12 x 1024,
   block 2048, 4 slots) under a closed loop of 4 users, fp32 and int8 weights: requests/s,
   TTFT and TPOT; 14c, ``WhisperServingEngine`` at Whisper_20M (8 clips, 32 tokens, 4 slots):
   K1 4 launches an admission (held to the profiler's records), the tokens of
   ``whisper_transcribe_cached`` up to the first near tie, int8 weights; 14d,
   ``serve_http`` trained and served on loopback: 8 concurrent text clients, a stream,
   ``/v1/completions``, ``/v1/embeddings``, ``/v1/audio/transcriptions`` through the 14c engine
   against ``whisper_transcribe_cached``, ``/metrics``' TTFT / TPOT histograms and a drain. The
   kernels line's K1 ``launches`` add the Whisper admissions' (and K5's the CLI's training).
15. the trainer and the later CLIs: 15a, ``training.train_model`` at B_bench's width
   (``bench.py:23-29``: ``ViT_MoP`` 224 / 6 / 4, 5 views, 3 kernels, batch 256, bf16, AdamW 3e-3
   / 0.05 with ``cosine_lr``) on random uint8 CIFAR-shaped batches, a function of the step, for
   30 steps, eval and checkpoint every 10: K1's launches (6 in ``init``'s check forward, 6 a step
   and a val batch) and the checkpoints kept; a second run stopped through its guard's
   ``signal_now()`` in step 15, its exit code 75 checked, then resumed: its losses and every
   parameter bit-equal to the uninterrupted run's (cuDNN's and PyTorch's deterministic
   algorithms on for 15a); three ``Trainer.step``s and an ``evaluate`` under
   ``utils.profiling.trace()`` (host and device): K1's kernel records against its launches, the
   Chrome trace's host ops and kernels; ``Trainer.step``'s images/s by ``ThroughputMeter``, the
   busy share and the MFU against ``chip_peak_bf16_flops()``; 15b, the later CLIs with
   ``--synthetic --tiny`` for 5 steps at the 5M target: ``cifar100_ab4_param_budgets`` (K1 in A
   and B, K4 at hops 3 in D's eval forwards), ``cifar10_twohop_param_budgets`` (K4 at hops 2),
   ``cifar10_multi_seed`` (K1 at 256 / 6 / 4), ``ab5_tournament --plan_only`` and A and B
   through the tournament: each kernel's launches predicted from the matched depths and held to
   its wrapper's count and the profiler's records, their files and headers; then
   ``ab5_paper_benchmark`` over phase 10's and the tournament's CSVs, its 5M row against the
   CSVs' means. The kernels line's ``launches`` add phase 15's.
16. paged and speculative serving and export (``mop_tpu_torch.serving``): 16a, 14a's engine and
   32 jobs through ``DecodeEngine`` and ``PagedDecodeEngine`` with 64 pages of 64 rows (the dense
   slabs' capacity) and 32 (half): no kernel launch, tokens/s, busy share, peak memory,
   ``peak_pages_in_use`` and ``preemptions``; at 64 pages every row equal to the dense engine's
   up to its first near tie (margins from the dense engine's top-2 logprobs); at 32 the cache's
   bytes against the dense slabs', preemptions, each row never preempted equal to the dense
   engine's and each preempted row to its single stream re-prefilled where it was preempted;
   ``step(n_tokens=4)`` giving the single steps' tokens; 16b, ``SpecDecodeEngine`` at the 170M
   of ``tools/bench_speculative.py`` (12 x 1024, 16 heads, block 512) with its 2 x 128 draft
   and with the target as its own draft, 4 slots, 16 requests of 16 + 32 tokens, gamma 4:
   tokens equal to the plain engine's up to the first near tie, the acceptance share, engine
   steps, tokens/s and busy share, every draft accepted and at most 1 + ceil(31 / 5) steps a
   request with the perfect draft; 16c, ``export_apply`` on the card of A (224 / 8 / 4), the
   Quartet LM at the comparison config and E and D at depth 2: refused without
   ``allow_custom_calls``, naming the ``mop_tpu_torch::`` op; the loaded artifact launching
   K1 8, K5 8, K2 2 and K4 2 times a forward, its output against the eager forward (fp32,
   atol 2e-5, rtol 2e-4), A's one artifact at batch 1, 3 and 256; 16d, ``serve_http --spec``
   on the card. The kernels line's ``launches`` add 16c's.
17. the multi-GPU modes (``mop_tpu_torch.parallel``) over NCCL at world size 1 (one process
   drives one card; the multi-rank numerics are the CPU tests' over gloo): 17a, data parallel
   over the bench.py recipe (B 224 / 6 / 4, batch 256, bf16), the plain and the scanned (K =
   20) step against the one-device step, losses and parameters bit-equal after 3 steps (20
   scanned), K1 6 launches a step (plain and scanned), the ms a step beside the one-device
   step's (interleaved), each step's device time, busy share and host time from one trace with
   the kernels and host ops that differ most, and the gradient reduction alone; 17b, FSDP and
   ZeRO-1 of LM_quartet (8 x 640, 64 x 256, bf16) against ``make_lm_train_step``: losses within
   1e-3, K5 8 launches a step, peak memory; 17c, tensor parallel A and GPT_MoP (with and
   without sequence parallelism) against the one-device steps: losses within 1e-3, K1 8 and
   K5 6 launches a step, the heads they launch on; 17d, ring attention at Whisper_20M's (8, 6,
   750, 64) against K1 and full attention (output and the three grads), the expert-parallel
   op against ``dense_top1_mlp`` at MoE B_bench's shapes; 17e, multi-seed (2 seeds of B_bench)
   against two one-seed runs, bit-equal; each mode's collectives (recorded) equal to its row
   of ``MODE_COLLECTIVES`` (none for the ring, which has no neighbour at world 1), from which the modes two ranks could run on one card over gloo are
   printed; 17f, ``cli.launch_multihost --nproc 1`` running ``cli.multihost_train`` over NCCL
   (and at the card count where it is above 1). The kernels line's ``launches`` add 17's.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import shutil
import statistics
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mop_tpu_torch import (CIFAR100_MEAN, CIFAR100_STD, ComparisonConfig, GPTComparisonFramework,
                           IMAGENET_MEAN, IMAGENET_STD, TransformerConfig, ViTCrossView,
                           ViTEdgewise, ViTGated, ViTMultiHop, ViT_Baseline, ViT_MoP,
                           WhisperConfig, cast_floats, create_gpt_mop, create_gpt_quartet,
                           create_whisper_baseline, create_whisper_mop, decode_params, generate,
                           generate_beam, generate_cached, make_classifier_eval_step,
                           make_classifier_train_step, make_imagenet_train_step,
                           make_lm_train_step, make_scanned_classifier_train_step,
                           speculative_generate, whisper_transcribe, whisper_transcribe_auto,
                           whisper_transcribe_beam, whisper_transcribe_cached)
from mop_tpu_torch.cli import generate_text, serve_http, whisper_demo
from mop_tpu_torch.config import config as kernel_switches
from mop_tpu_torch.experiments import cifar100_ab5_param_budgets as ab5
from mop_tpu_torch.experiments import cifar100_multihop_gates
from mop_tpu_torch.experiments import imagenet_ab_param_budgets as imagenet_cli
from mop_tpu_torch.experiments import voc_localization_vit as voc_cli
from mop_tpu_torch.experiments import common as harness
from mop_tpu_torch.models import EdgewiseMSA, MultiHopMSA
from mop_tpu_torch.models.generate import (decode_chunk, decode_step, prefill,
                                           whisper_decode_prep, whisper_decode_token)
from mop_tpu_torch.models.components import MoEMLP
from mop_tpu_torch.models.layers import gelu_tanh, init_params
from mop_tpu_torch.ops import _build
from mop_tpu_torch.ops import moe as ops_moe
from mop_tpu_torch.ops import fused as F
from mop_tpu_torch.ops.preprocess import cifar_eval_transform
from mop_tpu_torch.ops.quant import quantize_params, quantized_bytes
from mop_tpu_torch.data.audio import log_mel, segment_frames
from mop_tpu_torch.models.generate import (init_decode_cache, whisper_decode_params,
                                           whisper_encode)
from mop_tpu_torch.serving import (DecodeEngine, PagedDecodeEngine, SpecDecodeEngine,
                                   WhisperServingEngine, export_apply, load_exported)

BATCH = 256
N_CLASSES = 100
TRAIN_K = 20  # scanned steps per call, as bench.py's SCAN_STEPS
TRAIN_WINDOWS = 5  # timed scanned calls per config
LR, WD = 3e-3, 0.05  # bench.py's AdamW
# bf16 grads, kernel vs plain: both round a cotangent where it passes back
# through a cast, but the kernel's products sum in another order on the
# tensor cores and split the fp32 cotangents into two bf16 terms, which can
# flip a rounding; each grad is held to this fraction of its largest
# magnitude.
BF16_GRAD_FRAC = 2e-2
# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 off the tensor cores
PEAK_TF32 = 495e12  # on the tensor cores; a 3xTF32 product takes three passes
PEAK_BYTES = 3.35e12

# Full-width configs of experiments/cifar100_ab5_param_budgets.py at the 5M
# target (A, B, E) and of bench.py (B at 224/6/4).
# name -> (constructor(generator, **kw), {kernel: launches per forward});
# see expected() for the launches of a train step and of an eval gradient.
MODELS = {
    "A": (lambda g, **kw: ViT_Baseline(dim=224, depth=8, heads=4, n_classes=N_CLASSES,
                                       generator=g, **kw), {"flash_attention": 8}),
    "B": (lambda g, **kw: ViT_MoP(dim=216, depth=8, heads=4, n_classes=N_CLASSES, n_views=5,
                                  n_kernels=3, generator=g, **kw), {"flash_attention": 8}),
    "B_bench": (lambda g, **kw: ViT_MoP(dim=224, depth=6, heads=4, n_classes=N_CLASSES,
                                        n_views=5, n_kernels=3, generator=g, **kw),
                {"flash_attention": 6}),
    "E": (lambda g, **kw: ViTEdgewise(dim=224, depth=4, heads=4, n_classes=N_CLASSES,
                                      n_views=5, share_qkv=False, gate_mode="lowrank",
                                      gate_rank=4, gate_init="mix5", mlp_ratio=4.0,
                                      generator=g, **kw),
          {"fused_edgewise_lowrank_attention": 4}),
    # E with the reference's default dense gate head (4,869,524 params).
    "E_dense": (lambda g, **kw: ViTEdgewise(dim=224, depth=4, heads=4, n_classes=N_CLASSES,
                                            n_views=5, share_qkv=False, gate_mode="dense",
                                            gate_init="neutral", mlp_ratio=4.0, generator=g,
                                            **kw),
                {"fused_edgewise_dense_attention": 4}),
    # The C/D ViTs at the defaults of experiments/cifar100_multihop_gates.py,
    # cifar100_twohop_gates.py and cifar100_crossview_mixer.py (256/8/4).
    "D": (lambda g, **kw: ViTMultiHop(dim=256, depth=8, heads=4, n_classes=N_CLASSES, hops=3,
                                      beta_not=0.5, generator=g, **kw),
          {"fused_multihop_attention": 8}),
    "Gated": (lambda g, **kw: ViTGated(dim=256, depth=8, heads=4, n_classes=N_CLASSES,
                                       beta_not=0.5, generator=g, **kw),
              {"fused_multihop_attention": 8}),
    "C": (lambda g, **kw: ViTCrossView(dim=256, depth=8, heads=4, n_classes=N_CLASSES,
                                       use_transpose_cues=False, generator=g, **kw), {}),
}
K2B, K3B = "fused_edgewise_lowrank_attention_bwd", "fused_edgewise_dense_attention_bwd"
WIDE_FWD, WIDE_BWD = "edgewise_lowrank_wide_fwd", "edgewise_lowrank_wide_bwd"
K4, K5 = "fused_multihop_attention", "fused_quartet_attention"
# The backward kernel of each forward kernel with one.
BWD = {"fused_edgewise_lowrank_attention": K2B, "fused_edgewise_dense_attention": K3B}
# Forward kernels that a train step does not run: as in the JAX package, the
# C/D variants train through the composed path. (The dense E head trains
# through K3 and K3b: phase 9 times both routes.)
EVAL_ONLY = {K4}
# Models whose eval forward phase 7b differentiates.
EVAL_GRAD = ("E", "E_dense", "D")
# The Quartet LM: mop_tpu's ComparisonConfig (gpt_comparison.py) at the
# vocab and batch of tools/bench_lm.py.
LM_CONFIG = dict(n_layer=8, n_head=8, n_embd=640, dropout=0.1, block_size=256)
LM_VOCAB, LM_BATCH = 8192, 64
# mop_tpu's parameter count of create_gpt_quartet at that config
# (tests/test_torch_quartet.py holds both mop_tpu's and the port's count to it).
LM_JAX_PARAMS = 51303696
# Phase 8b, the LM train path: examples/train_gpt_char.py's and
# tools/bench_lm.py's recipe (AdamW 3e-4, weight decay 0.1, dropout 0), the
# Quartet LM with the example's grad clip 1.0; GPT-MoP at tools/bench_lm.py's
# config, whose TransformerConfig keeps Quartet attention on, and
# mop_tpu's parameter count there (tests/test_torch_gpt_mop.py holds both
# packages' counts to it).
LM_LR, LM_WD, LM_CLIP = 3e-4, 0.1, 1.0
GPT_MOP_CONFIG = dict(n_layer=6, n_head=6, n_embd=384, dropout=0.0, block_size=256)
GPT_MOP_JAX_PARAMS = 15652230
# mop_tpu's counts of the comparison framework's three models at vocab 8192
# (tests/test_torch_gpt_mop.py holds the port's framework to them).
COMPARISON_JAX_PARAMS = {"baseline": 44750080, "quartet": 51303696, "mop": 44776184}
LM_STEPS = 20  # steps on one batch whose loss must fall
LM_WINDOWS, LM_WINDOW_STEPS = 3, 5  # timed windows of train steps, after one warm step
# The kernels' times before their redesign (K2 before it shared K3's
# kernels, K3 over the backward's recompute, K5 streaming the keys twice,
# K4 running the fp32 transport with all threads in turn), which phase 9
# restates beside its own: ms at the main-path shapes on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md's table); K4's by hops.
BEFORE_MS = {("K2", torch.float32): 0.9330, ("K2", torch.bfloat16): 0.4870,
             ("K3", torch.float32): 1.1589, ("K3", torch.bfloat16): 1.1635,
             ("K5", torch.float32): 1.7245, ("K5", torch.bfloat16): 2.2823,
             ("K4", torch.float32, 3): 0.4306, ("K4", torch.float32, 2): 0.3483,
             ("K4", torch.bfloat16, 3): 0.4217}
MULTIHOP_GATES = dict(base=0.9, and_=1.0, or_=0.5, not_=0.25, chain=0.75)
# K4's fp32 checks off the main shape, ((B, H), N, dk): N 1 (one float4 of
# padded columns), 33 and 40 (the second thread group owns 1 and 8 rows),
# dk 8, 100 (two column tiles, dk not a multiple of 8) and 128.
K4_OFF_SHAPES = (((2, 3), 1, 8), ((2, 3), 33, 100), ((2, 3), 40, 128))
# K2's and K3b's checks off the main shape, ((B, H), V, N, dk, r): two and
# eight views, N below 64 and odd, dk above 64 (two column tiles of every
# N x dk product) and not a multiple of 8.
K2_OFF_SHAPES = (((2, 2), 2, 16, 8, 1), ((2, 2), 3, 40, 100, 2), ((2, 3), 8, 33, 54, 2),
                 ((2, 2), 8, 40, 100, 4))
# K3's checks off the main shape, ((B, H), V, N, dk): two and eight views, N
# below 64 and odd, dk above 64 and not a multiple of 8, and the fp32
# kernel's maps A_i in its workspace (V 5 at dk 128, V 8 at dk 80).
K3_OFF_SHAPES = (((2, 2), 2, 16, 8), ((2, 2), 2, 40, 100), ((2, 3), 8, 33, 54),
                 ((2, 2), 8, 40, 128), ((2, 2), 5, 64, 128), ((2, 2), 8, 64, 80))
# The layers phase 7 runs at 224/16 images (196 tokens), E's, E_dense's and
# D's attention at their CIFAR widths, with the launches of an eval forward
# and of a train-mode gradient: E's lowrank op takes N <= 256 (K2w, K2bw);
# K3's and K4's N <= 64, so E_dense and D compose.
N_WIDE, BATCH_WIDE = 196, 32
WIDE_LAYERS = {
    "E": (224, lambda: EdgewiseMSA(224, 4, n_views=5, gate_mode="lowrank", gate_rank=4,
                                   gate_init="mix5"),
          {"edgewise_lowrank_wide_fwd": 1}, {"edgewise_lowrank_wide_fwd": 1,
                                             "edgewise_lowrank_wide_bwd": 1}),
    "E_dense": (224, lambda: EdgewiseMSA(224, 4, n_views=5, gate_mode="dense"), {}, {}),
    "D": (256, lambda: MultiHopMSA(256, 4, beta_not=0.5, hops=3), {}, {}),
}

# Phase 10: the ab5 harness's flags, and the configs and parameter counts the
# JAX matcher gives at the 5M target (tests/test_param_parity.py for A and B,
# the port's CPU test tests/test_torch_experiments_params.py for all five).
AB5_ARGS = ["--synthetic", "--tiny", "--seeds", "0", "--steps", "20", "--eval_every", "10",
            "--batch", str(BATCH), "--targets", "5000000", "--models", "A", "B", "C", "D",
            "E", "--ew_variants", "lowrank:neutral", "dense:neutral"]
AB5_TARGET = 5_000_000
AB5_MATCH = {"A": ((224, 8, 4), 4_872_000), "B": ((216, 8, 4), 4_534_044),
             "C": ((200, 8, 4), 4_849_232), "D": ((200, 8, 4), 4_849_208),
             "E": ((224, 4, 4), 4_870_084)}
# Kernel launches of one train step and of one eval forward of each run key.
AB5_LAUNCHES = {
    "A": ({"flash_attention": 8}, {"flash_attention": 8}),
    "B": ({"flash_attention": 8}, {"flash_attention": 8}),
    "C": ({}, {}),
    "D": ({}, {K4: 8}),  # D trains composed
    "E_lowrank_neutral": ({"fused_edgewise_lowrank_attention": 4, K2B: 4},
                          {"fused_edgewise_lowrank_attention": 4}),
    "E_dense_neutral": ({"fused_edgewise_dense_attention": 4, K3B: 4},
                        {"fused_edgewise_dense_attention": 4}),
}

# Phase 11, Whisper: tools/bench_lm.py's WHISPER (the README's "Whisper-MoP
# 20M" row, batch 8) and the reference width (WhisperConfig's defaults: 1024
# wide, 16 heads, 12 + 12 layers, 1500 frames, 448 tokens, vocab 51,865),
# with mop_tpu's eval_shape counts, baseline and MoP alike
# (tests/test_torch_whisper_comparison.py holds both packages' counts to them).
WHISPER_20M = dict(n_mels=80, n_audio_ctx=750, vocab_size=8192, n_text_ctx=112, n_embd=384,
                   n_head=6, n_layer_enc=4, n_layer_dec=4, dropout=0.0)
WHISPER_REF = {}
WHISPER_JAX_PARAMS = {"20M": 20041016, "reference": 407639720}
WHISPER_BATCH = {"20M": 8, "reference": 4}
WHISPER_LR, WHISPER_WD = 3e-4, 0.1  # tools/bench_lm.py's AdamW
WHISPER_STEPS = 20  # steps on one batch whose loss must fall
WHISPER_WINDOWS, WHISPER_WINDOW_STEPS = 3, 10  # timed windows, after a warm one
WHISPER_MAX_TOKENS = 32  # greedy transcription at the reference width
# The transcribing model's linear and conv kernels are scaled by this from
# their init, as tests/test_torch_whisper_decode.py scales its own, so that
# the greedy tokens vary along the sequence instead of repeating one token.
WHISPER_DECODE_SCALE = 3.0
# A cached step's logits, teacher-forced on the full window's tokens, against
# the full window's at that position: the limit as a share of the full
# window's largest logit, per KV dtype.
WHISPER_CACHED_LOGITS = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# tools/bench_whisper_dispatch.py's config, batch and text lengths.
DISPATCH = dict(n_mels=80, n_audio_ctx=256, vocab_size=512, n_embd=384, n_head=6,
                n_layer_enc=4, n_layer_dec=4, dropout=0.0)
DISPATCH_BATCH, DISPATCH_CTXS = 8, (32, 64, 128, 256, 512)
# K1 at the Whisper shapes, (q shape, k/v shape, causal): the 20M config's
# encoder, causal decoder and cross-attention, and the reference width's.
WHISPER_K1_SHAPES = (((8, 6, 750, 64), (8, 6, 750, 64), False),
                     ((8, 6, 112, 64), (8, 6, 112, 64), True),
                     ((8, 6, 112, 64), (8, 6, 750, 64), False),
                     ((4, 16, 1500, 64), (4, 16, 1500, 64), False),
                     ((4, 16, 448, 64), (4, 16, 448, 64), True),
                     ((4, 16, 448, 64), (4, 16, 1500, 64), False))
# K1's bf16 output against its plain version, element by element. The two
# round the output to bf16 (one unit in the last place is 2^-8 to 2^-7 of
# the value), and the kernel rounds its unnormalised probabilities against a
# running maximum where the plain version takes the row's: in rows with few
# live keys (causal) that moves the output by up to about 2.6e-3 beyond 1% of
# its value (the kernel's order replayed in fp32 over eight seeds at the
# Whisper and A shapes; measured on the H100, up to 3.9e-3 in all).
K1_BF16_ATOL, K1_BF16_RTOL = 5e-3, 1e-2

# Phase 12, MoE: ViT_MoP(use_moe=True) at bench.py's B width (B_bench, 224/6/4)
# on CIFAR-100, and the op at tools/bench_moe.py's shapes (bf16, T tokens of
# D -> H -> D, capacity factor 1.25).
MOE_EXPERTS = 4
MOE_STEPS = 20  # steps on one batch whose loss must fall
MOE_WINDOWS, MOE_WINDOW_STEPS = 3, 5
MOE_OP = dict(tokens=16384, dim=256, hidden=1024, cf=1.25)
MOE_OP_EXPERTS = (4, 8, 16)
# VOC: the CLI at its defaults (224/16, 256 wide, 6 deep, 4 heads, batch 64)
# on the synthetic tiny set, 2 epochs of 256 / 64 = 4 steps, an eval after each
# and one at the end (64 val images: one batch each).
VOC_ARGS = ["--synthetic", "--tiny", "--epochs", "2"]
VOC_STEPS, VOC_EVALS, VOC_DEPTH = 8, 3, 6
VOC_K1 = (64, 4, 196, 64)  # (B, H, N, dk) of A's and B's attention
# E's attention at the VOC defaults: lowrank head, 4 views, rank 4, dk 64 at
# N = 196, through K2w and its gradient through K2bw (fp32: the CLI trains in
# fp32), once a block a forward and a train step.
VOC_E = ((64, 4), 4, 196, 64, 4)  # ((B, H), V, N, dk, r)
# K2w / K2bw off VOC's shape: two views at rank 1, the JAX envelope's corner
# (8 views, N 256, dk 128), dk 54 (element copies), and three and five views,
# where both chains' backward steps write one map (the final step at V 3, a
# middle step at V 5) and run a launch a chain.
WIDE_OFF_SHAPES = (((2, 2), 2, 72, 8, 1), ((1, 2), 8, 256, 128, 1), ((2, 3), 3, 100, 54, 2),
                   ((1, 3), 5, 90, 32, 3))
# ImageNet: the CLI at the 50M target on the synthetic tiny set, with the
# configs and counts the JAX matcher gives (tests/test_torch_experiments_
# voc_imagenet.py holds the port's matcher to the JAX script's at narrowed
# grids). A and B compose (dk 160 and 158 > K1's 128); E (the CLI's dense gate)
# composes at N = 196, as the JAX module does above its dense kernel's 128.
# E's step at batch 256 does not fit in 80 GB (its out-of-memory at 76.28 GiB
# is in PERF.md), so E runs at 128: the one cut.
IMAGENET_ARGS = ["--synthetic", "--tiny", "--targets", "50000000", "--steps", "20", "--ema"]
IMAGENET_TARGET = 50_000_000
IMAGENET_MATCH = {"A": ((640, 10, 4), 49_859_840), "B": ((632, 10, 4), 48_633_884),
                  "E": ((504, 8, 4), 49_326_680)}
IMAGENET_E_BATCH = 128
IMAGENET_REMATS = ("none", "full", "dots", "dots_nb")
IMAGENET_WINDOWS, IMAGENET_WINDOW_STEPS = 3, 5

# Phase 13, decode: tools/bench_decode.py's GPT-Quartet (6 x 384, 6 heads,
# vocab 512, batch 8, a 16-token prompt, block 256, 240 new tokens), and
# tools/bench_speculative.py's 170M target (12 x 1024, 16 heads, block 512,
# batch 1) with its 2 x 128 draft (4 heads).
DECODE_SMALL = dict(n_layer=6, n_head=6, n_embd=384, dropout=0.0, block_size=256)
DECODE_VOCAB, DECODE_BATCH, DECODE_T0, DECODE_NEW = 512, 8, 16, 240
DECODE_170M = dict(n_layer=12, n_head=16, n_embd=1024, dropout=0.0, block_size=512)
DECODE_DRAFT = dict(n_layer=2, n_head=4, n_embd=128, dropout=0.0, block_size=512)
DECODE_170M_EXACT = 32  # tokens of the exact sampler at block 512
DECODE_170M_CACHED = 64  # tokens of the cached decoders
DECODE_GAMMA = 4
DECODE_TIE = 1e-4  # a top-two logit margin below this is a near tie
DECODE_WINDOW_CHUNK = 240  # full windows a teacher-forced forward takes at once
WHISPER_BEAMS, WHISPER_BEAM_TOKENS = 4, 32
# Phase 14, serving. tools/bench_serving.py:34-44's GPT-Quartet and its mixed_jobs (:47).
SERVE_CFG = dict(n_layer=6, n_head=8, n_embd=512, dropout=0.0, block_size=512)
SERVE_VOCAB = 512
SERVE_BUCKETS = [64, 128, 256, 512]
SERVE_MAX_BATCH = 8
SERVE_JOBS, SERVE_NEW, SERVE_PROMPTS = 32, 64, (48, 250)  # prompts of 48 to 249 tokens
SERVE_WARM = 64  # the warm-up prompts' length, and the beam request's
SERVE_SYSTEM, SERVE_TAILS, SERVE_PREFIX_NEW = 192, (16, 48), 32  # the prefix cache's
SERVE_CHUNK, SERVE_BURST = 64, 4
# tools/bench_serving_slo.py:45-61's 170M: 4 slots, 128-token prompts, 32 new.
SLO_CFG = dict(n_layer=12, n_head=16, n_embd=1024, dropout=0.0, block_size=2048)
SLO_MB, SLO_PROMPT, SLO_NEW, SLO_REQS = 4, 128, 32, 16
WHISPER_SERVE_CLIPS, WHISPER_SERVE_TOKENS, WHISPER_SERVE_MB = 8, 32, 4
SERVE_HTTP_ARGS = ["--steps", "100", "--clients", "8"]
# Phase 16. tools/bench_serving.py:149-161's paged pools (pages of 64 rows: 64,
# the dense slabs' capacity, and 32, half the memory) over 14a's engine and
# jobs; tools/bench_speculative.py's 170M target and 2 x 128 draft (:41, :64-65)
# at 16-token prompts; the exports' batches; the --spec demo.
PAGED_PAGES, PAGED_PS = (64, 32), 64
SPEC_MB, SPEC_REQS, SPEC_T0, SPEC_NEW, SPEC_GAMMA = 4, 16, 16, 32, 4
EXPORT_BATCHES = (1, 3, BATCH)
SPEC_HTTP_ARGS = ["--spec", "--steps", "50", "--clients", "4"]

failures = []
# Phase 15, the trainer and the later CLIs: train_model at bench.py:23-29's
# B (B_bench) on random uint8 CIFAR-shaped batches, a function of the step;
# a second run stops through its guard after TRAINER_STOP steps and resumes.
TRAINER_STEPS = 30
TRAINER_EVERY = 10  # eval_every and ckpt_every
TRAINER_STOP = 15
TRAINER_VAL = 2  # val batches of BATCH
TRAINER_TIMED = 20  # Trainer.step's timed steps, after 5 of warm-up
TRAINER_DATA_SEED = 1500
CLI15_STEPS = 5  # each CLI's steps (eval at steps 1 and 5)

# Each kernel's launches on the main paths, for the kernels line.
launches = {f.__name__: 0 for f in F.KERNELS}


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    say(f"  {'ok' if ok else 'FAIL'}: {what}")
    if not ok:
        failures.append(what)


def compare(name, got, ref, atol, rtol):
    """Max-abs error of got vs ref and whether it is within atol + rtol*|ref|."""
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    ok = bool(torch.isfinite(g).all()) and bool(torch.allclose(g, r, atol=atol, rtol=rtol))
    check(ok, f"{name}: max_abs_err {err:.3e} (atol {atol:g}, rtol {rtol:g})")
    return err


def compare_rel(name, got, ref, frac):
    """Max-abs error of got vs ref and whether it is within ``frac`` of ref's
    largest magnitude (for bf16, whose rounding points differ)."""
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    ok = bool(torch.isfinite(g).all()) and err <= frac * scale
    check(ok, f"{name}: max_abs_err {err:.3e} of max |ref| {scale:.3e} (limit {frac:g} of it)")
    return err


def time_ms(fn, iters=30, reps=5):
    """Median over reps of the mean time of one call, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def device_breakdown(fn, reps=5):
    """Device time by kernel name over ``reps`` calls of ``fn`` (torch.profiler),
    and the wall time of those calls, profiler overhead included."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    return rows, wall_us


def graph_ms(fn, calls=20):
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph and replayed, timed by CUDA events. It leaves out the host's
    launch path, which sets the time of a small kernel called back to back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, iters=5) / calls
    del graph
    return ms


def bound_ms(flops, nbytes, dtype, peak=None):
    """The larger of the flops over the dtype's peak rate (or ``peak``,
    where the kernel's route has its own) and the bytes over the memory
    rate, in ms, with which of the two it is."""
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_cost(bh, n, n_kv, dk, dtype):
    esize = torch.finfo(dtype).bits // 8
    return 4 * bh * n * n_kv * dk, esize * bh * dk * (2 * n + 2 * n_kv)


def _score_flops(nv, n, dk):
    """Flops of one edgewise program's score maps, both chains and the value
    transport: what either gate head adds to is the rest of the mix."""
    return (nv * 2 * n * n * dk            # S_i
            + 2 * (nv - 1) * 2 * n ** 3     # forward and backward chains
            + (nv - 1) * 2 * n * n * dk)    # value transport


def _edgewise_mix_flops(nv, n, dk, r):
    """Flops of one program of K2's forward up to the output products: the
    part that K2b recomputes."""
    c = 2 * nv + 2
    return (_score_flops(nv, n, dk)
            + 2 * 2 * n * c * 4 * r         # rank factors
            + 4 * 2 * n * n * r)            # gates


def _dense_mix_flops(nv, n, dk):
    """The same for K3 and K3b: the per-edge head's C -> 16 -> 4 products."""
    return _score_flops(nv, n, dk) + n * n * 2 * F.DENSE_HIDDEN * (2 * nv + 2 + 4)


def _output_flops(n, dk):
    return 2 * 2 * n * n * dk  # att v_0, A_0 transport


def _bwd_flops(nv, n, dk):
    """Backward products of one program that both gate heads share; dw =
    <Ac_0, dAc_0> / w is elementwise."""
    nd = 2 * n * n * dk  # one N x N by N x dk product
    return (4 * nd                           # dv_0, d att, dAc_0, dP_1
            + 2 * n * n                      # dw
            + (nv - 1) * 2 * nd              # dAc_i and dP_{i+1} down the transport
            + 2 * 2 * (nv - 1) * 2 * n ** 3  # both chains, two products per link
            + nv * 2 * nd)                   # dq_i, dk_i


def edgewise_cost(bh, nv, n, dk, r, dtype):
    esize = torch.finfo(dtype).bits // 8
    c = 2 * nv + 2
    nbytes = esize * bh * dk * n * (3 * nv + 1) + 4 * (2 * c * 4 * r + 2 * 4 * r + 1)
    return bh * (_edgewise_mix_flops(nv, n, dk, r) + _output_flops(n, dk)), nbytes


def edgewise_bwd_cost(bh, nv, n, dk, r, dtype):
    """K2b: the recompute up to the output products (y itself is never
    rebuilt), plus every product the backward needs. Bytes are the inputs,
    dy, the weights, and the grads (per-program weight grads) written."""
    esize = torch.finfo(dtype).bits // 8
    c = 2 * nv + 2
    gate_bwd = (4 * 2 * 2 * n * n * r          # da_c, db_c
                + 2 * 2 * 2 * n * c * 4 * r)    # dwrow, dwcol, d row_feat, d col_feat
    w_floats = 2 * c * 4 * r + 2 * 4 * r + 1
    nbytes = (esize * bh * dk * n * (6 * nv + 1) + 4 * w_floats + 4 * bh * w_floats)
    return bh * (_edgewise_mix_flops(nv, n, dk, r) + _bwd_flops(nv, n, dk) + gate_bwd), nbytes


def multihop_cost(bh, n, dk, hops, dtype):
    """K4: the two score maps, hops - 1 chain products (N^3 each) for
    C = A1 A2^(hops-1), the chain's value term and att v1; six inputs read
    and the output written once. In fp32 the casts are identities, so the
    chain's value term is the one product C v2. In bf16 it is the transport
    A1 (A2 (... v2)), hops products, whose recasts the result depends on."""
    esize = torch.finfo(dtype).bits // 8
    nd = 2 * n * n * dk
    value_chain = nd if dtype == torch.float32 else hops * nd
    flops = 2 * nd + (hops - 1) * 2 * n ** 3 + value_chain + nd
    return bh * flops, esize * bh * n * dk * 7 + 4


def quartet_cost(bh, n, dk, dtype):
    """K5: both full score maps (every column enters the statistics) and
    the causal half of P V (row i has i + 1 live keys); five inputs read and
    the output written once."""
    esize = torch.finfo(dtype).bits // 8
    return bh * (2 * 2 * n * n * dk + 2 * dk * n * (n + 1) // 2), esize * bh * n * dk * 6 + 8


def _dense_w_floats(nv):
    hd = F.DENSE_HIDDEN
    return (2 * nv + 2) * hd + hd + hd * 4 + 4 + 1  # w1, b1, w2, b2, chain_w


def edgewise_dense_cost(bh, nv, n, dk, dtype):
    """K3: its products, the per-edge head included; inputs read and the
    output written once."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * bh * dk * n * (3 * nv + 1) + 4 * _dense_w_floats(nv)
    return bh * (_dense_mix_flops(nv, n, dk) + _output_flops(n, dk)), nbytes


def edgewise_dense_bwd_cost(bh, nv, n, dk, dtype):
    """K3b: the recompute up to the output products, the shared backward
    products, and the head's backward per edge (dhid = w2 dz, dw2, dw1 and
    dfeat = w1 dpre); counted as edgewise_bwd_cost."""
    esize = torch.finfo(dtype).bits // 8
    head_bwd = n * n * 2 * F.DENSE_HIDDEN * (2 * (2 * nv + 2) + 8)
    w_floats = _dense_w_floats(nv)
    nbytes = (esize * bh * dk * n * (6 * nv + 1) + 4 * w_floats + 4 * bh * w_floats)
    return bh * (_dense_mix_flops(nv, n, dk) + _bwd_flops(nv, n, dk) + head_bwd), nbytes


@contextlib.contextmanager
def plain_kernels():
    """Route the models through the kernels' plain versions (the reference)."""
    names = ("flash_attention", "fused_edgewise_lowrank_attention",
             "fused_edgewise_dense_attention", K4, K5)
    saved = [getattr(F, n) for n in names]
    for n in names:
        setattr(F, n, getattr(F, n + "_plain"))
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(F, n, f)


@contextlib.contextmanager
def composed(fits):
    """Route the modules that ask the predicate ``F.<fits>`` through their
    composed path, as where the kernels do not take the shape: the other
    train route of the dense E head (``edgewise_dense_fits``: K3 and K3b),
    which has no kernel switch of its own."""
    saved = getattr(F, fits)
    setattr(F, fits, lambda *a: False)
    try:
        yield
    finally:
        setattr(F, fits, saved)


# Kernel classes of a device-time breakdown, by a substring of the name.
KERNEL_CLASSES = (("K5", ("quartet",)), ("K1", ("flash_fwd",)), ("convs", ("conv",)),
                  ("GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("elementwise", ("elementwise",)), ("LayerNorm", ("layer_norm",)),
                  ("reductions and softmax", ("reduce", "softmax")),
                  ("AdamW", ("multi_tensor",)))


def by_class(rows):
    """Device-time shares of the kernel classes, largest first, as text."""
    total = sum(t for _, t in rows)
    shares = {}
    for name, t in rows:
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name.lower() for k in keys)),
                   "other")
        shares[cls] = shares.get(cls, 0.0) + t
    return ", ".join(f"{c} {100 * t / total:.1f}%"
                     for c, t in sorted(shares.items(), key=lambda kv: -kv[1]))


def timed_windows(run, windows, runs_per_window, items_per_run):
    """ms per run, items/s over all the time and each window's items/s of
    ``windows`` timed windows of ``runs_per_window`` calls of ``run``, after
    a warm one."""
    run()
    torch.cuda.synchronize()
    dts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(runs_per_window):
            run()
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    n = windows * runs_per_window
    return (sum(dts) / n * 1e3, items_per_run * n / sum(dts),
            [items_per_run * runs_per_window / t for t in dts])


def train_windows(scanned, xk, yk, gen):
    """ms per step, images/s and the per-window rates of TRAIN_WINDOWS timed
    scanned calls after a warm one."""
    ms, rate, per = timed_windows(lambda: scanned(xk, yk, gen), TRAIN_WINDOWS, 1,
                                  BATCH * TRAIN_K)
    return ms / TRAIN_K, rate, per


def wrapper_launches():
    """Every kernel wrapper's launch count."""
    return {f.__name__: f.launches for f in F.KERNELS}


def counted(fn, add=True):
    """``fn()`` and every kernel's launches in it, the counts set to 0 just
    before; with ``add``, the counts are added to ``launches``."""
    F.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = wrapper_launches()
    if add:
        for k_name, c in counts.items():
            launches[k_name] += c
    return out, counts


def launched(counts):
    """The kernels of a launch count that ran, for printing."""
    return {k: n for k, n in counts.items() if n}


def cuda_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def profiled_records(fn, names, make_profiler=cuda_profile, tries=3, setup=None,
                     count=wrapper_launches):
    """``fn()`` under ``make_profiler()``, and its kernel records held to the
    launches: ``names`` is {counter name: a substring of its kernels'
    names}, ``count()`` reads the counters (the wrappers' by default). A
    profile that kept fewer records of a name than its launches is taken
    again, up to ``tries`` profiles: late in the whole script a profile could
    miss its first 16 kernel records, three profiles in a row (on the H100,
    not in a phase alone). So each profile opens with 64 small kernels of
    its own and ``fn`` runs between idle spans, longer on each try.
    ``setup()``, where given, returns the call to profile on each try (state
    that one run uses up, as an engine's queue). Returns (records by name,
    every counter's launches, the profiler)."""
    lead = torch.zeros(1, device="cuda")
    for t in range(tries):
        pad_s = 0.05 * 4 ** t
        run = setup() if setup is not None else fn
        torch.cuda.synchronize()
        with make_profiler() as prof:
            for _ in range(64):
                lead.add_(1)
            torch.cuda.synchronize()
            time.sleep(pad_s)
            n0 = count()
            run()
            torch.cuda.synchronize()
            counts = {k: c - n0[k] for k, c in count().items()}
            time.sleep(pad_s)
        records = {n: sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name)
                   for n, key in names.items()}
        if all(records[n] >= counts[n] for n in names):
            break
    return records, counts, prof


def cuda_generator(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def one_step_grads(model, x_u8, y):
    """fp32 grads of one train step (augment off, fp32 compute), params kept."""
    step = make_classifier_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                      CIFAR100_MEAN, CIFAR100_STD, augment=False,
                                      compute_dtype=None)
    step(x_u8, y)
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def lm_step_grads(model, idx, tgt):
    """fp32 grads of one LM train step (fp32 compute), params kept."""
    make_lm_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                       compute_dtype=None)(idx, tgt)
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def lm_step_loss(model, idx, tgt):
    """The loss of one bf16 LM train step, params kept."""
    return make_lm_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))(
        idx, tgt)["loss"]


def worst_rel(got, want):
    """The worst max-abs error over tensors, each of its reference's largest
    magnitude."""
    return max((got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-30)
               for k in want)


def edgewise_inputs(g, bh_shape, nv, n, dk, r, dtype):
    def rn(*s):
        return torch.randn(*s, device="cuda", generator=g)
    c = 2 * nv + 2
    qs, ks, vs = (rn(*bh_shape, nv, n, dk).to(dtype) for _ in range(3))
    return (qs, ks, vs, rn(c, 4 * r) * 0.3, torch.linspace(-0.5, 0.5, 4 * r, device="cuda"),
            rn(c, 4 * r) * 0.3, torch.linspace(0.5, -0.5, 4 * r, device="cuda"), 0.5,
            torch.tensor(0.4, device="cuda"))


def dense_inputs(g, bh_shape, nv, n, dk, dtype):
    def rn(*s):
        return torch.randn(*s, device="cuda", generator=g)
    qs, ks, vs = (rn(*bh_shape, nv, n, dk).to(dtype) for _ in range(3))
    return (qs, ks, vs, rn(2 * nv + 2, F.DENSE_HIDDEN) * 0.3,
            torch.linspace(-0.5, 0.5, F.DENSE_HIDDEN, device="cuda"),
            rn(F.DENSE_HIDDEN, 4) * 0.5, torch.tensor([-1.0, 0.5, -0.5, 1.0], device="cuda"),
            0.5, torch.tensor(0.4, device="cuda"))


def _kernel_label(mangled: str) -> str:
    """A short name for a mangled kernel: its name and the template arguments
    that tell the instantiations apart."""
    m = re.match(r"_ZN3mop(\d+)", mangled)
    if not m:
        return mangled[:40]
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    if name == "wide":  # K2w / K2bw: mop::wide::<kernel><template arguments>
        k = re.match(r"(\d+)", rest)
        kname, rest = rest[k.end():k.end() + int(k.group(1))], rest[k.end() + int(k.group(1)):]
        args = rest[1:rest.find("Ev")] if rest.startswith("I") else ""
        # bf16 is the only type substituted (S<n>_) after its first mention
        toks = re.findall(r"Lb([01])E|Li(\d+)E|(13__nv_bfloat16|S\d*_)|(f)", args)
        tags = [b or i or ("bf16" if h else "f32") for b, i, h, _ in toks]
        return f"wide::{kname}<{','.join(tags)}>" if tags else f"wide::{kname}"
    tags = [t for t, key in (("float", "If"), ("bf16", "I13__nv_bfloat16"),
                             ("lowrank", "LowrankGate"), ("dense", "DenseGate"))
            if (rest.startswith(key) if key.startswith("I") else key in rest.split("Ev")[0])]
    return f"{name}<{','.join(tags)}>" if tags else name


def ptxas_report(log: str):
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas=-v`` output."""
    out, label, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            label = _kernel_label(m.group(1))
        elif "spill stores" in ln:
            spill = ", ".join(x.strip() for x in ln.split(",")[1:])
        else:
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out.append(f"{label} {m.group(1)} registers, {spill}")
    return out


def check_byte_counts():
    """The shared-memory and workspace bytes the Python wrappers size their
    checks and allocations by (and the modules route by), against the
    kernels' own counts."""
    import ctypes

    i_ = ctypes.c_int
    flash = F._fn("flash_fwd", "mop_flash_smem_bytes", [i_, i_], ctypes.c_longlong)
    k2 = F._fn("edgewise_lowrank_fwd", "mop_edgewise_lowrank_smem_bytes", [i_] * 5,
               ctypes.c_longlong)
    k3 = F._fn("edgewise_dense_fwd", "mop_edgewise_dense_smem_bytes", [i_] * 4,
               ctypes.c_longlong)
    k3_ws = F._fn("edgewise_dense_fwd", "mop_edgewise_dense_ws_bytes", [i_] * 4,
                  ctypes.c_longlong)
    k4 = F._fn("multihop_fwd", "mop_multihop_smem_bytes", [i_] * 3, ctypes.c_longlong)
    k5 = F._fn("quartet_fwd", "mop_quartet_smem_bytes", [i_] * 3, ctypes.c_longlong)
    k5_rows = F._fn("quartet_fwd", "mop_quartet_keeps_rows", [i_] * 3)
    smem = F._fn("edgewise_bwd", "mop_edgewise_bwd_smem_bytes", [i_] * 6, ctypes.c_longlong)
    ws = F._fn("edgewise_bwd", "mop_edgewise_bwd_ws_bytes", [i_] * 4, ctypes.c_longlong)
    wide_ws = F._fn("edgewise_wide", "mop_edgewise_wide_ws_bytes", [i_] * 5, ctypes.c_longlong)
    bad = []
    for (_, nv, n, dk, r) in (VOC_E, *WIDE_OFF_SHAPES):
        for bwd in (False, True):
            if F.edgewise_wide_ws_bytes(nv, n, dk, r, bwd) != wide_ws(nv, n, dk, r, int(bwd)):
                bad.append(("K2w ws", nv, n, dk, r, bwd))
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for dk in (1, 54, 56, 80, 128):
            if F.flash_smem_bytes(dtype, dk) != flash(code, dk):
                bad.append(("K1", dtype, dk))
        for nv, n, dk, r in ((5, 64, 56, 4), (2, 16, 8, 1), (3, 40, 100, 2), (8, 64, 128, 4),
                             (2, 1, 1, 1), (4, 33, 54, 2), (8, 40, 100, 4), (5, 64, 128, 1),
                             (8, 64, 80, 1), (6, 64, 100, 1)):
            if F.edgewise_lowrank_smem_bytes(dtype, nv, n, dk, r) != k2(code, nv, n, dk, r):
                bad.append(("K2", dtype, nv, n, dk, r))
            for dense in (False, True):
                if F.edgewise_bwd_smem_bytes(dtype, nv, n, dk, r, dense) != smem(
                        code, nv, n, dk, r, int(dense)):
                    bad.append(("smem", dtype, nv, n, dk, r, dense))
            if F.edgewise_bwd_ws_bytes(dtype, nv, n, dk) != ws(code, nv, n, dk):
                bad.append(("ws", dtype, nv, n, dk))
            if F.edgewise_dense_smem_bytes(dtype, nv, n, dk) != k3(code, nv, n, dk):
                bad.append(("K3", dtype, nv, n, dk))
            if F.edgewise_dense_ws_bytes(dtype, nv, n, dk) != k3_ws(code, nv, n, dk):
                bad.append(("K3 ws", dtype, nv, n, dk))
        # K4 over its whole envelope (N <= 64, dk <= 128).
        for n in range(1, F.MULTIHOP_MAX_N + 1):
            for dk in range(1, F.MULTIHOP_MAX_DK + 1):
                if F.multihop_smem_bytes(dtype, n, dk) != k4(code, n, dk):
                    bad.append(("K4", dtype, n, dk))
        # K5 on both sides of where it keeps its score rows (fp32 N 256 | 257
        # at dk 80 and 128 | 129 at dk 128, bf16 768 | 769 at dk 80).
        for n in (1, 100, 128, 129, 256, 257, 512, 768, 769, 2048):
            for dk in (54, 80, 128):
                if F.quartet_smem_bytes(dtype, n, dk) != k5(code, n, dk):
                    bad.append(("K5", dtype, n, dk))
                if F.quartet_keeps_rows(dtype, n, dk) != bool(k5_rows(code, n, dk)):
                    bad.append(("K5 rows", dtype, n, dk))
    check(not bad, f"Python byte counts equal the kernels' own {bad}")


@contextlib.contextmanager
def recorded_lockstep():
    """Records each ``lockstep_train`` call's runs, history and wall time (the
    harness calls it through its module)."""
    calls = []
    lockstep = harness.lockstep_train

    def recording(runs, *a, **kw):
        t0 = time.time()
        hist = lockstep(runs, *a, **kw)
        torch.cuda.synchronize()
        calls.append((runs, hist, time.time() - t0))
        return hist

    harness.lockstep_train = recording
    try:
        yield calls
    finally:
        harness.lockstep_train = lockstep


def harness_phases(smi, out):
    """Phases 10 and 10b: the experiment harness through its entry points.
    The ab5 run writes its files into ``out`` (phase 15b aggregates them).
    Returns the kernel launches of the ab5 run."""
    say(f"[10 ab5 harness] cifar100_ab5_param_budgets.run({' '.join(AB5_ARGS)})")
    train_iter, val_batches, test_batches, *_ = harness.get_loaders("cifar100", BATCH, tiny=True,
                                                           synthetic=True)
    n_val, n_test = len(list(val_batches())), len(list(test_batches()))
    steps, n_evals = 20, 3  # evals at steps 1, 10 and 20
    # Eval forwards a run makes: the lockstep evals and the final one on the
    # val set, then the test set twice (accuracy, then McNemar's per sample).
    eval_fwds = (n_evals + 1) * n_val + 2 * n_test
    want = {f.__name__: 0 for f in F.KERNELS}
    for per_step, per_fwd in AB5_LAUNCHES.values():
        for k, n in per_step.items():
            want[k] += steps * n
        for k, n in per_fwd.items():
            want[k] += eval_fwds * n
    with recorded_lockstep() as calls:
        args = ab5.build_argparser().parse_args(AB5_ARGS + ["--out", out])
        harness._ESTIMATE_CACHE.clear()
        t0 = time.time()
        ab5.match_configs(args, AB5_TARGET)  # the run below finds it memoized
        match_s = time.time() - t0
        F.reset_launch_counts()
        t0 = time.time()
        res = ab5.run(args)[AB5_TARGET]
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {f.__name__: f.launches for f in F.KERNELS}
        for key, ((dim, depth, heads), n_params) in AB5_MATCH.items():
            cfg, p = res["configs"][key]
            got = (cfg["dim"], cfg["depth"], cfg["heads"])
            extra = ""
            if key == "E":
                got += (cfg["_ew_views"], cfg["_ew_mlp_ratio"], cfg["_ew_use_k3"])
                extra = " views 5, mlp 4.0, no use_k3"
            check(got == ((dim, depth, heads) + ((5, 4.0, False) if key == "E" else ()))
                  and p == n_params,
                  f"{key}: matched config {got}, {p:,} params; the JAX matcher's "
                  f"{dim}/{depth}/{heads}{extra}, {n_params:,} params [{smi}]")
        for key, n_params in res["params"].items():
            hist = res["hist"][key]
            losses = hist["loss"]
            check(hist["steps"] == [1, 10, 20] and all(math.isfinite(v) for v in losses)
                  and losses[-1] < losses[0],
                  f"{key}: {n_params:,} params; loss at steps {hist['steps']}: "
                  f"{', '.join(f'{v:.4f}' for v in losses)}; val acc "
                  f"{', '.join(f'{a:.3f}' for a in hist['acc'])}; test acc "
                  f"{res['test_acc'][key]:.4f} [{smi}]")
        keys = list(res["params"])
        prefix = os.path.join(out, f"cifar100_ab5_target_{AB5_TARGET}")
        headers = {".csv": "seed," + ",".join(f"acc_{k}" for k in keys),
                   "_test.csv": "model,test_acc", "_val_summary.csv": "model,mean_val,std_val"}
        for suffix, header in headers.items():
            path = prefix + suffix
            first = open(path).readline().strip() if os.path.exists(path) else None
            check(first == header, f"{os.path.basename(path)}: header {first!r}")
        with open(prefix + "_summary.json") as f:
            summary = json.load(f)
        check(sorted(summary["vs_A"]) == sorted(k for k in keys if k != "A")
              and summary["params"] == res["params"],
              f"{os.path.basename(prefix)}_summary.json: vs_A for {sorted(summary['vs_A'])}")
    check(counts == want, f"ab5 run launches {launched(counts)} ({steps} steps, {eval_fwds} "
          f"eval forwards a run; expected {launched(want)}) [{smi}]")
    runs, _, loop_s = calls[0]
    say(f"  ab5 at the {AB5_TARGET:,} target, {len(keys)} models, batch {BATCH}: matcher "
        f"{match_s:.2f} s (host); run() {wall:.2f} s wall, of it the lockstep loop "
        f"{loop_s:.2f} s ({steps} steps of all {len(keys)} models and {n_evals} val evals: "
        f"{1e3 * loop_s / steps:.1f} ms a lockstep step, evals included), the rest (data, "
        f"models, the final val and test evals, files) {wall - loop_s:.2f} s [{smi}]")

    # D's K4 at the run's shape, end to end: the trained D's logits on one val
    # batch through K4 and with the kernel switch off (composed).
    x_u8, y_val, _ = next(iter(val_batches()))
    d_model = runs["D"].model.eval()
    with torch.inference_mode():
        x = cifar_eval_transform(torch.as_tensor(x_u8).cuda(), CIFAR100_MEAN, CIFAR100_STD)
        F.reset_launch_counts()
        logits = d_model(x)
        k4_on = F.fused_multihop_attention.launches
        kernel_switches.fused_multihop = False
        try:
            ref = d_model(x)
        finally:
            kernel_switches.fused_multihop = True
        k4_off = F.fused_multihop_attention.launches - k4_on
    check(k4_on == 8 and k4_off == 0, f"ab5's D on a val batch: K4 launches {k4_on} with "
          f"fused_multihop on, {k4_off} with it off")
    compare(f"ab5's D after training: logits of {len(y_val)} val images through K4 vs "
            f"fused_multihop off", logits, ref, 2e-5, 2e-4)

    # The device's busy share in the lockstep loop: 10 more lockstep steps of
    # the run's models (evals at steps 1 and 10) under torch.profiler.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        harness.lockstep_train(runs, train_iter(0), val_batches, 10, 10, log=lambda *_: None)
        torch.cuda.synchronize()
        loop_s = time.time() - t0
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    say(f"  ab5 lockstep loop, 10 steps under torch.profiler: {loop_s:.2f} s wall, device busy "
        f"{100 * busy_s / loop_s:.1f}% [{smi}]")
    del runs, d_model

    say("[10b single-model CLI] cifar100_multihop_gates at its default width, 10 steps")
    with tempfile.TemporaryDirectory() as out, recorded_lockstep() as calls:
        F.reset_launch_counts()
        t0 = time.time()
        accs = cifar100_multihop_gates.main(["--synthetic", "--tiny", "--seeds", "0",
                                             "--steps", "10", "--eval_every", "5",
                                             "--out", out])
        torch.cuda.synchronize()
        wall = time.time() - t0
        cli_counts = {f.__name__: f.launches for f in F.KERNELS}
        with open(os.path.join(out, "cifar100_multihop_gates.csv")) as f:
            lines = f.read().split()
    hist = calls[0][1]["m"]
    check(len(accs) == 1 and lines == ["seed,acc", f"0,{accs[0]:.4f}"]
          and all(math.isfinite(v) for v in hist["loss"]),
          f"cifar100_multihop_gates: loss at steps {hist['steps']}: "
          f"{', '.join(f'{v:.4f}' for v in hist['loss'])}; csv {lines}; launches "
          f"{launched(cli_counts)}; {wall:.2f} s wall, lockstep loop {calls[0][2]:.2f} s "
          f"[{smi}]")
    return counts


def whisper_batch(cfg: WhisperConfig, batch: int, t_text: int):
    """tools/bench_lm.py's Whisper batch on the card: a RandomState(0) mel,
    random ids and the targets they roll to."""
    rs = np.random.RandomState(0)
    mel = rs.randn(batch, cfg.n_audio_ctx, cfg.n_mels).astype(np.float32)
    ids = rs.randint(0, cfg.vocab_size, (batch, t_text)).astype(np.int64)
    return (torch.from_numpy(mel).cuda(), torch.from_numpy(ids).cuda(),
            torch.from_numpy(np.roll(ids, -1, axis=-1)).cuda())


def whisper_forward(model, mel, ids, tgt, dtype):
    """(logits, loss) of one forward with the float params cast to ``dtype``
    (a differentiable cast: the grads reach the fp32 params in fp32), as
    tools/bench_lm.py's loss_fn; fp32 with ``dtype`` None."""
    if dtype is None:
        return model(mel, ids, targets=tgt)[:2]
    params = cast_floats(dict(model.named_parameters()), dtype)
    return torch.func.functional_call(model, params, (mel.to(dtype), ids),
                                      {"targets": tgt})[:2]


def whisper_loss(model, mel, ids, tgt, dtype):
    return whisper_forward(model, mel, ids, tgt, dtype)[1]


def whisper_step(model, opt, mel, ids, tgt, dtype=torch.bfloat16):
    """tools/bench_lm.py's Whisper train step: bf16 forward and backward,
    fp32 grads, the optimizer's update. Returns the loss."""
    def step():
        opt.zero_grad(set_to_none=True)
        loss = whisper_loss(model, mel, ids, tgt, dtype)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def whisper_phases(smi):
    """Phase 11: the Whisper family on the card. One 20M train step (12 K1
    launches) and one reference-width forward (36) add to the kernels line."""
    only_k1 = {f.__name__: 0 for f in F.KERNELS}
    cfgs = {"20M": WhisperConfig(**WHISPER_20M), "reference": WhisperConfig(**WHISPER_REF)}
    for width, cfg in cfgs.items():
        say(f"[11 Whisper] {width}: {cfg}")
        with torch.device("meta"):
            n = {kind: sum(p.numel() for p in fac(cfg, device="meta").parameters())
                 for kind, fac in (("mop", create_whisper_mop),
                                   ("baseline", create_whisper_baseline))}
        check(n["mop"] == n["baseline"] == WHISPER_JAX_PARAMS[width],
              f"Whisper {width}: params {n}; mop_tpu's count {WHISPER_JAX_PARAMS[width]}")

    def k1_per(n):
        return {**only_k1, "flash_attention": n}

    # 11.2: one fp32 eval forward with targets at each width against the plain path.
    models = {}
    for seed, (width, cfg) in enumerate(cfgs.items()):
        t_text = cfg.n_text_ctx
        b = WHISPER_BATCH[width]
        per_fwd = cfg.n_layer_enc + 2 * cfg.n_layer_dec
        t0 = time.time()
        model = create_whisper_mop(cfg, generator=torch.Generator().manual_seed(30 + seed)).eval()
        build_s = time.time() - t0
        mel, ids, tgt = whisper_batch(cfg, b, t_text)
        with torch.inference_mode():
            (logits, loss, gates), counts = counted(lambda: model(mel, ids, targets=tgt),
                                                    add=width == "reference")
            with plain_kernels():
                ref_logits, ref_loss, ref_gates = model(mel, ids, targets=tgt)
            check(counts == k1_per(per_fwd) and tuple(logits.shape) == (b, t_text, cfg.vocab_size)
                  and tuple(gates.shape) == (b, cfg.n_layer_enc, cfg.n_audio_ctx),
                  f"Whisper {width} fp32 eval forward with targets, {b} x {cfg.n_audio_ctx} "
                  f"frames x {t_text} tokens (built in {build_s:.1f} s): launches "
                  f"{launched(counts)} (K1 {cfg.n_layer_enc} encoder, {cfg.n_layer_dec} causal, "
                  f"{cfg.n_layer_dec} cross)")
            compare(f"Whisper {width}: logits kernel path vs plain path", logits, ref_logits,
                    2e-5, 2e-4)
            compare(f"Whisper {width}: loss {loss.item():.6f} kernel path vs plain path", loss,
                    ref_loss, 2e-5, 2e-4)
            compare(f"Whisper {width}: gates kernel path vs plain path", gates, ref_gates,
                    2e-5, 2e-4)
            ms = time_ms(lambda: model(mel, ids, targets=tgt), iters=2, reps=3)
            say(f"  Whisper {width} fp32 eval forward: {ms:.3f} ms, "
                f"{b * cfg.n_audio_ctx / ms * 1e3:.0f} audio frames/s [{smi}]")
        del logits, ref_logits, gates, ref_gates
        models[width] = model

    # 11.3: the 20M train step, tools/bench_lm.py's recipe.
    cfg, model = cfgs["20M"], models.pop("20M").train()
    b = WHISPER_BATCH["20M"]
    mel, ids, tgt = whisper_batch(cfg, b, cfg.n_text_ctx)
    params = list(model.parameters())
    say(f"  Whisper 20M train step, batch {b} x {cfg.n_audio_ctx} frames x {cfg.n_text_ctx} "
        f"tokens, bf16 compute, AdamW {WHISPER_LR} / {WHISPER_WD}")

    def grads():
        return torch.autograd.grad(whisper_loss(model, mel, ids, tgt, None), params)

    got = grads()
    with plain_kernels():
        want = grads()
    worst = max((a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for a, w in zip(got, want))
    check(worst <= 1e-3 and all(bool(torch.isfinite(t).all()) for t in got),
          f"Whisper 20M: one step's fp32 grads, kernel path vs plain path over {len(got)} "
          f"tensors: worst max-abs error {worst:.2e} of the tensor's largest grad (limit 1e-3)")
    del got, want
    with torch.no_grad():
        logits, loss = whisper_forward(model, mel, ids, tgt, torch.bfloat16)
        with plain_kernels():
            ref_logits, ref = whisper_forward(model, mel, ids, tgt, torch.bfloat16)
            fp32_logits = whisper_forward(model, mel, ids, tgt, None)[0]
    compare(f"Whisper 20M: one bf16 step's loss {loss.item():.6f}, kernel path vs plain path",
            loss, ref, 0.0, 1e-3)
    # The kernel path's bf16 logits may differ from the plain path's by as
    # much as bf16 rounding moves them: at most twice the plain path's own
    # difference from its fp32 logits.
    rounding = (ref_logits.float() - fp32_logits).abs().max().item()
    err = (logits.float() - ref_logits.float()).abs().max().item()
    check(bool(torch.isfinite(logits).all()) and err <= 2 * rounding,
          f"Whisper 20M: one bf16 step's logits, kernel path vs plain path: max_abs_err "
          f"{err:.3e} (limit twice the plain path's bf16 against fp32, {rounding:.3e})")
    del logits, ref_logits, fp32_logits
    opt = torch.optim.AdamW(params, lr=WHISPER_LR, weight_decay=WHISPER_WD)
    step = whisper_step(model, opt, mel, ids, tgt)
    first, counts = counted(step)
    check(counts == k1_per(cfg.n_layer_enc + 2 * cfg.n_layer_dec),
          f"Whisper 20M: launches per train step {launched(counts)} (K1 only; its backward "
          "recomputes with plain ops)")
    losses = [first.item()] + [step().item() for _ in range(WHISPER_STEPS - 1)]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"Whisper 20M: loss over {WHISPER_STEPS} steps on one batch {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, rate, per = timed_windows(step, WHISPER_WINDOWS, WHISPER_WINDOW_STEPS,
                                  b * cfg.n_audio_ctx)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  Whisper 20M train step ({WHISPER_WINDOWS} windows of {WHISPER_WINDOW_STEPS} steps): "
        f"{ms:.3f} ms/step, {rate:.0f} audio frames/s [per window "
        f"{', '.join(f'{r:.0f}' for r in per)}], peak {peak:.2f} GiB [{smi}]")
    rows, wall_us = device_breakdown(step, reps=2)
    busy = sum(t for _, t in rows)
    top = "; ".join(f"{k[:80]} {100 * t / busy:.1f}%" for k, t in rows[:8])
    say(f"    device busy {100 * busy / wall_us:.1f}% of {wall_us / 1e3:.2f} ms (2 steps, "
        f"profiled); by class: {by_class(rows)}; by kernel: {top}")
    # One encoder layer's MoP2D gate over the mel at this shape, forward and
    # backward to its weights, in both dtypes (its 5 x 5 conv is the step's
    # conv share, PERF.md section 5).
    times = []
    for dtype in (torch.bfloat16, torch.float32):
        mop = model.encoder[0].mop
        wrt = [p.to(dtype) for p in mop.parameters()]
        names = [n for n, _ in mop.named_parameters()]
        x1 = mel[:, None].to(dtype)

        def fwd_bwd():
            out = torch.func.functional_call(mop, dict(zip(names, wrt)), (x1,))[0]
            return torch.autograd.grad(out.float().sum(), wrt)

        times.append(f"{dtype} {time_ms(fwd_bwd, iters=10, reps=3):.3f} ms")
    say(f"  MoP2D gate of one encoder layer on the ({b}, 1, {cfg.n_audio_ctx}, {cfg.n_mels}) mel, "
        f"forward + backward: {'; '.join(times)} [{smi}]")
    del model, opt, step, params, wrt, x1

    # 11.4: two bf16 train steps at the reference width.
    cfg, model = cfgs["reference"], models["reference"].train()
    b = WHISPER_BATCH["reference"]
    mel, ids, tgt = whisper_batch(cfg, b, cfg.n_text_ctx)
    opt = torch.optim.AdamW(model.parameters(), lr=WHISPER_LR, weight_decay=WHISPER_WD)
    step = whisper_step(model, opt, mel, ids, tgt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    steps = [counted(step, add=False) for _ in range(2)]
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = cfg.n_layer_enc + 2 * cfg.n_layer_dec
    check(all(c == k1_per(per_step) and math.isfinite(v.item()) for v, c in steps),
          f"Whisper reference width: two bf16 train steps, batch {b}: losses "
          f"{', '.join(f'{v.item():.4f}' for v, _ in steps)}, launches a step "
          f"{[launched(c) for _, c in steps]}, {wall:.2f} s for both (the first warms), "
          f"peak {peak:.2f} GiB [{smi}]")
    del models, model, opt, step, steps

    # 11.5: greedy transcription at the reference width, 4 clips, by a fresh
    # model (the two steps above teach it to repeat a few tokens) whose
    # kernels are scaled so that the tokens vary.
    model = create_whisper_mop(cfg, generator=torch.Generator().manual_seed(34)).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                m.weight.mul_(WHISPER_DECODE_SCALE)
    n = WHISPER_MAX_TOKENS
    mel = whisper_batch(cfg, b, 1)[0]
    full, counts = counted(lambda: whisper_transcribe(model, mel, 1, n), add=False)
    distinct = [len(set(row.tolist())) for row in full]
    check(counts == k1_per(cfg.n_layer_enc + n * 2 * cfg.n_layer_dec) and min(distinct) >= 4,
          f"whisper_transcribe (full window), kernels x {WHISPER_DECODE_SCALE}: distinct tokens "
          f"per clip {distinct} of {n}; launches {launched(counts)}: {cfg.n_layer_enc} "
          f"encoder, then {2 * cfg.n_layer_dec} a step for {n} steps")
    ids = torch.cat([torch.ones_like(full[:, :1]), full], 1)
    with torch.no_grad():
        full_logits = model.decode(model.encode(mel)[0], ids)[:, :n].float()
        top2 = full_logits.topk(2, -1).values
        margin = top2[..., 0] - top2[..., 1]
    for kv_dtype in (torch.float32, torch.bfloat16):
        # Each cached step teacher-forced on the full window's tokens: its
        # logits against the full window's at that position, and its greedy
        # token. The cached route must give the full window's tokens up to
        # the first step whose teacher-forced token differs (a near tie that
        # the KV dtype's rounding flips), and that step's token there.
        with torch.no_grad():
            cross_k, cross_v = whisper_decode_prep(model, mel, kv_dtype)
            shape = (cfg.n_layer_dec, b, cfg.n_head, n + 1, cfg.n_embd // cfg.n_head)
            ks = torch.zeros(shape, dtype=kv_dtype, device=mel.device)
            vs = torch.zeros_like(ks)
            forced = []
            for i in range(n):
                step_logits, ks, vs = whisper_decode_token(model, ids[:, i], i, ks, vs,
                                                           cross_k, cross_v)
                forced.append(step_logits.float())
            forced = torch.stack(forced, 1)
        compare_rel(f"cached {kv_dtype} KV steps, teacher-forced on the full window's tokens: "
                    f"logits vs the full window's", forced, full_logits,
                    WHISPER_CACHED_LOGITS[kv_dtype])
        flips = forced.argmax(-1) != full
        tie = torch.where(flips.any(1), flips.float().argmax(1), n).tolist()
        cached, counts = counted(lambda: whisper_transcribe_cached(model, mel, 1, n,
                                                                   kv_dtype=kv_dtype), add=False)
        ok = all(torch.equal(cached[r, :t], full[r, :t])
                 and (t == n or cached[r, t] == forced[r, t].argmax()) for r, t in enumerate(tie))
        err = (forced - full_logits).abs().amax(-1)
        at = "; ".join(f"clip {r} step {t}: margin {margin[r, t].item():.3e}, logit error "
                       f"{err[r, t].item():.3e}" for r, t in enumerate(tie) if t < n)
        check(ok and counts == k1_per(cfg.n_layer_enc),
              f"whisper_transcribe_cached {kv_dtype} KV: tokens equal to the full window's in "
              f"{sum(t == n for t in tie)} of {b} clips throughout, and in every clip up to its "
              f"first teacher-forced flip [{at or 'none'}]; the full window's smallest top-two "
              f"margin {margin.min().item():.3e}; launches {launched(counts)} (the encoder's)")
    cached8 = whisper_transcribe_cached(model, mel, 1, n, kv_dtype=torch.int8)
    agree = (cached8 == full).float().mean().item()
    check(tuple(cached8.shape) == (b, n) and bool(((cached8 >= 0)
                                                   & (cached8 < cfg.vocab_size)).all()),
          f"whisper_transcribe_cached int8 KV: runs, tokens in range, {100 * agree:.1f}% equal "
          f"to the full window's")
    say(f"  tokens of clip 0: {full[0].tolist()}")
    del model, full, cached, cached8

    # 11.6: the full-window vs cached crossover at tools/bench_whisper_dispatch.py's config.
    cfg = WhisperConfig(**DISPATCH, n_text_ctx=max(DISPATCH_CTXS) + 8)
    model = create_whisper_mop(cfg, generator=torch.Generator().manual_seed(33)).eval()
    mel = whisper_batch(cfg, DISPATCH_BATCH, 1)[0]

    # Both routes host-bound, so each ctx runs them in turns (full, cached,
    # cached, full, twice) after a warm call each, and compares medians.
    rows = []
    for ctx in DISPATCH_CTXS:
        routes = {"full": lambda: whisper_transcribe(model, mel, 1, ctx),
                  "cached": lambda: whisper_transcribe_cached(model, mel, 1, ctx)}
        times = {name: [] for name in routes}
        for name, fn in routes.items():
            fn()
        for name in ("full", "cached", "cached", "full") * 2:
            times[name].append(seconds_of(routes[name])[1])
        t_full, t_cached = (statistics.median(times[k]) for k in ("full", "cached"))
        rows.append((ctx, t_full, t_cached))
        say(f"  dispatch ctx {ctx}: full window {1e3 * t_full:.1f} ms "
            f"[{', '.join(f'{1e3 * t:.1f}' for t in times['full'])}], cached "
            f"{1e3 * t_cached:.1f} ms [{', '.join(f'{1e3 * t:.1f}' for t in times['cached'])}] "
            f"(medians, {t_full / t_cached:.2f}x), "
            f"{DISPATCH_BATCH * ctx / min(t_full, t_cached):.0f} tokens/s; auto picks "
            f"{'cached' if ctx >= kernel_switches.whisper_cached_min_ctx else 'full'} "
            f"[{smi}]")
    wins = [ctx for ctx, tf, tc in rows if tc < tf]
    cross = next((ctx for i, (ctx, _, _) in enumerate(rows)
                  if all(tc < tf for _, tf, tc in rows[i:])), None)
    say(f"  Whisper dispatch at {DISPATCH} batch {DISPATCH_BATCH}: cached faster by median at "
        f"ctx {wins}; from ctx {cross} on at every ctx measured; the port's "
        f"whisper_cached_min_ctx {kernel_switches.whisper_cached_min_ctx} [{smi}]")
    out = whisper_transcribe_auto(model, mel, 1, DISPATCH_CTXS[0])
    check(tuple(out.shape) == (DISPATCH_BATCH, DISPATCH_CTXS[0]),
          f"whisper_transcribe_auto at ctx {DISPATCH_CTXS[0]}: shape {tuple(out.shape)}")
    del model

    # 11.7: the demo CLI on the card.
    t0 = time.time()
    losses = whisper_demo.main(["--steps", "10"])
    check(len(losses) == 10 and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0],
          f"whisper_demo on the card, 10 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{time.time() - t0:.2f} s")


def step_profile(step, images, label, smi, windows, window_steps):
    """Times ``step`` (``windows`` timed windows of ``window_steps`` calls
    after a warm one) with its peak memory and a torch.profiler breakdown of
    two more calls; prints one line each. Returns (ms, images/s, busy, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, rate, per = timed_windows(step, windows, window_steps, images)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows, wall_us = device_breakdown(step, reps=2)
    busy = sum(t for _, t in rows) / wall_us
    say(f"  {label}: {ms:.3f} ms/step, {rate:.0f} images/s [per window "
        f"{', '.join(f'{r:.0f}' for r in per)}], peak {peak:.2f} GiB [{smi}]")
    say(f"    device busy {100 * busy:.1f}% of {wall_us / 1e3:.2f} ms (2 steps, profiled); "
        f"by class: {by_class(rows)}")
    return ms, rate, busy, peak


def wide_kernel_times(fn, reps=4):
    """Device time of K2w's or K2bw's kernels by name (ms a call and
    launches a call) from torch.profiler's kernel records over ``reps``
    calls, profiled by ``profiled_records`` against the library's own launch
    count (``mop_edgewise_wide_launches``: a wrapper call launches several
    kernels). Returns (times by name, records kept, launches)."""
    import ctypes

    count = F._fn("edgewise_wide", "mop_edgewise_wide_launches", [], ctypes.c_longlong)
    fn()
    records, counts, prof = profiled_records(
        lambda: [fn() for _ in range(reps)], {"wide": "mop::wide::"},
        count=lambda: {"wide": count()})
    times = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or "mop::wide::" not in e.name:
            continue
        label = e.name.split("mop::wide::", 1)[1].split("(", 1)[0]
        us_all, k = times.get(label, (0.0, 0))
        times[label] = (us_all + e.time_range.elapsed_us(), k + 1)
    return ({label: (us / 1e3 / reps, k / reps) for label, (us, k) in times.items()},
            records["wide"], counts["wide"])


def wide_kernel_checks(smi):
    """K2w and K2bw against their plain versions: at VOC E's shape in fp32
    (the CLI's dtype) and bf16, at the strided per-view views and the
    strided dy that EdgewiseMSA passes, and off the shape. Then their times
    beside the plain versions' and the bound, with each kernel's device time
    by name and the products' achieved TFLOP/s. Returns the kernels line's two
    records (launches filled in from the main path later)."""
    say("[12 K2w edgewise_lowrank_wide_fwd and K2bw edgewise_lowrank_wide_bwd vs plain]")
    gw = cuda_generator(46)
    grad_names = ("dq", "dk", "dv", "dwrow", "dbrow", "dwcol", "dbcol", "dchain")
    errs = {WIDE_FWD: 0.0, WIDE_BWD: 0.0}

    def rn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gw).to(dtype)

    def both(label, args, dy, dtype, main=False):
        with torch.no_grad():
            got, want = F.edgewise_lowrank_wide_fwd(*args), \
                F.fused_edgewise_lowrank_attention_plain(*args)
        if dtype == torch.float32:
            err = compare(f"K2w {label}", got, want, 2e-5, 2e-4)
        else:
            err = compare(f"K2w {label}", got, want, 5e-2, 5e-2)
        if main:
            errs[WIDE_FWD] = max(errs[WIDE_FWD], err)
        got = F.edgewise_lowrank_wide_bwd(*args, dy)
        want = F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
        for gname, a, b in zip(grad_names, got, want):
            if dtype == torch.float32:
                err = compare(f"K2bw {label} {gname}", a, b, 2e-4, 2e-3)
                if main:
                    errs[WIDE_BWD] = max(errs[WIDE_BWD], err)
            else:
                compare_rel(f"K2bw {label} {gname}", a, b, BF16_GRAD_FRAC)

    (b, h), nv, n, dk, r = VOC_E
    for dtype in (torch.float32, torch.bfloat16):
        args = edgewise_inputs(gw, (b, h), nv, n, dk, r, dtype)
        both(f"{(b, h, nv, n, dk)} r={r} {dtype}", args, rn(b, h, n, dk, dtype=dtype), dtype,
             main=dtype == torch.float32)
    # EdgewiseMSA's views of one stacked qkv output, and the strided dy that
    # merging the heads gives back.
    args = edgewise_inputs(gw, (b, h), nv, n, dk, r, torch.float32)
    qkv = rn(b, n, nv, 3, h, dk).permute(3, 0, 4, 2, 1, 5)
    both(f"strided view inputs {(b, h, nv, n, dk)} r={r} float32", (*qkv, *args[3:]),
         rn(b, n, h, dk).transpose(1, 2), torch.float32, main=True)
    for bh_shape, nv_, n_, dk_, r_ in WIDE_OFF_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = edgewise_inputs(gw, bh_shape, nv_, n_, dk_, r_, dtype)
            both(f"{(*bh_shape, nv_, n_, dk_)} r={r_} {dtype}", args,
                 rn(*bh_shape, n_, dk_, dtype=dtype), dtype)
    records = []
    for name, fn, plain_fn, cost in (
            (WIDE_FWD, F.edgewise_lowrank_wide_fwd, F.fused_edgewise_lowrank_attention_plain,
             edgewise_cost),
            (WIDE_BWD, F.edgewise_lowrank_wide_bwd,
             F.fused_edgewise_lowrank_attention_bwd_plain, edgewise_bwd_cost)):
        rec = None
        for dtype in (torch.float32, torch.bfloat16):
            args = edgewise_inputs(gw, (b, h), nv, n, dk, r, dtype)
            if name == WIDE_BWD:
                args = (*args, rn(b, h, n, dk, dtype=dtype))
            with torch.no_grad():
                ms = time_ms(lambda: fn(*args), iters=5, reps=3)
                plain = time_ms(lambda: plain_fn(*args), iters=3, reps=3)
            # fp32 runs every product as 3xTF32: three passes at the TF32 rate.
            peak = PEAK_TF32 / 3 if dtype == torch.float32 else None
            bnd, by = bound_ms(*cost(b * h, nv, n, dk, r, dtype), dtype, peak)
            rate = "3xTF32, 495 / 3 TFLOP/s" if peak else "bf16, 989 TFLOP/s"
            say(f"  {name} {(b, h, nv, n, dk)} r={r} {dtype}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}; {rate}), no single library call "
                f"[{smi}]")
            with torch.no_grad():
                times, kept, launches = wide_kernel_times(lambda: fn(*args))
            check(kept == launches, f"{name} {dtype}: torch.profiler kept {kept} kernel records "
                  f"of the library's {launches} launches")
            total = sum(ms_ for ms_, _ in times.values())
            prod_ms = sum(ms_ for label, (ms_, _) in times.items() if label.startswith("mm_kernel"))
            flops = cost(b * h, nv, n, dk, r, dtype)[0]
            tflops = flops / (prod_ms * 1e-3) / 1e12 if prod_ms else None
            say(f"    by kernel (device ms a call, launches a call; torch.profiler over 4 calls, "
                f"{total:.4f} ms in all): "
                + "; ".join(f"{label} {ms_:.4f} ({k:g})" for label, (ms_, k) in
                            sorted(times.items(), key=lambda kv: -kv[1][0])))
            if tflops:
                say(f"    products (mm_kernel) {prod_ms:.4f} ms ({100 * prod_ms / total:.1f}%) "
                    f"at {tflops:.1f} TFLOP/s of the bound's {flops / 1e9:.2f} GFLOP [{smi}]")
            row = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None,
                       products_tflops=tflops)
            if rec is None:  # VOC's E trains in fp32
                rec = dict(name=name, route="cuda", source="mop_tpu_torch/csrc/edgewise_wide.cu",
                           replaces="mop_tpu/ops/fused.py:"
                           + ("628" if name == WIDE_FWD else "641"),
                           launches=0, max_abs_err=errs[name], **row)
            else:
                rec["bf16"] = row
        records.append(rec)
    return records


def moe_voc_imagenet_phases(smi):
    """Phase 12: the MoE ViT, the VOC localizer CLI and the ImageNet CLI and
    step on the card. Returns K1's timing rows at VOC's attention shape; the
    MoE's counted steps and forwards and the VOC runs add to the kernels
    line's launches."""
    none = {f.__name__: 0 for f in F.KERNELS}

    def k1_per(n):
        return {**none, "flash_attention": n}

    # 12.1: the MoE ViT at B_bench's width, dense and routed, from one seed.
    say(f"[12 MoE] ViT_MoP(use_moe=True, moe_experts={MOE_EXPERTS}) at B_bench's width "
        f"(224/6/4, 5 views, 3 kernels), batch {BATCH}")
    models = {impl: ViT_MoP(dim=224, depth=6, heads=4, n_classes=N_CLASSES, n_views=5,
                            n_kernels=3, use_moe=True, moe_experts=MOE_EXPERTS, moe_impl=impl,
                            generator=torch.Generator().manual_seed(40))
              for impl in ("dense", "routed")}
    rs = np.random.RandomState(12)
    x_u8 = torch.from_numpy(rs.randint(0, 256, (BATCH, 3, 32, 32), dtype=np.uint8)).cuda()
    y = torch.from_numpy(rs.randint(0, N_CLASSES, BATCH)).cuda()
    x = cifar_eval_transform(x_u8, CIFAR100_MEAN, CIFAR100_STD)
    with torch.inference_mode():
        logits = {}
        for impl, model in models.items():
            logits[impl], counts = counted(lambda: model.eval()(x))
            with plain_kernels():
                ref = model(x)
            check(counts == k1_per(6), f"MoE {impl}: fp32 eval forward launches "
                  f"{launched(counts)} (K1 once a block)")
            compare(f"MoE {impl}: fp32 logits kernel path vs plain path", logits[impl], ref,
                    2e-5, 2e-4)
        routed = models["routed"]
        for m in routed.modules():
            if isinstance(m, MoEMLP):
                m.capacity_factor = float(MOE_EXPERTS)  # room for every token
        compare(f"MoE routed at capacity factor {MOE_EXPERTS} (every expert holds every "
                "token) vs dense: fp32 logits", routed(x), logits["dense"], 2e-5, 2e-4)
        for m in routed.modules():
            if isinstance(m, MoEMLP):
                m.capacity_factor = 1.25
        # The share of tokens the routed layers drop at the default 1.25.
        kept = []
        hooks = [m.register_forward_hook(lambda mod, ins, out: kept.append(
            (out.flatten(0, 1).abs().amax(-1) > 0).float().sum()))
            for m in routed.modules() if isinstance(m, MoEMLP)]
        routed(x)
        for hook in hooks:
            hook.remove()
        total = BATCH * 64 * len(hooks)
        say(f"  MoE routed at capacity factor 1.25: "
            f"{100 * (1 - sum(kept).item() / total):.2f}% of the {total:,} token-layers "
            f"dropped (zero output), on random weights")
    del logits, ref
    for impl, model in models.items():
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
        train = make_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD)
        gen = cuda_generator(41)
        first, counts = counted(lambda: train(x_u8, y, gen))
        check(counts == k1_per(6), f"MoE {impl}: bf16 train step launches {launched(counts)} "
              "(K1 in the forward; its backward recomputes with plain ops)")
        losses = [first["loss"].item()] + [train(x_u8, y, gen)["loss"].item()
                                           for _ in range(MOE_STEPS - 1)]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"MoE {impl}: loss over {MOE_STEPS} steps on one batch {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
        step_profile(lambda: train(x_u8, y, gen), BATCH, f"MoE {impl} bf16 train step, batch "
                     f"{BATCH}", smi, MOE_WINDOWS, MOE_WINDOW_STEPS)
        del opt, train
    del models, model, routed
    # The op at tools/bench_moe.py's shapes, bf16: dense (every expert on
    # every token) vs routed (cf 1.25), forward alone and forward + backward
    # to every input, in turns (dense, routed, routed, dense).
    t, d, h = MOE_OP["tokens"], MOE_OP["dim"], MOE_OP["hidden"]
    gm = cuda_generator(42)
    for e in MOE_OP_EXPERTS:
        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=gm) * scale).to(torch.bfloat16)

        ins = [rnd(t, d), rnd(d, e, scale=0.02), rnd(e, scale=0.0), rnd(e, d, h, scale=0.02),
               rnd(e, h, d, scale=0.02)]
        wrt = [a.clone().requires_grad_() for a in ins]
        ops = {"dense": lambda *a: ops_moe.dense_top1_mlp(*a, gelu_tanh),
               "routed": lambda *a: ops_moe.top1_routed_mlp(*a, gelu_tanh,
                                                            capacity_factor=MOE_OP["cf"])}
        res = {}
        for what in ("forward", "forward + backward"):
            times = {"dense": [], "routed": []}
            for impl in ("dense", "routed", "routed", "dense"):
                op = ops[impl]
                if what == "forward":
                    with torch.inference_mode():
                        times[impl].append(time_ms(lambda: op(*ins), iters=20, reps=5))
                else:
                    times[impl].append(time_ms(lambda: torch.autograd.grad(
                        op(*wrt).float().sum(), wrt), iters=10, reps=5))
            res[what] = {k: min(v) for k, v in times.items()}
            say(f"  MoE op T {t} x {d} -> {h}, {e} experts, bf16, {what}: dense "
                f"{res[what]['dense']:.4f} ms [{' / '.join(f'{v:.4f}' for v in times['dense'])}]"
                f", routed (cf {MOE_OP['cf']}) {res[what]['routed']:.4f} ms "
                f"[{' / '.join(f'{v:.4f}' for v in times['routed'])}]: dense / routed "
                f"{res[what]['dense'] / res[what]['routed']:.2f}x [{smi}]")
    del ins, wrt

    # 12.2: K2w and K2bw, E's attention at VOC's shape, against their plain
    # versions; then off it and at the strided views EdgewiseMSA passes.
    wide_records = wide_kernel_checks(smi)

    # 12.3: the VOC localizer CLI at its defaults, modes A, B and E.
    rows = {}
    for mode in ("A", "B", "E"):
        with tempfile.TemporaryDirectory() as out:
            argv = VOC_ARGS + ["--model", mode, "--out", out]
            say(f"[12 VOC] voc_localization_vit.main({' '.join(argv[:-2])})")
            F.reset_launch_counts()
            t0 = time.time()
            res = voc_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = {f.__name__: f.launches for f in F.KERNELS}
            lines = open(res["csv"]).read().split()
        if mode == "E":  # K2w each block's forward, K2bw its gradient
            want = {**none, WIDE_FWD: VOC_DEPTH * (VOC_STEPS + VOC_EVALS),
                    WIDE_BWD: VOC_DEPTH * VOC_STEPS}
        else:
            want = k1_per(VOC_DEPTH * (VOC_STEPS + VOC_EVALS))
        for name, c in counts.items():
            launches[name] += c
        losses, half = res["losses"], len(res["losses"]) // 2
        falls = sum(losses[half:]) / half < sum(losses[:half]) / half
        check(counts == want and len(losses) == VOC_STEPS and falls
              and all(math.isfinite(v) for v in losses)
              and all(0.0 <= iou <= 1.0 for _, iou, _ in res["evals"])
              and lines == ["model,val_iou,val_l1", f"{mode},{res['iou']:.4f},{res['l1']:.4f}"],
              f"VOC {mode}: loss by step {', '.join(f'{v:.4f}' for v in losses)} (epoch means "
              f"falling: {falls}); val IoU / L1 by epoch "
              f"{', '.join(f'{i:.4f} / {l1:.4f}' for _, i, l1 in res['evals'])}; csv {lines}; "
              f"launches {launched(counts)} (expected {launched(want)}: "
              f"{'K2w' if mode == 'E' else 'K1'} {VOC_DEPTH} a forward"
              f"{', K2bw 6 a step' if mode == 'E' else ''}, {VOC_STEPS} steps and "
              f"{VOC_EVALS} evals); "
              f"{wall:.2f} s wall [{smi}]")
        rows[mode] = res
    del rows, res
    # K1 at A's and B's attention shape, against its plain version and sdpa.
    gv = cuda_generator(43)
    k1_rows = {}
    bh = VOC_K1[0] * VOC_K1[1]
    for dtype, atol, rtol in ((torch.float32, 2e-5, 0.0),
                              (torch.bfloat16, K1_BF16_ATOL, K1_BF16_RTOL)):
        q, k, v = (torch.randn(*VOC_K1, device="cuda", generator=gv).to(dtype)
                   for _ in range(3))
        with torch.inference_mode():
            err = compare(f"K1 at VOC's {VOC_K1} {dtype} vs plain", F.flash_attention(q, k, v),
                          F.flash_attention_plain(q, k, v), atol, rtol)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(q, k, v)

            ms = time_ms(lambda: F.flash_attention(q, k, v))
            plain = time_ms(lambda: F.flash_attention_plain(q, k, v), iters=10)
            lib = time_ms(sdpa)
            dev = graph_ms(lambda: F.flash_attention(q, k, v))
            lib_dev = graph_ms(sdpa)
        bnd, by = bound_ms(*flash_cost(bh, VOC_K1[2], VOC_K1[2], VOC_K1[3], dtype), dtype)
        say(f"  K1 {VOC_K1} {dtype}: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}); in a CUDA graph kernel {dev:.4f} ms, sdpa "
            f"{lib_dev:.4f} ms [{smi}]")
        k1_rows[f"voc_{'fp32' if dtype == torch.float32 else 'bf16'}"] = dict(
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib, device_ms=dev,
            library_device_ms=lib_dev, max_abs_err=err)
    del q, k, v

    # 12.4: the ImageNet CLI at the 50M target: A and B at batch 256, then E
    # at its cut batch (the CLI always runs A too).
    for models_, batch in ((["A", "B"], BATCH), (["E"], IMAGENET_E_BATCH)):
        with tempfile.TemporaryDirectory() as out:
            argv = IMAGENET_ARGS + ["--models", *models_, "--batch", str(batch), "--out", out]
            say(f"[12 ImageNet] imagenet_ab_param_budgets.main({' '.join(argv[:-2])})")
            F.reset_launch_counts()
            t0 = time.time()
            res = imagenet_cli.main(argv)[IMAGENET_TARGET]
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = {f.__name__: f.launches for f in F.KERNELS}
            prefix = os.path.join(out, f"imagenet_ab_target_{IMAGENET_TARGET}")
            keys = list(res["params"])
            headers = {".csv": "seed," + ",".join(f"acc_{k}" for k in keys),
                       "_val_summary.csv": "model,mean_val,std_val",
                       "_test.csv": "model,test_acc"}
            files = {sfx: open(prefix + sfx).readline().strip() == hdr
                     for sfx, hdr in headers.items()}
        for key in keys:
            cfg, p = res["configs"][key]
            got = ((cfg["dim"], cfg["depth"], cfg["heads"]), p)
            losses = res["losses"][key]
            run = res["runs"][key]
            lag = max((a - b).abs().max().item() for a, b in
                      zip(run.model.parameters(), run.ema.parameters()))
            check(got == IMAGENET_MATCH[key] and len(losses) == 20
                  and all(math.isfinite(v) for v in losses) and lag > 0,
                  f"ImageNet {key} at batch {batch}: matched {got[0]}, {got[1]:,} params (the "
                  f"JAX matcher's {IMAGENET_MATCH[key][0]}, {IMAGENET_MATCH[key][1]:,}); loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}) over 20 steps; "
                  f"EMA (decay 0.9999) off the params by up to {lag:.3e}; val acc "
                  f"{res['val_acc'][key][0]:.4f} and test acc {res['test_acc'][key]:.4f} by the "
                  f"EMA weights [{smi}]")
        check(all(files.values()) and counts == none,
              f"ImageNet CLI {models_} at batch {batch}: the JAX script's three files and "
              f"headers {files}; launches {launched(counts) or 'none'} (A and B compose at dk "
              f"160 and 158 > {F.FLASH_MAX_DK}, E's dense gate at N = 196); {wall:.2f} s wall "
              f"[{smi}]")
        del res, run
    torch.cuda.empty_cache()

    # 12.5: the ImageNet step by itself: A with RandAugment on and erasing,
    # Mixup and CutMix at their defaults, batch 256, each remat mode; B
    # likewise with none; E at its cut batch.
    args = imagenet_cli.build_argparser().parse_args(IMAGENET_ARGS + ["--models", "A", "B", "E"])
    size = args.img_size
    cfgs = {k: (dict(zip(("dim", "depth", "heads"), c)), p) for k, (c, p) in
            IMAGENET_MATCH.items()}
    ri = np.random.RandomState(13)
    for key, batch, remats in (("A", BATCH, IMAGENET_REMATS), ("B", BATCH, ("none",)),
                               ("E", IMAGENET_E_BATCH, ("none",))):
        model = imagenet_cli.make_model(args, cfgs, key, 100, "cuda",
                                        torch.Generator().manual_seed(44))
        opt = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=args.weight_decay)
        xi = torch.from_numpy(ri.randint(0, 256, (batch, 3, size, size), dtype=np.uint8)).cuda()
        yi = torch.from_numpy(ri.randint(0, 100, batch)).cuda()
        gi = cuda_generator(45)
        for remat in remats:
            step = make_imagenet_train_step(model, opt, IMAGENET_MEAN, IMAGENET_STD, 100,
                                            use_randaug=True, remat=remat)
            label = (f"ImageNet {key} bf16 step, batch {batch}, RandAugment, erasing 0.25, "
                     f"Mixup 0.8 / CutMix 1.0 at 0.5, remat {remat}")
            step_profile(lambda: step(xi, yi, gi), batch, label, smi, IMAGENET_WINDOWS,
                         IMAGENET_WINDOW_STEPS)
            del step
        del model, opt, xi, yi
        torch.cuda.empty_cache()
    return k1_rows, wide_records


def tie_prefix(got, want, margins):
    """Whether ``got`` equals ``want`` (B, T) in every row up to that row's
    first step whose top-two margin (B, T) is below DECODE_TIE, and those
    steps (T where there is none)."""
    n = want.shape[1]
    ties = margins < DECODE_TIE
    first = torch.where(ties.any(1), ties.float().argmax(1),
                        torch.full_like(ties[:, 0], n, dtype=torch.long)).tolist()
    return all(torch.equal(got[r, :t], want[r, :t]) for r, t in enumerate(first)), first


def top2_margin(logits):
    top = logits.float().topk(2, -1).values
    return top[..., 0] - top[..., 1]


def window_logits(model, seq, t0, n):
    """The logits (B, n, V) of the full-window sampler's n steps along the
    token sequence seq (B, t0 + n), teacher-forced: step s's window holds
    the sequence's last ``min(t0 + s, block)`` tokens before t0 + s, zeros
    after, and its logits are those at its last live position."""
    block = model.config.block_size
    b = seq.shape[0]
    wins, lens = [], []
    for s in range(n):
        end = t0 + s
        ln = min(end, block)
        w = torch.zeros(b, block, dtype=torch.long, device=seq.device)
        w[:, :ln] = seq[:, end - ln:end]
        wins.append(w)
        lens.append(ln)
    wins = torch.stack(wins, 1).reshape(b * n, block)
    idx = torch.tensor(lens, device=seq.device).repeat(b) - 1
    out = []
    with torch.no_grad():
        for i in range(0, b * n, DECODE_WINDOW_CHUNK):
            logits = model(wins[i:i + DECODE_WINDOW_CHUNK])[0]
            out.append(logits[torch.arange(logits.shape[0], device=seq.device),
                              idx[i:i + DECODE_WINDOW_CHUNK]])
    return torch.cat(out).reshape(b, n, -1)


def cached_logits(model, params, seq, t0, n, kv_dtype=torch.float32):
    """The cached decoder's logits (B, n, V) along seq (B, t0 + n): the
    prefill's, then each decode step's fed the sequence's tokens."""
    logits, cache = prefill(model, params, seq[:, :t0], kv_dtype=kv_dtype)
    out = [logits]
    for i in range(n - 1):
        logits, cache = decode_step(model, params, cache, seq[:, t0 + i])
        out.append(logits)
    return torch.stack(out, 1)


def seconds_of(fn):
    """``fn()`` and its wall seconds, the device synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def busy_share(fn):
    """The device's busy share over one call of ``fn`` (torch.profiler), with
    the call's wall time, profiler included."""
    rows, wall_us = device_breakdown(fn, reps=1)
    return sum(t for _, t in rows) / wall_us, wall_us / 1e3


def decode_phases(smi):
    """Phase 13: decode on the card. Returns K5's timing rows at the two
    decode shapes for the kernels line; the exact samplers' K5 launches and
    the Whisper beam's K1 launches add to ``launches``."""
    none = {f.__name__: 0 for f in F.KERNELS}
    k5_rows = {}
    say(f"[13 decode] 13a: tools/bench_decode.py's GPT-Quartet {DECODE_SMALL}, vocab "
        f"{DECODE_VOCAB}, batch {DECODE_BATCH}, {DECODE_T0}-token prompt, {DECODE_NEW} new "
        "tokens")
    cfg = TransformerConfig(**DECODE_SMALL)
    model = create_gpt_quartet(DECODE_VOCAB, cfg,
                               generator=torch.Generator().manual_seed(40)).eval()
    prompt = torch.randint(0, DECODE_VOCAB, (DECODE_BATCH, DECODE_T0), device="cuda",
                           generator=cuda_generator(41))
    t0, n, L = DECODE_T0, DECODE_NEW, cfg.n_layer
    toks, counts = counted(lambda: generate(model, prompt, n))
    check(counts == {**none, K5: L * n} and tuple(toks.shape) == (DECODE_BATCH, t0 + n),
          f"generate (exact full window): launches {launched(counts)}, K5 {L} layers x {n} "
          f"tokens = {L * n}; {len(set(toks[:, t0:].flatten().tolist()))} distinct tokens")
    full, full_s = seconds_of(lambda: generate(model, prompt, n))
    check(torch.equal(full, toks), "generate: a second run gives the same tokens")
    kernel_switches.fused_quartet = False
    try:
        plain = generate(model, prompt, n)
        forced_plain = window_logits(model, toks, t0, n)
    finally:
        kernel_switches.fused_quartet = True
    forced, counts = counted(lambda: window_logits(model, toks, t0, n), add=False)
    compare(f"generate's {n} steps teacher-forced on the kernel route's tokens: logits "
            f"through K5 ({counts[K5]} launches) vs fused_quartet off", forced, forced_plain,
            2e-5, 2e-4)
    margins = top2_margin(forced_plain)
    ok, ties = tie_prefix(plain[:, t0:], toks[:, t0:], margins)
    check(ok, f"generate's greedy tokens with fused_quartet off equal the K5 route's up to each "
          f"row's first near tie (margin < {DECODE_TIE}): first ties at {ties} of {n}; the "
          f"smallest margin {margins.min().item():.3e}; rows equal throughout "
          f"{sum(torch.equal(a, b) for a, b in zip(plain, toks))} of {DECODE_BATCH}")
    rate_full = DECODE_BATCH * n / full_s
    params = decode_params(model)
    row = {}
    for kv in (torch.float32, torch.bfloat16, torch.int8):
        generate_cached(model, params, prompt, n, kv_dtype=kv)  # warm
        cached, dt = seconds_of(lambda: generate_cached(model, params, prompt, n, kv_dtype=kv))
        row[kv] = (DECODE_BATCH * n / dt, (cached[:, t0:] == full[:, t0:]).float().mean().item())
        check(tuple(cached.shape) == tuple(full.shape) and bool(((cached >= 0)
                                                                  & (cached < DECODE_VOCAB)).all()),
              f"generate_cached {kv} KV: {row[kv][0]:.0f} tokens/s, greedy agreement with the "
              f"full window {100 * row[kv][1]:.1f}% [{smi}]")
    c32 = row[torch.float32][0]
    say(f"  | block | new | full-window tok/s | cached tok/s | speedup | bf16-KV tok/s | vs cached "
        f"| int8-KV tok/s | vs cached |")
    say(f"  | {cfg.block_size} | {n} | {rate_full:.0f} | {c32:.0f} | {c32 / rate_full:.2f}x | "
        f"{row[torch.bfloat16][0]:.0f} | {row[torch.bfloat16][0] / c32:.2f}x | "
        f"{row[torch.int8][0]:.0f} | {row[torch.int8][0] / c32:.2f}x | [{smi}]")
    m = min(64, n)
    busy, wall = busy_share(lambda: generate(model, prompt, m))
    busy_c, wall_c = busy_share(lambda: generate_cached(model, params, prompt, m))
    say(f"  device busy over {m} tokens: generate {100 * busy:.1f}% of {wall:.1f} ms, "
        f"generate_cached {100 * busy_c:.1f}% of {wall_c:.1f} ms (profiled) [{smi}]")
    del model, params, forced, forced_plain

    say(f"[13 decode] 13b: the 170M GPT-Quartet {DECODE_170M}, vocab {DECODE_VOCAB}, batch 1, "
        f"with the draft {DECODE_DRAFT}")
    cfg = TransformerConfig(**DECODE_170M)
    target = create_gpt_quartet(DECODE_VOCAB, cfg,
                                generator=torch.Generator().manual_seed(42)).eval()
    draft = create_gpt_quartet(DECODE_VOCAB, TransformerConfig(**DECODE_DRAFT),
                               generator=torch.Generator().manual_seed(43)).eval()
    dk = cfg.n_embd // cfg.n_head
    keeps = F.quartet_keeps_rows(torch.float32, cfg.block_size, dk)
    check(not keeps, f"quartet_keeps_rows(fp32, {cfg.block_size}, {dk}) = {keeps}: K5 streams "
          f"at (1, {cfg.n_head}, {cfg.block_size}, {dk})")
    p1 = torch.randint(0, DECODE_VOCAB, (1, t0), device="cuda", generator=cuda_generator(44))
    n, L = DECODE_170M_EXACT, cfg.n_layer
    toks, counts = counted(lambda: generate(target, p1, n))
    check(counts == {**none, K5: L * n},
          f"generate (exact, streaming K5): launches {launched(counts)}, {L} x {n} = {L * n}")
    full, full_s = seconds_of(lambda: generate(target, p1, n))
    forced = window_logits(target, toks, t0, n)
    kernel_switches.fused_quartet = False
    try:
        forced_plain = window_logits(target, toks, t0, n)
    finally:
        kernel_switches.fused_quartet = True
    compare(f"170M generate's {n} steps teacher-forced: logits through the streaming K5 vs "
            f"fused_quartet off", forced, forced_plain, 2e-5, 2e-4)
    say(f"  170M generate: {n / full_s:.1f} tokens/s, {1e3 * full_s / n:.2f} ms a token [{smi}]")
    del forced, forced_plain
    n = DECODE_170M_CACHED
    params = decode_params(target)
    ref = generate_cached(target, params, p1, n)  # also the fp32 route's warm call
    ref_logits = cached_logits(target, params, ref, t0, n)
    ref_margin = top2_margin(ref_logits)
    step_s = {}
    for name, p in (("fp32", params), ("int8", quantize_params(params)),
                    ("int4", quantize_params(params, bits=4))):
        stored, fp32_bytes = quantized_bytes(p)
        if name != "fp32":
            generate_cached(target, p, p1, 8)  # warm
        out, step_s[name] = seconds_of(lambda: generate_cached(target, p, p1, n))
        lg = ref_logits if name == "fp32" else cached_logits(target, p, ref, t0, n)
        agree = (lg.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
        err = (lg - ref_logits).abs().max().item() / ref_logits.abs().max().item()
        check(bool(torch.isfinite(lg).all()) and (name != "fp32" or torch.equal(out, ref)),
              f"generate_cached, {name} weights: {stored / 1e6:.1f} MB stored ({fp32_bytes / 1e6:.1f}"
              f" MB in fp32), {1e3 * step_s[name] / n:.3f} ms a step ({n} tokens), "
              f"teacher-forced on the fp32 tokens: argmax agreement {100 * agree:.1f}%, max logit "
              f"error {err:.3e} of the largest [{smi}]")
    # decode_chunk against the same tokens one decode_step at a time
    _, cache = prefill(target, params, p1)
    c = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
    seq = []
    for i in range(DECODE_GAMMA + 1):
        lg, c = decode_step(target, params, c, ref[:, t0 + i])
        seq.append(lg)
    chunk = decode_chunk(target, params, cache, ref[:, t0:t0 + DECODE_GAMMA + 1])[0]
    compare(f"decode_chunk of {DECODE_GAMMA + 1} tokens vs {DECODE_GAMMA + 1} decode_steps "
            "(170M)", chunk, torch.stack(seq, 1), 2e-5, 2e-4)
    del cache, c
    (spec, stats), spec_s = seconds_of(lambda: speculative_generate(
        target, params, draft, None, p1, n, gamma=DECODE_GAMMA, return_stats=True))
    ref_s = step_s["fp32"]
    ok, ties = tie_prefix(spec[:, t0:], ref[:, t0:], ref_margin)
    check(ok, f"speculative_generate greedy, gamma {DECODE_GAMMA}: tokens equal "
          f"generate_cached's up to the first near tie ({ties} of {n}); acceptance "
          f"{stats['accepted']} / {stats['drafted']} = "
          f"{stats['accepted'] / max(stats['drafted'], 1):.3f} over {stats['rounds']} rounds; "
          f"{n / spec_s:.1f} tokens/s against generate_cached's {n / ref_s:.1f} [{smi}]")
    beam1 = generate_beam(target, params, p1, n, num_beams=1)
    ok, ties = tie_prefix(beam1[:, t0:], ref[:, t0:], ref_margin)
    check(ok, f"generate_beam num_beams=1: generate_cached's tokens up to the first near tie "
          f"({ties} of {n})")
    beams, scores = generate_beam(target, params, p1, n, num_beams=4, return_all=True)
    check(tuple(beams.shape) == (1, 4, t0 + n) and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"generate_beam num_beams=4: scores best first {[round(v, 3) for v in scores[0].tolist()]}")
    small = TransformerConfig(**DECODE_SMALL)
    for dtype, shape in ((torch.float32, (DECODE_BATCH, small.n_head, small.block_size,
                                          small.n_embd // small.n_head)),
                         (torch.float32, (1, cfg.n_head, cfg.block_size, dk))):
        ins = [torch.randn(*shape, device="cuda", generator=cuda_generator(45)) for _ in range(5)]
        ms = time_ms(lambda: F.fused_quartet_attention(*ins, 0.3, 1.2), iters=20)
        plain_ms = time_ms(lambda: F.fused_quartet_attention_plain(*ins, 0.3, 1.2), iters=10)
        bnd, by = bound_ms(*quartet_cost(shape[0] * shape[1], shape[2], shape[3], dtype), dtype)
        kind = "kept rows" if F.quartet_keeps_rows(dtype, shape[2], shape[3]) else "streaming"
        say(f"  K5 {shape} fp32 (decode, {kind}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}) [{smi}]")
        k5_rows["decode_" + "x".join(map(str, shape))] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None)
    del target, draft, params, ins

    say(f"[13 decode] 13c: Whisper_20M beam transcription, {WHISPER_BEAMS} beams, "
        f"{WHISPER_BEAM_TOKENS} tokens")
    wcfg = WhisperConfig(**WHISPER_20M)
    wm = create_whisper_mop(wcfg, generator=torch.Generator().manual_seed(46)).eval()
    with torch.no_grad():
        for m in wm.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                m.weight.mul_(WHISPER_DECODE_SCALE)
    b, n = WHISPER_BATCH["20M"], WHISPER_BEAM_TOKENS
    mel = whisper_batch(wcfg, b, 1)[0]
    (seqs, scores), counts = counted(lambda: whisper_transcribe_beam(
        wm, mel, 1, n, num_beams=WHISPER_BEAMS, return_all=True))
    check(counts == {**none, "flash_attention": wcfg.n_layer_enc}
          and tuple(seqs.shape) == (b, WHISPER_BEAMS, n)
          and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"whisper_transcribe_beam: launches {launched(counts)} (K1 in the "
          f"{wcfg.n_layer_enc} encoder layers), beams {tuple(seqs.shape)}, best scores "
          f"{[round(v, 3) for v in scores[:, 0].tolist()]}")
    _, beam_s = seconds_of(lambda: whisper_transcribe_beam(wm, mel, 1, n,
                                                           num_beams=WHISPER_BEAMS))
    cached, cached_s = seconds_of(lambda: whisper_transcribe_cached(wm, mel, 1, n))
    beam1 = whisper_transcribe_beam(wm, mel, 1, n, num_beams=1)
    wtree = whisper_decode_params(wm)  # the teacher-forced reference's tree, built once
    with torch.no_grad():
        cross_k, cross_v = whisper_decode_prep(wm, mel)
        shape = (wcfg.n_layer_dec, b, wcfg.n_head, n + 1, wcfg.n_embd // wcfg.n_head)
        ks, vs = torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")
        ids = torch.cat([torch.ones_like(cached[:, :1]), cached], 1)
        forced = torch.stack([whisper_decode_token(wm, ids[:, i], i, ks, vs, cross_k, cross_v,
                                                   params=wtree)[0]
                              for i in range(n)], 1)
    ok, ties = tie_prefix(beam1, cached, top2_margin(forced))
    check(ok, f"whisper_transcribe_beam num_beams=1: whisper_transcribe_cached's tokens up to the "
          f"first near tie ({ties} of {n}); beam {b * n / beam_s:.0f} tokens/s, cached greedy "
          f"{b * n / cached_s:.0f} tokens/s [{smi}]")
    try:
        whisper_transcribe_beam(wm, mel, 1, 4, kv_dtype=torch.int8)
        check(False, "whisper_transcribe_beam kv_dtype=int8 raises")
    except ValueError as e:
        check("scales" in str(e), f"whisper_transcribe_beam kv_dtype=int8 raises: {e}")
    del wm, mel

    say("[13 decode] 13d: python -m mop_tpu_torch.cli.generate_text --steps 50 --tokens 32")
    out, cli_s = seconds_of(lambda: generate_text.main(["--steps", "50", "--tokens", "32"]))
    losses = list(out["losses"].values())
    check(losses[-1] < losses[0] and len(out["full"]) == len(out["cached"]) == 16 + 32,
          f"generate_text on the card: loss {losses[0]:.3f} -> {losses[-1]:.3f}, full window "
          f"{out['full']!r} ({out['full_s']:.2f} s), cached {out['cached']!r} "
          f"({out['cached_s']:.2f} s); {cli_s:.1f} s in all [{smi}]")
    return k5_rows


def serve_jobs(n, rs):
    """tools/bench_serving.py's ``mixed_jobs``: n (prompt, new) pairs, each
    prompt of SERVE_PROMPTS[0] to SERVE_PROMPTS[1] - 1 tokens, from ``rs``."""
    return [([int(t) for t in rs.randint(0, SERVE_VOCAB, rs.randint(*SERVE_PROMPTS))],
             SERVE_NEW) for _ in range(n)]


def serve_all(eng, jobs, n_tokens=1):
    """Submit every job, run the engine dry; each job's tokens."""
    rids = [eng.submit(p, n) for p, n in jobs]
    res = eng.run(n_tokens=n_tokens)
    return [res[r] for r in rids]


def fed_greedy(model, params, prompt, n, chunk=None, base=None):
    """The single-stream greedy tokens (1, n) and margins (1, n) of a prompt
    fed through ``decode_chunk`` ``chunk`` tokens at a time from an empty
    cache (the engine's chunked prefill), or from a prefix-cache entry's
    rows ``base = (rows, lcp)`` in one chunk (a prefix-cache hit): a fed
    row standardizes over its live prefix, where a prefill standardizes
    over the whole prompt."""
    cache = init_decode_cache(model.config, 1, n_views=0)
    at = 0
    if base is not None:
        for key, rows in base[0].items():
            cache[key] = rows[:, None].clone()
        at, chunk = base[1], len(prompt)
    cache["len"] = at
    toks = torch.tensor([prompt], device="cuda")
    while at < len(prompt):
        g = min(chunk, len(prompt) - at)
        logits, cache = decode_chunk(model, params, cache, toks[:, at:at + g])
        at += g
    logits = logits[:, -1]
    out, margins = [], []
    for i in range(n):
        margins.append(top2_margin(logits))
        out.append(logits.argmax(-1))
        if i < n - 1:
            logits, cache = decode_step(model, params, cache, out[-1])
    return torch.stack(out, 1), torch.stack(margins, 1)


def stream_checks(model, params, jobs, got):
    """Each engine row against its single-stream ``generate_cached``: equal,
    or equal up to the first near tie of the reference's logits
    (teacher-forced on its tokens). Returns (all ok, rows equal throughout,
    the first ties of the rows that differ)."""
    ok, equal, ties = True, 0, []
    for (prompt, n), row in zip(jobs, got):
        p = torch.tensor([prompt], device="cuda")
        ref = generate_cached(model, params, p, n)
        want = ref[:, len(prompt):]
        g = torch.tensor([row], device="cuda")
        if g.shape == want.shape and torch.equal(g, want):
            equal += 1
            continue
        margins = top2_margin(cached_logits(model, params, ref, len(prompt), n))
        ok_r, first = tie_prefix(g[:, :n], want[:, :g.shape[1]], margins[:, :g.shape[1]])
        ok = ok and ok_r and g.shape == want.shape
        ties.append(first[0])
    return ok, equal, ties


def closed_loop(eng, prompts, new, clients):
    """``clients`` closed-loop users over ``eng``, each submitting its next
    prompt when its last request ends: (requests/s, TTFT s, TPOT s), the
    times per request from the host's clock at each step's return."""
    queue = list(prompts)
    submit_t, first_t, last_t, ntok = {}, {}, {}, {}
    live = set()

    def submit():
        rid = eng.submit(queue.pop(0), new)
        submit_t[rid] = time.perf_counter()
        live.add(rid)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(min(clients, len(queue))):
        submit()
    while live:
        out = eng.step()
        now = time.perf_counter()
        for rid, toks in out.items():
            first_t.setdefault(rid, now)
            last_t[rid] = now
            ntok[rid] = ntok.get(rid, 0) + len(toks)
        for rid in [r for r in live if eng.is_done(r)]:
            live.discard(rid)
            if queue:
                submit()
    wall = time.perf_counter() - t0
    ttft = np.asarray([first_t[r] - submit_t[r] for r in submit_t])
    tpot = np.asarray([(last_t[r] - first_t[r]) / (ntok[r] - 1) for r in submit_t
                       if ntok[r] > 1])
    return len(submit_t) / wall, ttft, tpot


class _IdText:
    """The Whisper model's token ids as text, for the server's
    ``whisper_tokenizer`` (its vocabulary has no text)."""

    @staticmethod
    def decode(ids):
        return " ".join(str(int(t)) for t in ids)


def serving_phases(smi):
    """Phase 14: serving on the card. The GPT engine launches no kernel; the
    Whisper engine's admissions launch K1 in each encoder layer, which add
    to ``launches``."""
    none = {f.__name__: 0 for f in F.KERNELS}
    rs = np.random.RandomState(0)
    say(f"[14 serving] 14a: DecodeEngine at tools/bench_serving.py's GPT-Quartet {SERVE_CFG}, "
        f"vocab {SERVE_VOCAB}, buckets {SERVE_BUCKETS}, max_batch {SERVE_MAX_BATCH}, "
        f"{SERVE_JOBS} mixed jobs of {SERVE_NEW} new tokens")
    t_phase = time.perf_counter()
    model = create_gpt_quartet(SERVE_VOCAB, TransformerConfig(**SERVE_CFG),
                               generator=torch.Generator().manual_seed(50)).eval()
    params = decode_params(model)
    jobs = serve_jobs(SERVE_JOBS, rs)
    eng = DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, prefill_buckets=SERVE_BUCKETS)
    serve_all(eng, [(p[:SERVE_WARM], 4) for p, _ in jobs[:SERVE_MAX_BATCH]])  # warm
    torch.cuda.reset_peak_memory_stats()
    (got, secs), counts = counted(lambda: seconds_of(lambda: serve_all(eng, jobs)))
    n_out = sum(len(g) for g in got)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(counts == none and all(len(g) == SERVE_NEW for g in got),
          f"the engine served {SERVE_JOBS} requests, {n_out} tokens in {secs:.3f} s: "
          f"{n_out / secs:.0f} tokens/s, {eng.engine_steps} engine steps, peak "
          f"{peak:.2f} GiB; kernel launches {launched(counts) or 'none'} (K5 0: plain ops, as "
          f"JAX's decode_step_rows) [{smi}]")
    busy, wall = busy_share(lambda: serve_all(eng, jobs[:SERVE_MAX_BATCH]))
    say(f"  device busy over {SERVE_MAX_BATCH} requests: {100 * busy:.1f}% of {wall:.1f} ms "
        f"(profiled) [{smi}]")
    ok, equal, ties = stream_checks(model, params, jobs, got)
    check(ok, f"each of the {SERVE_JOBS} greedy rows equals its single-stream generate_cached "
          f"up to its first near tie: {equal} equal throughout, the others' first ties at "
          f"{ties}")
    burst = DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, prefill_buckets=SERVE_BUCKETS)
    (multi, multi_s) = seconds_of(lambda: serve_all(burst, jobs, n_tokens=SERVE_BURST))
    check(multi == got, f"step(n_tokens={SERVE_BURST}): the tokens of single steps, "
          f"{n_out / multi_s:.0f} tokens/s in {burst.engine_steps} engine steps [{smi}]")
    some = jobs[:SERVE_MAX_BATCH]
    chunked = DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, chunk_prefill=SERVE_CHUNK)
    got_c = serve_all(chunked, some)
    oks = []
    for (prompt, n), row in zip(some, got_c):
        if len(prompt) > SERVE_CHUNK:  # fed in chunks
            want, margins = fed_greedy(model, params, prompt, n, chunk=SERVE_CHUNK)
        else:  # one monolithic prefill
            ref = generate_cached(model, params, torch.tensor([prompt], device="cuda"), n)
            want = ref[:, len(prompt):]
            margins = top2_margin(cached_logits(model, params, ref, len(prompt), n))
        oks.append(tie_prefix(torch.tensor([row], device="cuda"), want, margins))
    agree = np.mean([a == b for g1, g2 in zip(got_c, got[:SERVE_MAX_BATCH])
                     for a, b in zip(g1, g2)])
    check(all(o for o, _ in oks), f"chunk_prefill {SERVE_CHUNK}: each row equals the "
          f"single-stream {SERVE_CHUNK}-token decode_chunk feed (a prompt of at most "
          f"{SERVE_CHUNK}: generate_cached) up to its first near tie "
          f"({[t[0] for _, t in oks]} of {SERVE_NEW}); {100 * agree:.1f}% of tokens equal "
          "the monolithic prefill's (a fed row standardizes over its live prefix)")
    beam_p = jobs[0][0][:SERVE_WARM]
    beng = DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, max_beams=4)
    rid = beng.submit(beam_p, SERVE_NEW, num_beams=4)
    beam_got = beng.run()[rid]
    want = generate_beam(model, params, torch.tensor([beam_p], device="cuda"), SERVE_NEW,
                         num_beams=4)[0, SERVE_WARM:].tolist()
    check(beam_got == want and not beng._lens.any(),
          f"a 4-beam request: generate_beam's {SERVE_NEW} tokens; the freed slots' lengths 0")
    # the tails' first tokens all differ: every hit reuses exactly the system
    # prompt's rows, which every entry holds as the first prompt's prefill left them
    system = [int(t) for t in rs.randint(0, SERVE_VOCAB, SERVE_SYSTEM)]
    firsts = rs.choice(SERVE_VOCAB, SERVE_MAX_BATCH, replace=False)
    prompts = [system + [int(f)] + [int(t) for t in rs.randint(0, SERVE_VOCAB,
                                                               rs.randint(*SERVE_TAILS) - 1)]
               for f in firsts]
    peng = DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, prefix_cache_entries=4)
    _, first = prefill(model, params, torch.tensor([prompts[0]], device="cuda"))
    base = ({k: first[k][:, 0] for k in peng._pool_keys}, SERVE_SYSTEM)  # a fresh prefill's rows
    oks, ties, cached = [], [], []
    for i, p in enumerate(prompts):
        rid = peng.submit(p, SERVE_PREFIX_NEW)
        cached.append(peng.run()[rid])
        if i > 0:
            want, margins = fed_greedy(model, params, p, SERVE_PREFIX_NEW, base=base)
            ok_r, first_tie = tie_prefix(torch.tensor([cached[-1]], device="cuda"), want, margins)
            oks.append(ok_r)
            ties.append(first_tie[0])
    nocache = serve_all(DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH),
                        [(p, SERVE_PREFIX_NEW) for p in prompts])
    agree = np.mean([a == b for g1, g2 in zip(cached, nocache) for a, b in zip(g1, g2)])
    check(all(oks) and peng.prefix_cache_hits == len(prompts) - 1
          and peng.prefix_tokens_reused == SERVE_SYSTEM * (len(prompts) - 1),
          f"prefix cache, a {SERVE_SYSTEM}-token system prompt: {peng.prefix_cache_hits} hits, "
          f"{peng.prefix_tokens_reused} tokens reused; each hit equals the single-stream feed "
          f"of its tail after a fresh prefill's system rows up to its first near tie ({ties} of "
          f"{SERVE_PREFIX_NEW}); {100 * agree:.1f}% of tokens equal the engine without the cache")
    q8 = DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, prefill_buckets=SERVE_BUCKETS,
                      kv_dtype=torch.int8)
    serve_all(q8, [(p[:SERVE_WARM], 4) for p, _ in some])  # warm
    got8, s8 = seconds_of(lambda: serve_all(q8, some))
    agree = np.mean([a == b for g1, g2 in zip(got8, got[:SERVE_MAX_BATCH])
                     for a, b in zip(g1, g2)])
    check(all(len(g) == SERVE_NEW and 0 <= min(g) and max(g) < SERVE_VOCAB for g in got8),
          f"int8 KV (per-row scales): {sum(map(len, got8)) / s8:.0f} tokens/s over "
          f"{len(some)} requests, {100 * agree:.1f}% of tokens equal fp32 KV's [{smi}]")
    del model, params, eng, burst, chunked, beng, peng, q8
    say(f"  14a took {time.perf_counter() - t_phase:.1f} s")

    say(f"[14 serving] 14b: the 170M of tools/bench_serving_slo.py {SLO_CFG}, vocab "
        f"{SERVE_VOCAB}, {SLO_MB} slots, closed loop of {SLO_MB} users, {SLO_REQS} requests "
        f"of {SLO_PROMPT} + {SLO_NEW} tokens")
    model = create_gpt_quartet(SERVE_VOCAB, TransformerConfig(**SLO_CFG),
                               generator=torch.Generator().manual_seed(51)).eval()
    fp32 = decode_params(model)
    slo_prompts = [[int(t) for t in rs.randint(0, SERVE_VOCAB, SLO_PROMPT)]
                   for _ in range(SLO_REQS)]
    for name, p in (("fp32", fp32), ("int8", quantize_params(fp32))):
        eng = DecodeEngine(model, p, max_batch=SLO_MB, prefill_buckets=[SLO_PROMPT])
        serve_all(eng, [(slo_prompts[0], 2), (slo_prompts[1], 2)])  # warm
        (rps, ttft, tpot), counts = counted(lambda: closed_loop(eng, slo_prompts, SLO_NEW,
                                                                SLO_MB))
        check(counts == none and len(ttft) == SLO_REQS,
              f"170M {name} weights: {rps:.2f} requests/s, TTFT p50 {1e3 * np.median(ttft):.1f} "
              f"ms (p90 {1e3 * np.percentile(ttft, 90):.1f}), TPOT p50 "
              f"{1e3 * np.median(tpot):.2f} ms (p90 {1e3 * np.percentile(tpot, 90):.2f}), "
              f"{rps * SLO_NEW:.0f} tokens/s; launches {launched(counts) or 'none'} [{smi}]")
    del model, fp32, eng

    say(f"[14 serving] 14c: WhisperServingEngine at Whisper_20M, {WHISPER_SERVE_CLIPS} clips, "
        f"{WHISPER_SERVE_TOKENS} tokens, max_batch {WHISPER_SERVE_MB}")
    wcfg = WhisperConfig(**WHISPER_20M)
    wm = create_whisper_mop(wcfg, generator=torch.Generator().manual_seed(52)).eval()
    with torch.no_grad():
        for m in wm.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                m.weight.mul_(WHISPER_DECODE_SCALE)
    mel = whisper_batch(wcfg, WHISPER_SERVE_CLIPS, 1)[0]
    mels = mel.cpu().numpy()
    n = WHISPER_SERVE_TOKENS
    weng = WhisperServingEngine(wm, None, max_batch=WHISPER_SERVE_MB, bos_token=1)
    wtree = whisper_decode_params(wm)  # the teacher-forced references' tree, built once
    (res, wsecs), counts = counted(lambda: seconds_of(lambda: [
        weng.submit(m, n) for m in mels] and weng.run()))
    got = torch.tensor([res[r] for r in sorted(res)], device="cuda")
    want_k1 = wcfg.n_layer_enc * WHISPER_SERVE_CLIPS

    def probe():  # a fresh engine with 2 admissions queued, run under the profile
        eng = WhisperServingEngine(wm, None, max_batch=WHISPER_SERVE_MB, bos_token=1)
        for m in mels[:2]:
            eng.submit(m, 2)
        return eng.run

    records, counts_p, _ = profiled_records(None, {"flash_attention": "flash_fwd"}, setup=probe)
    k1_records, k1_probe = records["flash_attention"], counts_p["flash_attention"]
    check(counts == {**none, "flash_attention": want_k1}
          and k1_records == k1_probe == 2 * wcfg.n_layer_enc,
          f"{WHISPER_SERVE_CLIPS} admissions: launches {launched(counts)}, K1 "
          f"{wcfg.n_layer_enc} a clip (the encoder layers), none in the decode steps; a "
          f"profile of 2 admissions: {k1_records} K1 kernel records, {k1_probe} launches; "
          f"{WHISPER_SERVE_CLIPS * n / wsecs:.0f} tokens/s [{smi}]")
    # an admission's K1 shape, (1, H, T_enc, dh), against the plain version;
    # then one admission's encoder output on the K1 route against the plain route
    gw = cuda_generator(7)
    k1_shape = (1, wcfg.n_head, wcfg.n_audio_ctx, wcfg.n_embd // wcfg.n_head)
    with torch.inference_mode():
        q, k, v = (torch.randn(*k1_shape, device="cuda", generator=gw) for _ in range(3))
        compare(f"K1 at a Whisper admission's {k1_shape} float32 vs plain",
                F.flash_attention(q, k, v), F.flash_attention_plain(q, k, v), 2e-5, 0.0)
        enc = whisper_encode(wm, mel[:1])
        with plain_kernels():
            enc_plain = whisper_encode(wm, mel[:1])
        compare("an admission's encoder output, K1 route vs plain route", enc, enc_plain,
                2e-5, 2e-4)
    del q, k, v, enc, enc_plain
    ref = whisper_transcribe_cached(wm, mel, 1, n)
    with torch.no_grad():
        cross_k, cross_v = whisper_decode_prep(wm, mel)
        shape = (wcfg.n_layer_dec, WHISPER_SERVE_CLIPS, wcfg.n_head, n + 1,
                 wcfg.n_embd // wcfg.n_head)
        ks, vs = torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")
        ids = torch.cat([torch.ones_like(ref[:, :1]), ref], 1)
        forced = torch.stack([whisper_decode_token(wm, ids[:, i], i, ks, vs, cross_k, cross_v,
                                                   params=wtree)[0]
                              for i in range(n)], 1)
    ok, ties = tie_prefix(got, ref, top2_margin(forced))
    check(ok and len(set(ref.flatten().tolist())) > 2,
          f"each clip's tokens equal whisper_transcribe_cached's up to the first near tie "
          f"({ties} of {n}); {sum(torch.equal(a, b) for a, b in zip(got, ref))} of "
          f"{WHISPER_SERVE_CLIPS} equal throughout")
    q8 = WhisperServingEngine(wm, quantize_params(whisper_decode_params(wm)),
                              max_batch=WHISPER_SERVE_MB, bos_token=1)
    (res8, s8), counts = counted(lambda: seconds_of(lambda: [
        q8.submit(m, n) for m in mels] and q8.run()))
    got8 = torch.tensor([res8[r] for r in sorted(res8)], device="cuda")
    check(counts == {**none, "flash_attention": want_k1} and tuple(got8.shape) == tuple(ref.shape),
          f"int8 weights: launches {launched(counts)}, {WHISPER_SERVE_CLIPS * n / s8:.0f} "
          f"tokens/s, {100 * (got8 == ref).float().mean().item():.1f}% of tokens equal fp32's "
          f"[{smi}]")

    say(f"[14 serving] 14d: python -m mop_tpu_torch.cli.serve_http {' '.join(SERVE_HTTP_ARGS)} "
        "with the 14c Whisper engine behind /v1/audio/transcriptions")
    audio = np.random.default_rng(53).standard_normal(16000 * 3).astype(np.float32) * 0.1
    seg = segment_frames(log_mel(audio, 16000, n_mels=wcfg.n_mels), wcfg.n_audio_ctx)
    win = wcfg.n_text_ctx - 1  # the server's budget for a window
    seg_t = torch.from_numpy(np.stack(seg)).cuda()
    ref = whisper_transcribe_cached(wm, seg_t, 1, win)
    (out, http_s), counts = counted(lambda: seconds_of(lambda: serve_http.run(
        serve_http._parser().parse_args(SERVE_HTTP_ARGS), whisper_engine=weng,
        whisper_tokenizer=_IdText(), audio=audio)))
    heard = torch.tensor([[int(t) for t in out["transcription"].split()]], device="cuda")
    with torch.no_grad():
        cross_k, cross_v = whisper_decode_prep(wm, seg_t)
        shape = (wcfg.n_layer_dec, len(seg), wcfg.n_head, win + 1, wcfg.n_embd // wcfg.n_head)
        ks, vs = torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")
        ids = torch.cat([torch.ones_like(ref[:, :1]), ref], 1)
        forced = torch.stack([whisper_decode_token(wm, ids[:, i], i, ks, vs, cross_k, cross_v,
                                                   params=wtree)[0]
                              for i in range(win)], 1)
    ok_audio, ties = tie_prefix(heard.reshape(ref.shape), ref, top2_margin(forced))
    m = out["metrics"]
    check(out["drained"] and all(out["texts"]) and len(out["texts"]) == 8
          and out["completion"]["finish_reason"] in ("stop", "length")
          and len(out["embeddings"]) == 2 and ok_audio
          and int(m.get("mop_ttft_seconds_count", 0)) >= 8
          and int(m.get("mop_tpot_seconds_count", 0)) >= 8,
          f"serve_http on the card: 8 concurrent text clients, a stream, /v1/completions "
          f"({out['completion']['finish_reason']}), /v1/embeddings ({len(out['embeddings'])} x "
          f"{len(out['embeddings'][0])}), /v1/audio/transcriptions equal to "
          f"whisper_transcribe_cached's {win} tokens up to the first near tie ({ties}); "
          f"/metrics TTFT {m.get('mop_ttft_seconds_count')} and TPOT "
          f"{m.get('mop_tpot_seconds_count')} observations; drained {out['drained']}; loss "
          f"{out['loss']:.3f}; launches {launched(counts)} (K5: the LM's training, K1: the "
          f"audio's encoder); {http_s:.1f} s [{smi}]")
    say(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------- phase 15: the trainer and the later CLIs -------------------------


def _batch15(i):
    """Step i's batch of 15a: uint8 CIFAR-shaped images and CIFAR-100 labels
    from a numpy generator seeded with i (a function of the step, so that a
    resumed run sees what an uninterrupted one saw)."""
    rng = np.random.default_rng(TRAINER_DATA_SEED + i)
    return (rng.integers(0, 256, (BATCH, 3, 32, 32), dtype=np.uint8),
            rng.integers(0, N_CLASSES, (BATCH,)).astype(np.int64))


def _val15():
    rng = np.random.default_rng(TRAINER_DATA_SEED - 1)
    return [(rng.integers(0, 256, (BATCH, 3, 32, 32), dtype=np.uint8),
             rng.integers(0, N_CLASSES, (BATCH,)).astype(np.int64),
             np.ones(BATCH, np.float32)) for _ in range(TRAINER_VAL)]


def forward_flops(model, x, attn_calls, heads):
    """Flops of one forward: 2 x the multiply-adds of every Linear and
    Conv2d (from their outputs' sizes) and K1's products (``flash_cost``) at
    each of ``attn_calls`` launches over ``heads`` heads; the MoP gate's
    elementwise work is not counted."""
    total = [0]

    def linear(m, _, out):
        total[0] += 2 * m.in_features * out.numel()

    def conv(m, _, out):
        total[0] += 2 * (m.in_channels // m.groups) * math.prod(m.kernel_size) * out.numel()

    hooks = [m.register_forward_hook(linear if isinstance(m, torch.nn.Linear) else conv)
             for m in model.modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    n, dim = 64, model.cls.in_features  # 32 x 32 images in 4 x 4 patches
    attn = flash_cost(x.shape[0] * heads, n, n, dim // heads, x.dtype)[0]
    return total[0] + attn_calls * attn


def trainer_phase(smi, work):
    """15a: ``train_model`` at B_bench's width: an uninterrupted run, a run
    preempted through its guard, its resume (equal to the uninterrupted run
    bit for bit), K1's launches by the profiler under the port's ``trace()``,
    and ``Trainer.step``'s images/s by the port's ``ThroughputMeter`` with
    the MFU. Returns the launches of the three runs."""
    import mop_tpu_torch.training.trainer as trainer_mod
    from mop_tpu_torch.training import AsyncCheckpointManager, Trainer, cosine_lr, train_model
    from mop_tpu_torch.utils.profiling import ThroughputMeter, chip_peak_bf16_flops, trace

    make = MODELS["B_bench"][0]
    depth = 6
    val = _val15()
    guards = []

    class RecordedGuard(trainer_mod.PreemptionGuard):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            guards.append(self)

    def batches(start, signal_at=None):
        for i in range(start, TRAINER_STEPS):
            if i == signal_at:
                guards[-1].signal_now()
            yield _batch15(i)

    def run(ckpt_dir, start=0, signal_at=None, resume=False):
        return train_model(make(None), batches(start, signal_at), lambda: iter(val),
                           TRAINER_STEPS, batch_size=BATCH, eval_every=TRAINER_EVERY, seed=0,
                           mean=CIFAR100_MEAN, std=CIFAR100_STD, verbose=False,
                           ckpt_dir=ckpt_dir, ckpt_every=TRAINER_EVERY, resume=resume)

    say(f"[15a trainer] train_model: B_bench (224/6/4, 5 views, 3 kernels), batch {BATCH}, "
        f"bf16, {TRAINER_STEPS} steps, eval and checkpoint every {TRAINER_EVERY}")
    totals = {f.__name__: 0 for f in F.KERNELS}
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    guard_cls, trainer_mod.PreemptionGuard = trainer_mod.PreemptionGuard, RecordedGuard
    try:
        with tempfile.TemporaryDirectory(dir=work) as ckpt:
            t0 = time.perf_counter()
            (model_u, hist_u), counts = counted(lambda: run(os.path.join(ckpt, "u")), add=False)
            wall_u = time.perf_counter() - t0
            for k, c in counts.items():
                totals[k] += c
            # init's check forward, then a step's and a val batch's.
            want_k1 = depth * (1 + TRAINER_STEPS + (TRAINER_STEPS // TRAINER_EVERY) * TRAINER_VAL)
            with AsyncCheckpointManager(os.path.join(ckpt, "u")) as mgr:
                steps_u = mgr.all_steps()
            check(sorted(hist_u) == ["time_min", "train_loss", "val_acc"]
                  and len(hist_u["train_loss"]) == TRAINER_STEPS
                  and len(hist_u["val_acc"]) == TRAINER_STEPS // TRAINER_EVERY
                  and all(math.isfinite(v) for v in hist_u["train_loss"])
                  and steps_u == [TRAINER_STEPS - TRAINER_EVERY, TRAINER_STEPS]
                  and counts["flash_attention"] == want_k1 and sum(counts.values()) == want_k1,
                  f"uninterrupted: {TRAINER_STEPS} losses {hist_u['train_loss'][0]:.4f} .. "
                  f"{hist_u['train_loss'][-1]:.4f}, val acc {hist_u['val_acc']}, checkpoints "
                  f"{steps_u}; launches {launched(counts)} (expected K1 {want_k1}: {depth} in init's "
                  f"check forward, a step and a val batch); {wall_u:.2f} s wall [{smi}]")

            code = None
            F.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                run(os.path.join(ckpt, "p"), signal_at=TRAINER_STOP - 1)
            except SystemExit as e:  # the guard's exit, checked below
                code = e.code
            torch.cuda.synchronize()
            counts = {f.__name__: f.launches for f in F.KERNELS}
            for k, c in counts.items():
                totals[k] += c
            with AsyncCheckpointManager(os.path.join(ckpt, "p")) as mgr:
                steps_p = mgr.all_steps()
            check(code == 75 and steps_p == [TRAINER_EVERY, TRAINER_STOP],
                  f"preempted through guard.signal_now() in step {TRAINER_STOP - 1}: exit code "
                  f"{code} (75 expected), checkpoints {steps_p}; "
                  f"{time.perf_counter() - t0:.2f} s [{smi}]")

            t0 = time.perf_counter()
            (model_r, hist_r), counts = counted(
                lambda: run(os.path.join(ckpt, "p"), start=TRAINER_STOP, resume=True), add=False)
            for k, c in counts.items():
                totals[k] += c
            diffs = [(a.float() - b.float()).abs().max().item()
                     for a, b in zip(model_r.state_dict().values(), model_u.state_dict().values())]
            same = (hist_r["train_loss"] == hist_u["train_loss"][TRAINER_STOP:]
                    and all(torch.equal(a, b) for a, b in zip(model_r.state_dict().values(),
                                                              model_u.state_dict().values())))
            check(same, f"resumed at step {TRAINER_STOP}: {len(hist_r['train_loss'])} steps, "
                  f"final loss {hist_r['train_loss'][-1]!r} vs the uninterrupted run's "
                  f"{hist_u['train_loss'][-1]!r}; every parameter bit-equal (largest "
                  f"difference {max(diffs):.3e}); {time.perf_counter() - t0:.2f} s [{smi}]")
            del model_r
    finally:
        trainer_mod.PreemptionGuard = guard_cls
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1])

    # Trainer.step's throughput, and K1 in a traced window of steps and an eval.
    trainer = Trainer(model_u, mean=CIFAR100_MEAN, std=CIFAR100_STD)
    trainer.setup_optimizer(cosine_lr(3e-3, 1, 1000), weight_decay=0.05)
    data = [_batch15(i) for i in range(4)]
    step_i = [0]

    def one_step():
        x, y = data[step_i[0] % len(data)]
        step_i[0] += 1
        return trainer.step(x, y, seed=0, step_i=step_i[0])

    traced = 3
    log_dir = tempfile.mkdtemp(prefix="trace15_", dir=work)
    records, counts, _ = profiled_records(
        lambda: ([one_step() for _ in range(traced)], trainer.evaluate(val)),
        {"flash_attention": "flash_fwd"}, make_profiler=lambda: trace(log_dir))
    events = json.load(open(os.path.join(log_dir, "trace.json")))["traceEvents"]
    host = sum(1 for e in events if e.get("cat") == "cpu_op")
    device = sum(1 for e in events if e.get("cat") == "kernel")
    want = depth * (traced + TRAINER_VAL)
    check(records["flash_attention"] == counts["flash_attention"] == want and host and device,
          f"under mop_tpu_torch.utils.profiling.trace(): {traced} Trainer.steps and an evaluate "
          f"({TRAINER_VAL} batches): K1 {records['flash_attention']} kernel records, "
          f"{counts['flash_attention']} launches, {want} expected ({depth} a step and a val "
          f"batch); the Chrome trace holds {host} host ops and {device} kernels [{smi}]")
    for k, c in counts.items():
        totals[k] += c

    meter = ThroughputMeter(warmup_steps=5)

    def timed():
        for _ in range(5 + TRAINER_TIMED):
            one_step()
            meter.step(BATCH)
        return meter.samples_per_sec, meter.steps_per_sec

    (ips, sps), counts = counted(timed, add=False)
    (rows, wall_us), counts2 = counted(lambda: device_breakdown(one_step, reps=10), add=False)
    for k in totals:
        totals[k] += counts[k] + counts2[k]
    busy = sum(t for _, t in rows)
    x = cifar_eval_transform(torch.as_tensor(data[0][0]).cuda(), CIFAR100_MEAN, CIFAR100_STD)
    step_flops = 3 * forward_flops(trainer.model, x, depth, heads=4)
    peak = chip_peak_bf16_flops()
    mfu = f"{100 * step_flops * sps / peak:.2f}%" if peak else "not measured (unknown card)"
    say(f"  Trainer.step, B_bench bf16 batch {BATCH}: {ips:,.0f} images/s, "
        f"{1e3 / sps:.2f} ms a step (ThroughputMeter, {TRAINER_TIMED} steps after 5); device "
        f"busy {100 * busy / wall_us:.1f}% of 10 profiled steps ({by_class(rows)}); "
        f"{step_flops / 1e12:.3f} TFLOP a step (3 x the forward's Linear, Conv2d and K1 "
        f"flops), MFU {mfu} of chip_peak_bf16_flops() {peak} [{smi}]")
    return totals


def _csv_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [dict(zip(lines[0].split(","), ln.split(","))) for ln in lines[1:]]


def cli_phase(smi, work, ab5_out):
    """15b: the later CLIs on the card at the 5M target, each with its
    kernels' launches predicted from the matched depths and held to the
    wrapper counts and the profiler's records; then ``ab5_paper_benchmark``
    over phase 10's and the tournament's CSVs. Returns the launches."""
    from mop_tpu_torch.experiments import _param_budgets as PB
    from mop_tpu_torch.experiments import ab5_paper_benchmark, ab5_tournament, cifar10_multi_seed
    from mop_tpu_torch.experiments import cifar100_ab4_param_budgets as ab4
    from mop_tpu_torch.experiments import cifar10_twohop_param_budgets as twohop

    out = os.path.join(work, "clis15")
    k1, k4 = "flash_attention", K4
    names = {k1: "flash_fwd", k4: "multihop"}
    steps, every = CLI15_STEPS, CLI15_STEPS
    evals = 2  # the lockstep evals: step 1 and every ``every`` steps
    argv = ["--synthetic", "--tiny", "--seeds", "0", "--steps", str(steps), "--eval_every",
            str(every), "--batch", str(BATCH), "--out", out]

    def n_batches(dataset, val_frac=0.0):
        _, val_b, test_b, *_ = harness.get_loaders(dataset, BATCH, tiny=True, val_frac=val_frac,
                                                   synthetic=True)
        return len(list(val_b())), len(list(test_b()))

    n100, _ = n_batches("cifar100")
    n10, _ = n_batches("cifar10")
    n_val5, n_test5 = n_batches("cifar100", 0.1)
    totals = {f.__name__: 0 for f in F.KERNELS}

    def drive(label, fn, want):
        t0 = time.perf_counter()
        records, counts, _ = profiled_records(fn, names)
        wall = time.perf_counter() - t0
        for k, c in counts.items():
            totals[k] += c
        got = {k: counts[k] for k in names}
        check(got == records == want and sum(counts.values()) == sum(want.values()),
              f"{label}: launches {launched(counts)}, profiler records {records}, predicted "
              f"{want}; {wall:.2f} s with the profiler [{smi}]")

    # ab4: A and B through K1 in every step and eval forward, D through K4 in
    # its eval forwards (it trains composed), C with no kernel.
    a4 = ab4.build_argparser().parse_args(argv + ["--targets", "5000000"])
    cfgs = PB.match_configs(a4, 100, 5_000_000, ab4.FAMILIES)
    depth = {f: c[0]["depth"] for f, c in cfgs.items()}
    fwds = (evals + 1) * n100
    say(f"[15b CLIs] cifar100_ab4_param_budgets --targets 5000000: "
        f"{ {f: (c[0]['dim'], c[0]['depth'], c[0]['heads']) for f, c in cfgs.items()} }; "
        f"{steps} steps, {fwds} eval forwards a model")
    drive("cifar100_ab4_param_budgets", lambda: ab4.main(argv + ["--targets", "5000000"]),
          {k1: (depth["base"] + depth["mop"]) * (steps + fwds), k4: depth["multihop"] * fwds})
    header, rows = _csv_rows(os.path.join(out, "cifar100_ab4_target_5000000.csv"))
    check(header == "seed,acc_base,acc_mop,acc_xview,acc_multihop,params_base,params_mop,"
          "params_xview,params_multihop,base_cfg,mop_cfg,xview_cfg,xview_extra,multihop_cfg,"
          "multihop_extra" and len(rows) == 1
          and all(0.0 <= float(rows[0][f"acc_{f}"]) <= 1.0 for f in ab4.FAMILIES),
          f"cifar100_ab4_target_5000000.csv: {header[:40]}...; accs "
          f"{[rows[0][f'acc_{f}'] for f in ab4.FAMILIES]}")

    # twohop: ViTGated trains composed, K4 at two hops in its eval forwards.
    a2 = twohop.build_argparser().parse_args(argv + ["--targets", "5000000"])
    cfg, _ = twohop.match_config(a2, 10, 5_000_000)
    fwds = (evals + 1) * n10
    drive(f"cifar10_twohop_param_budgets at {cfg}",
          lambda: twohop.main(argv + ["--targets", "5000000"]),
          {k1: 0, k4: cfg["depth"] * fwds})
    header, rows = _csv_rows(os.path.join(out, "cifar10_twohop_target_5000000.csv"))
    check(header == "seed,acc" and len(rows) == 1 and 0.0 <= float(rows[0]["acc"]) <= 1.0,
          f"cifar10_twohop_target_5000000.csv: {header}, {rows}")

    # multi_seed: A and B at 256 / 6 / 4 through K1, and the last seed's
    # per-sample pass for McNemar.
    fwds = (evals + 2) * n10
    drive("cifar10_multi_seed (256 / 6 / 4)", lambda: cifar10_multi_seed.main(argv),
          {k1: 2 * 6 * (steps + fwds), k4: 0})
    header, rows = _csv_rows(os.path.join(out, "cifar10_acc.csv"))
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    check(header == "seed,baseline,mop,diff" and len(rows) == 1
          and {"mcnemar_chi2", "delta_acc_lo", "test_acc_A"} <= set(summary),
          f"cifar10_acc.csv: {header}, {rows}; summary.json {sorted(summary)}")

    # The tournament: its plan, then A and B trained through the ab5 harness.
    ab5_tournament.main(["--plan_only", "--out", out])
    with open(os.path.join(out, "tournament_plan_5000000.txt")) as f:
        plan = f.read().splitlines()
    check([ln.split(":")[0] for ln in plan] == list("ABCDE"),
          f"ab5_tournament --plan_only: {plan}")
    ta = ab5_tournament.build_argparser().parse_args(
        argv + ["--targets", "5000000", "--models", "A", "B"])
    cfgs5 = ab5.match_configs(ta, 5_000_000)
    fwds = (evals + 1) * n_val5 + 2 * n_test5
    drive("ab5_tournament --models A B --targets 5000000",
          lambda: ab5_tournament.main(argv + ["--targets", "5000000", "--models", "A", "B"]),
          {k1: (cfgs5["A"][0]["depth"] + cfgs5["B"][0]["depth"]) * (steps + fwds), k4: 0})

    # The paper tables over phase 10's ab5 CSVs and the tournament's.
    res = ab5_paper_benchmark.main(["--inputs", ab5_out, out, "--out_dir", out])
    with open(os.path.join(out, "ab5_benchmark.md")) as f:
        md = f.read().splitlines()
    row = next((r for r in md if r.startswith("| 5000000 |")), "")
    accs = {}
    for path in (os.path.join(ab5_out, "cifar100_ab5_target_5000000.csv"),
                 os.path.join(out, "tournament_target_5000000.csv")):
        for r in _csv_rows(path)[1]:
            for k, v in r.items():
                if k.startswith("acc_"):
                    accs.setdefault(k[4:], []).append(float(v))
    cells = [f"{np.mean(accs[k]):.4f}±{np.std(accs[k]):.4f}" if k in accs else "-"
             for k in "ABCDE"]
    check(row == "| 5000000 | " + " | ".join(cells) + " |" and len(accs["A"]) == 2,
          f"ab5_paper_benchmark: {row!r}, the CSVs' means {cells} (A and B over "
          f"{len(accs['A'])} runs); targets {sorted(res)}")
    return totals


# ------------------- phase 16: paged and speculative serving, export -------------------


class _RecordedPaged(PagedDecodeEngine):
    """The paged engine, recording each preemption as (rid, tokens it had
    emitted): its re-admission prefills the prompt and those tokens."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.preempted = []

    def _preempt_slot(self, victim):
        rid = self._slot_rid[victim]
        self.preempted.append((rid, len(self._results[rid])))
        super()._preempt_slot(victim)


def readmitted_greedy(model, params, prompt, n, at):
    """The single-stream greedy tokens (1, n) and margins (1, n) of a paged
    request preempted when it had emitted k tokens, for each k of ``at``:
    a prefill of the prompt, decode steps, and at each k a prefill of the
    prompt and its first k tokens (its re-admission)."""
    seq = list(prompt)
    toks, margins = [], []
    for i in range(n):
        if i == 0 or i in at:
            logits, cache = prefill(model, params, torch.tensor([seq], device="cuda"))
        else:
            logits, cache = decode_step(model, params, cache, toks[-1])
        margins.append(top2_margin(logits))
        toks.append(logits.argmax(-1))
        seq.append(int(toks[-1]))
    return torch.stack(toks, 1), torch.stack(margins, 1)


def lp_margins(eng, rids):
    """Each row's top-two logit margins (B, T) from an engine's recorded
    top-2 logprobs (log-softmax keeps the logits' differences)."""
    return torch.tensor([[a[0][1] - a[1][1] for a in eng.top_logprobs[r]] for r in rids],
                        device="cuda")


def paged_phase(smi, none):
    """16a: tools/bench_serving.py's engines, dense against paged at the dense
    slabs' capacity and at half of it."""
    rs = np.random.RandomState(0)  # phase 14a's jobs
    say(f"[16 serving] 16a: PagedDecodeEngine at tools/bench_serving.py's GPT-Quartet "
        f"{SERVE_CFG}, vocab {SERVE_VOCAB}, buckets {SERVE_BUCKETS}, max_batch "
        f"{SERVE_MAX_BATCH}, {SERVE_JOBS} mixed jobs of {SERVE_NEW} new tokens; pages of "
        f"{PAGED_PS} rows, {PAGED_PAGES} pages")
    model = create_gpt_quartet(SERVE_VOCAB, TransformerConfig(**SERVE_CFG),
                               generator=torch.Generator().manual_seed(50)).eval()
    params = decode_params(model)
    jobs = serve_jobs(SERVE_JOBS, rs)
    warm = [(p[:SERVE_WARM], 4) for p, _ in jobs[:SERVE_MAX_BATCH]]
    # every engine records each token's top-2 logprobs: the dense engine's are
    # the reference's near-tie margins, and the three are timed alike
    engines = {"dense": lambda: DecodeEngine(model, params, max_batch=SERVE_MAX_BATCH,
                                             prefill_buckets=SERVE_BUCKETS, logprobs_topk=2)}
    for n_pages in PAGED_PAGES:
        engines[f"paged {n_pages}"] = functools.partial(
            _RecordedPaged, model, params, max_batch=SERVE_MAX_BATCH, n_pages=n_pages,
            page_size=PAGED_PS, prefill_buckets=SERVE_BUCKETS, logprobs_topk=2)
    runs = {}
    for label, make in engines.items():
        eng = make()
        serve_all(eng, warm)
        base = eng._next_rid
        eng.engine_steps = 0  # count the jobs' run alone
        if label != "dense":
            eng.preemptions, eng.peak_pages_in_use, eng.preempted = 0, 0, []
        torch.cuda.reset_peak_memory_stats()
        (got, secs), counts = counted(lambda: seconds_of(lambda: serve_all(eng, jobs)))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = eng.engine_steps
        pre = (eng.preemptions, eng.peak_pages_in_use, list(eng.preempted)) \
            if label != "dense" else None
        margins = lp_margins(eng, range(base, base + SERVE_JOBS))
        busy, wall = busy_share(lambda: serve_all(eng, jobs[:SERVE_MAX_BATCH]))
        n_out = sum(len(g) for g in got)
        extra = "" if pre is None else (f", peak_pages_in_use {pre[1]} of {eng.n_pages}, "
                                        f"preemptions {pre[0]}, cache {eng.cache_bytes()} B "
                                        f"(dense slabs {eng.dense_equivalent_bytes()} B)")
        check(counts == none and all(len(g) == SERVE_NEW for g in got),
              f"{label}: {n_out} tokens in {secs:.3f} s, {n_out / secs:.1f} tokens/s (top-2 "
              f"logprobs tracked), {steps} engine steps, busy {100 * busy:.1f}% of "
              f"{wall:.1f} ms over {SERVE_MAX_BATCH} requests (profiled), peak {peak:.3f} "
              f"GiB{extra}; kernel launches {launched(counts) or 'none'} (K5 0) [{smi}]")
        runs[label] = (eng, torch.tensor(got, device="cuda"), pre, margins)
    _, want, _, margins = runs["dense"]
    big, small = (f"paged {n}" for n in PAGED_PAGES)
    ok, ties = tie_prefix(runs[big][1], want, margins)
    check(ok and runs[big][2][0] == 0,
          f"{big}: no preemption; every row equals the dense engine's up to its first near "
          f"tie ({sum(t == SERVE_NEW for t in ties)} of {SERVE_JOBS} rows without one; "
          f"{int((runs[big][1] == want).all(1).sum())} equal throughout)")
    eng, got, (n_pre, peak_pages, preempted), _ = runs[small]
    dk = SERVE_CFG["n_embd"] // SERVE_CFG["n_head"]
    per_row = 3 * SERVE_CFG["n_layer"] * SERVE_CFG["n_head"] * dk * 4  # K/K2/V, fp32
    check(eng.cache_bytes() == per_row * (PAGED_PAGES[1] + 1) * PAGED_PS
          and eng.dense_equivalent_bytes() == per_row * SERVE_MAX_BATCH * SERVE_CFG["block_size"]
          and n_pre > 0 and peak_pages == PAGED_PAGES[1],
          f"{small}: cache_bytes {eng.cache_bytes() / 1e6:.2f} MB ({PAGED_PAGES[1]} pages and "
          f"the scratch page) against dense_equivalent_bytes "
          f"{eng.dense_equivalent_bytes() / 1e6:.2f} MB; {n_pre} preemptions, the pool full")
    at = {}
    for rid, k in preempted:
        at.setdefault(rid - SERVE_MAX_BATCH, set()).add(k)  # the warm-up took the first rids
    oks, firsts = [], []
    for i, (prompt, n) in enumerate(jobs):
        if i in at:  # re-admitted: its prefix re-prefilled, the state its reference builds
            ref_t, ref_m = readmitted_greedy(model, params, prompt, n, at[i])
            ok_r, first = tie_prefix(got[i:i + 1], ref_t, ref_m)
        else:
            ok_r, first = tie_prefix(got[i:i + 1], want[i:i + 1], margins[i:i + 1])
        oks.append(ok_r)
        firsts.append(first[0])
    agree = (got == want).float().mean().item()
    check(all(oks), f"{small}: each of the {SERVE_JOBS - len(at)} rows never preempted equals the "
          f"dense engine's, and each of the {len(at)} preempted rows its single stream "
          f"re-prefilled at its preemptions ({sorted(at.items())[:4]}...), up to its first near "
          f"tie ({firsts}); {100 * agree:.1f}% of tokens equal the dense engine's")
    burst = PagedDecodeEngine(model, params, max_batch=SERVE_MAX_BATCH, n_pages=PAGED_PAGES[0],
                              page_size=PAGED_PS, prefill_buckets=SERVE_BUCKETS)
    (multi, multi_s), counts = counted(lambda: seconds_of(
        lambda: serve_all(burst, jobs, n_tokens=SERVE_BURST)))
    check(torch.equal(torch.tensor(multi, device="cuda"), runs[big][1]) and counts == none,
          f"{big} step(n_tokens={SERVE_BURST}): the tokens of single steps, "
          f"{SERVE_JOBS * SERVE_NEW / multi_s:.1f} tokens/s in {burst.engine_steps} engine "
          f"steps, peak_pages_in_use {burst.peak_pages_in_use} [{smi}]")


def spec_phase(smi, none):
    """16b: SpecDecodeEngine at tools/bench_speculative.py's 170M target and
    2 x 128 draft, against the plain engine, and with the target as its own
    draft."""
    rs = np.random.RandomState(1)
    say(f"[16 serving] 16b: SpecDecodeEngine, target {DECODE_170M}, draft {DECODE_DRAFT}, vocab "
        f"{SERVE_VOCAB}, {SPEC_MB} slots, {SPEC_REQS} requests of {SPEC_T0} + {SPEC_NEW} "
        f"tokens, gamma {SPEC_GAMMA}")
    t0 = time.perf_counter()
    target = create_gpt_quartet(SERVE_VOCAB, TransformerConfig(**DECODE_170M),
                                generator=torch.Generator().manual_seed(60)).eval()
    draft = create_gpt_quartet(SERVE_VOCAB, TransformerConfig(**DECODE_DRAFT),
                               generator=torch.Generator().manual_seed(61)).eval()
    tp, dp = decode_params(target), decode_params(draft)
    say(f"  target and draft built in {time.perf_counter() - t0:.1f} s")
    jobs = [([int(t) for t in rs.randint(0, SERVE_VOCAB, SPEC_T0)], SPEC_NEW)
            for _ in range(SPEC_REQS)]
    plain = DecodeEngine(target, tp, max_batch=SPEC_MB, prefill_buckets=[SPEC_T0],
                         logprobs_topk=2)
    serve_all(plain, jobs[:2])  # warm
    base = plain._next_rid
    plain.engine_steps = 0
    (want, plain_s), counts = counted(lambda: seconds_of(lambda: serve_all(plain, jobs)))
    want = torch.tensor(want, device="cuda")
    margins = lp_margins(plain, range(base, base + SPEC_REQS))
    check(counts == none, f"the plain engine: {SPEC_REQS * SPEC_NEW / plain_s:.1f} tokens/s "
          f"(logprobs tracked), {plain.engine_steps} engine steps [{smi}]")
    bound = 1 + -(-(SPEC_NEW - 1) // (SPEC_GAMMA + 1))
    for label, d, d_params in (("the 2 x 128 draft", draft, dp), ("draft = target", target, tp)):
        eng = SpecDecodeEngine(target, tp, d, d_params, max_batch=SPEC_MB, gamma=SPEC_GAMMA,
                               prefill_buckets=[SPEC_T0])
        serve_all(eng, jobs[:2])  # warm
        eng.engine_steps = eng.drafts_proposed = eng.drafts_accepted = 0
        steps = {}

        def run():
            rids = [eng.submit(p, n) for p, n in jobs]
            while eng.n_queued or eng.n_active:
                for rid in eng.step():
                    steps[rid] = steps.get(rid, 0) + 1
            return [eng.results[r] for r in rids]

        (got, secs), counts = counted(lambda: seconds_of(run))
        got = torch.tensor(got, device="cuda")
        n_steps, accepted, proposed = eng.engine_steps, eng.drafts_accepted, eng.drafts_proposed
        share = accepted / max(proposed, 1)
        perfect = d is target
        busy = ""
        if not perfect:  # one profile of the phase's speculative rounds
            b, w = busy_share(lambda: serve_all(eng, jobs[:SPEC_MB]))
            busy = f", busy {100 * b:.1f}% of {w:.1f} ms over {SPEC_MB} requests (profiled)"
        ok, ties = tie_prefix(got, want, margins)
        check(ok and counts == none and (not perfect or (
            accepted == proposed and max(steps.values()) <= bound)),
              f"{label}: {SPEC_REQS * SPEC_NEW / secs:.1f} tokens/s, {n_steps} engine steps, "
              f"acceptance {100 * share:.1f}% ({accepted} of {proposed} drafts), at most "
              f"{max(steps.values())} steps a request"
              + (f" (bound {bound})" if perfect else "")
              + busy + "; every row equals the plain engine's up to its first near tie "
              f"({sum(t == SPEC_NEW for t in ties)} of {SPEC_REQS} rows without one); launches "
              f"{launched(counts) or 'none'} [{smi}]")


def export_phase(smi, none):
    """16c: export_apply on the card: A and the Quartet LM through K1 and K5
    as registered ops (refused without ``allow_custom_calls``), E and D at
    depth 2 through K2 and K4; each artifact against the eager forward."""
    say("[16 export] 16c: export_apply / load_exported of A, the Quartet LM, E and D (depth 2) "
        "on the card")
    gx = cuda_generator(70)
    x = torch.randn(BATCH, 3, 32, 32, device="cuda", generator=gx)
    tok = torch.randint(0, LM_VOCAB, (LM_BATCH, LM_CONFIG["block_size"]), device="cuda",
                        generator=gx)
    cases = [
        ("A", MODELS["A"][0](torch.Generator().manual_seed(71)), x, "flash_attention", 8),
        ("the Quartet LM", create_gpt_quartet(LM_VOCAB, TransformerConfig(**LM_CONFIG),
                                              generator=torch.Generator().manual_seed(72)),
         tok, K5, LM_CONFIG["n_layer"]),
        ("E at depth 2", ViTEdgewise(dim=224, depth=2, heads=4, n_classes=N_CLASSES, n_views=5,
                                     share_qkv=False, gate_mode="lowrank", gate_rank=4,
                                     gate_init="mix5", mlp_ratio=4.0,
                                     generator=torch.Generator().manual_seed(73)),
         x, "fused_edgewise_lowrank_attention", 2),
        ("D at depth 2", ViTMultiHop(dim=256, depth=2, heads=4, n_classes=N_CLASSES, hops=3,
                                     beta_not=0.5, generator=torch.Generator().manual_seed(74)),
         x, K4, 2),
    ]
    for name, model, inputs, kernel, per_fwd in cases:
        model.eval()
        params = dict(model.state_dict())
        try:
            export_apply(model, params, inputs[:2])
            refused = "not refused"
        except ValueError as e:
            refused = str(e)
        t0 = time.perf_counter()
        fn = load_exported(export_apply(model, params, inputs[:2], allow_custom_calls=True))
        secs = time.perf_counter() - t0
        batches = EXPORT_BATCHES if name == "A" else (inputs.shape[0],)
        for b in batches:
            out, counts = counted(lambda: fn(params, inputs[:b]))
            out = out[0] if isinstance(out, tuple) else out
            with torch.no_grad():
                ref = model(inputs[:b])
            ref = ref[0] if isinstance(ref, tuple) else ref
            check(counts == {**none, kernel: per_fwd},
                  f"{name} artifact at batch {b}: launches {launched(counts)}")
            compare(f"{name} artifact at batch {b} vs the eager forward", out, ref, 2e-5, 2e-4)
        op = F.EXPORT_OPS[["flash_attention", "fused_edgewise_lowrank_attention",
                           "edgewise_lowrank_wide_fwd", "fused_edgewise_dense_attention", K4,
                           K5].index(kernel)]
        check(op in refused, f"{name}: without allow_custom_calls export refuses: {refused[:160]}")
        b = inputs.shape[0]
        with torch.no_grad():
            eager_ms = time_ms(lambda: model(inputs), iters=5, reps=3)
        art_ms = time_ms(lambda: fn(params, inputs), iters=5, reps=3)
        say(f"  {name}: traced, saved and loaded in {secs:.1f} s; batch {b}: artifact "
            f"{art_ms:.3f} ms, eager {eager_ms:.3f} ms [{smi}]")


def spec_http_phase(smi):
    """16d: the demo CLI with --spec on the card."""
    say(f"[16 serving] 16d: python -m mop_tpu_torch.cli.serve_http {' '.join(SPEC_HTTP_ARGS)}")
    (out, secs), counts = counted(lambda: seconds_of(lambda: serve_http.run(
        serve_http._parser().parse_args(SPEC_HTTP_ARGS))))
    eng, m = out["engine"], out["metrics"]
    check(isinstance(eng, SpecDecodeEngine) and out["drained"] and len(out["texts"]) == 4
          and all(out["texts"]) and out["completion"]["finish_reason"] in ("stop", "length")
          and len(out["embeddings"]) == 2 and int(m.get("mop_tpot_seconds_count", 0)) >= 4,
          f"serve_http --spec: 4 text clients, a stream, /v1/completions "
          f"({out['completion']['finish_reason']}), /v1/embeddings, drained {out['drained']}; "
          f"{m.get('mop_engine_steps_total')} engine steps for {m.get('mop_tokens_generated_total')}"
          f" tokens, acceptance {eng.drafts_accepted} of {eng.drafts_proposed} drafts; target "
          f"loss {out['loss']:.3f}; launches {launched(counts)} (K5: the training); {secs:.1f} s "
          f"[{smi}]")


def serving_export_phases(smi):
    """Phase 16: the paged and speculative engines and export."""
    none = {f.__name__: 0 for f in F.KERNELS}
    t_phase = time.perf_counter()
    for part in (paged_phase, spec_phase, export_phase):
        t0 = time.perf_counter()
        part(smi, none)
        say(f"  {part.__name__} took {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    spec_http_phase(smi)
    say(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")


# Phase 17, the multi-GPU modes (mop_tpu_torch.parallel). One process drives
# one card, and NCCL puts no two ranks on one card, so on a one-card machine
# every mode runs at world size 1 over NCCL: its code, its collectives and
# the kernels inside it, at full width; its multi-rank numerics are held to
# the one-device steps on the CPU over gloo (tests/test_torch_parallel_*.py).
MG_STEPS = 3  # steps of each mode against its one-device step
MG_LM = dict(LM_CONFIG, dropout=0.0)  # LM_quartet at dropout 0: K5 8 a step
MG_RING = (8, 6, 750, 64)  # Whisper_20M's encoder attention
MG_MOE = dict(tokens=BATCH * 64, dim=224, hidden=896, experts=MOE_EXPERTS)  # MoE B_bench
# Two ranks can share one card only over gloo, which takes CUDA tensors for
# all_reduce and broadcast alone (torch.distributed's backend table; its
# all_gather, reduce_scatter, all_to_all and send / recv are CPU-only). The
# collectives each mode's step calls (utils.collectives names, checked against
# a record of one step below) decide which modes could run so.
GLOO_CUDA = {"all-reduce", "broadcast"}
MODE_COLLECTIVES = {
    "data parallel": {"all-reduce"},
    "tensor parallel": {"all-reduce"},
    "tensor + sequence parallel": {"all-gather", "reduce-scatter", "all-reduce"},
    "FSDP": {"all-gather", "reduce-scatter", "all-reduce"},
    "ZeRO-1": {"all-gather", "reduce-scatter", "all-reduce"},
    "ring attention": {"collective-permute"},
    "expert parallel": {"all-to-all"},
    "multi-seed (seeds over ranks)": {"all-reduce"},
}
GLOO_CUDA_MODES = tuple(m for m, ops in MODE_COLLECTIVES.items() if ops <= GLOO_CUDA)


def _mg_run(step, batches, gen_seed):
    """The losses of ``step`` over ``batches`` (x, y pairs) from a fresh
    generator."""
    g = cuda_generator(gen_seed)
    return torch.stack([step(x, y, generator=g)["loss"].float() for x, y in batches])


def _same(name, got, want, exact=True, atol=0.0):
    """got equal to want (bit for bit, or within atol), each a tensor or a
    state dict."""
    if isinstance(want, dict):
        diffs = {k: (got[k].float() - want[k].float()).abs().max().item() for k in want}
        worst = max(diffs.items(), key=lambda kv: kv[1])
        ok = sorted(got) == sorted(want) and (
            all(torch.equal(got[k], want[k]) for k in want) if exact else worst[1] <= atol)
        check(ok, f"{name}: {'bit-equal' if exact else f'within {atol}'} (largest difference "
                  f"{worst[1]:.3e} at {worst[0]})")
        return
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.equal(got, want) if exact else err <= atol
    check(ok, f"{name}: {'bit-equal' if exact else f'within {atol}'} (max difference {err:.3e})")


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _records_of(stdout):
    return [json.loads(line[line.find("{"):]) for line in stdout.splitlines()
            if line.startswith("[proc ") and '"param_l2"' in line]


def kernel_split(fn, reps=3):
    """Over ``reps`` calls of ``fn`` (after one unprofiled call), from one
    torch.profiler trace of the card: each kernel's device ms a call (user
    annotations, which span idle time, left out) and the wall ms a call
    (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    dev = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False):
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    return dev, wall


def card_and_host_ms(fn, iters=5, reps=2):
    """Medians over ``reps`` of the mean ms of one call of ``fn`` (after two
    calls of warm-up), from the same calls: on the card's clock (CUDA events)
    and on the host's, from an idle card to the last call's return."""
    for _ in range(2):
        fn()
    card, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / iters)
        e1.record()
        e1.synchronize()
        card.append(e0.elapsed_time(e1) / iters)
    return statistics.median(card), statistics.median(host)


def _dp_overhead(steps, x, y, grads, group, smi):
    """17a's data-parallel step against the one-device step at world 1: their
    ms a step on the card's clock and the host's issue time a step, three
    rounds interleaved one device / DP / DP / one device (medians); their
    device time and busy share from one trace each, with the kernels that
    differ most; and the DP step's two additions alone, on the card's clock
    and the host's: the gradient reduction (``comm.all_reduce_flat_`` over
    the DP model's grads) and the mean of the loss and accuracy."""
    from mop_tpu_torch.parallel import comm

    def call(label):
        return lambda: steps[label](x, y, cuda_generator(173))

    ms = {label: [] for label in steps}
    host = {label: [] for label in steps}
    for _ in range(3):
        for label in ("one device", "data parallel", "data parallel", "one device"):
            card, on_host = card_and_host_ms(call(label))
            ms[label].append(card)
            host[label].append(on_host)
    med = {k: (statistics.median(ms[k]), statistics.median(host[k])) for k in steps}
    (one, one_h), (dp, dp_h) = med["one device"], med["data parallel"]
    say(f"  17a B_bench train step, batch {BATCH}, bf16, 3 rounds of one device / DP / DP / one "
        f"device, medians: data parallel {dp:.3f} ms vs one device {one:.3f} ms "
        f"({100 * (dp / one - 1):+.1f}% at world 1; every sample DP "
        f"{', '.join(f'{v:.3f}' for v in ms['data parallel'])}, one device "
        f"{', '.join(f'{v:.3f}' for v in ms['one device'])}); the host's issue time a step "
        f"{dp_h:.3f} vs {one_h:.3f} ms ({dp_h - one_h:+.3f}) [{smi}]")
    split = {label: kernel_split(call(label)) for label in steps}
    for label, (dev, wall) in split.items():
        d = sum(dev.values())
        say(f"  17a {label} (profiled): kernels {d:.3f} ms a step, busy {100 * d / wall:.1f}% "
            f"of {wall:.3f} ms")
    a, b = split["data parallel"][0], split["one device"][0]
    diff = sorted(((k, a.get(k, 0.0) - b.get(k, 0.0)) for k in set(a) | set(b)),
                  key=lambda kv: -abs(kv[1]))[:6]
    say(f"  17a DP minus one device, kernels (ms a step; total "
        f"{sum(a.values()) - sum(b.values()):+.3f}): "
        + "; ".join(f"{k[:60]} {v:+.3f}" for k, v in diff))
    n = sum(g.numel() for g in grads)
    loss, acc = (torch.ones((), device="cuda") for _ in range(2))
    for what, fn in ((f"the gradient reduction ({len(grads)} grads, {n * 4 / 1e6:.2f} MB "
                      "fp32)", lambda: comm.all_reduce_flat_(grads, group)),
                     ("the mean of loss and accuracy",
                      lambda: tuple(comm.all_reduce_(torch.stack([loss.float(), acc.float()]), group) / 1))):
        card, on_host = card_and_host_ms(fn, iters=20)
        say(f"  17a {what} alone: {card:.3f} ms a call on the card's clock, {on_host:.3f} ms of "
            f"host a call [{smi}]")


def multi_gpu_phases(smi):
    """Phase 17: every mode of mop_tpu_torch.parallel at world size 1 over NCCL
    (and the worker at the visible card count where it is above 1)."""
    import torch.distributed as dist

    from mop_tpu_torch.cli.launch_multihost import free_port
    from mop_tpu_torch.ops import ring_attention as ring
    from mop_tpu_torch.parallel import (fsdp_init_opt_state, fsdp_shard_params,
                                        make_fsdp_lm_train_step,
                                        make_multiseed_scanned_train_step,
                                        make_tp_classifier_train_step, make_tp_lm_train_step,
                                        multiseed_init, multiseed_opt_init, tp_init_opt_state,
                                        tp_shard_params, unstack_seed, zero1_init_opt_state)
    from mop_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, replicate, shard_batch
    from mop_tpu_torch.utils.collectives import collective_summary, record_collectives

    t_phase = time.perf_counter()
    say("[17 multi-GPU modes] mop_tpu_torch.parallel over NCCL at world size 1 on "
        f"{torch.cuda.get_device_name(0)}: the code and kernels of each mode, not multi-card "
        f"numerics or speed [{smi}]")
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    mesh = make_mesh(device="cuda")
    check(dist.get_backend() == "nccl" and mesh.size == 1 and mesh.device == torch.device("cuda", 0),
          f"make_mesh() under WORLD_SIZE=1: {mesh}, backend {dist.get_backend()}")
    say(f"  modes that two ranks could run on one shared card over gloo (it takes CUDA tensors "
        f"for {sorted(GLOO_CUDA)} only): {list(GLOO_CUDA_MODES)}")
    seen_ops = {}
    # Bit-equality at world 1 asks for the same kernels run to run (15a's switches).
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        xs = torch.randint(0, 256, (TRAIN_K, BATCH, 3, 32, 32), dtype=torch.uint8, device="cuda",
                           generator=cuda_generator(170))
        ys = torch.randint(0, N_CLASSES, (TRAIN_K, BATCH), device="cuda",
                           generator=cuda_generator(171))
        batches = [(xs[i], ys[i]) for i in range(MG_STEPS)]
        make_b = MODELS["B_bench"][0]

        # 17a: data parallel, the bench.py recipe (B 224/6/4, batch 256, bf16).
        t0 = time.perf_counter()
        runs, steps, grads = {}, {}, None
        for label, m in (("one device", None), ("data parallel", mesh)):
            model = make_b(torch.Generator().manual_seed(17))
            if m is not None:
                replicate(model, m)
            opt = torch.optim.AdamW(model.parameters(), LR, weight_decay=WD)
            step = make_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD, mesh=m)
            (losses, counts) = counted(lambda: _mg_run(step, batches, 172), add=m is not None)
            runs[label] = (losses, _state(model), counts)
            steps[label] = step
            if m is not None:
                with record_collectives() as rec:
                    step(xs[0], ys[0], cuda_generator(173))
                seen_ops["data parallel"] = set(collective_summary(rec))
                grads = [p_.grad for p_ in model.parameters() if p_.grad is not None]
        (l1, p1, c1), (l2, p2, c2) = runs["one device"], runs["data parallel"]
        _same("17a DP losses vs one device, 3 steps", l2, l1)
        _same("17a DP params vs one device", p2, p1)
        check(c1[F.flash_attention.__name__] == c2[F.flash_attention.__name__] == 6 * MG_STEPS,
              f"17a K1 6 launches a step under DP and alone: {launched(c2)} / {launched(c1)}")
        _dp_overhead(steps, xs[0], ys[0], grads, mesh.group(DATA_AXIS), smi)
        del steps, grads
        sc = {}
        for label, m in (("one device", None), ("data parallel", mesh)):
            model = make_b(torch.Generator().manual_seed(17))
            if m is not None:
                replicate(model, m)
            opt = torch.optim.AdamW(model.parameters(), LR, weight_decay=WD)
            scanned = make_scanned_classifier_train_step(model, opt, CIFAR100_MEAN,
                                                         CIFAR100_STD, TRAIN_K, mesh=m)
            if m is not None:
                xk, yk = shard_batch((xs.transpose(0, 1), ys.transpose(0, 1)), m)
                xk, yk = xk.transpose(0, 1), yk.transpose(0, 1)
            else:
                xk, yk = xs, ys
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, counts = counted(lambda: scanned(xk, yk, cuda_generator(174)), add=m is not None)
            sc[label] = (out["loss"], _state(model), counts, time.perf_counter() - t1)
            del model, opt, scanned
        _same(f"17a scanned K={TRAIN_K} DP losses vs one device", sc["data parallel"][0],
              sc["one device"][0])
        _same(f"17a scanned K={TRAIN_K} DP params vs one device", sc["data parallel"][1],
              sc["one device"][1])
        check(sc["data parallel"][2]["flash_attention"] == 6 * TRAIN_K
              == sc["one device"][2]["flash_attention"],
              f"17a scanned K={TRAIN_K}: K1 6 launches a step under DP and alone: "
              f"{launched(sc['data parallel'][2])} / {launched(sc['one device'][2])}")
        say(f"  17a scanned K={TRAIN_K}: {1e3 * sc['data parallel'][3] / TRAIN_K:.3f} ms a step "
            f"DP vs {1e3 * sc['one device'][3] / TRAIN_K:.3f} ms one device (one call each, "
            f"first-call overheads included); K1 {sc['data parallel'][2]['flash_attention']} "
            f"launches [{smi}]")
        say(f"  17a took {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        # 17b: FSDP and ZeRO-1 of LM_quartet against make_lm_train_step.
        t0 = time.perf_counter()
        cfg = TransformerConfig(**MG_LM)
        t_lm = cfg.block_size
        idx = torch.randint(0, LM_VOCAB, (MG_STEPS, LM_BATCH, t_lm), device="cuda",
                            generator=cuda_generator(175))
        lm_batches = [(idx[i], idx[i].roll(-1, -1)) for i in range(MG_STEPS)]

        def make_opt(ps):
            return torch.optim.AdamW(ps, LM_LR, weight_decay=LM_WD)

        lm_runs = {}
        for label in ("one device", "FSDP", "ZeRO-1"):
            lm = create_gpt_quartet(LM_VOCAB, cfg, generator=torch.Generator().manual_seed(176))
            if label == "one device":
                opt = make_opt(lm.parameters())
                step = make_lm_train_step(lm, opt)
            elif label == "FSDP":
                fsdp_shard_params(replicate(lm, mesh), mesh)
                opt = fsdp_init_opt_state(make_opt, lm, mesh)
                step = make_fsdp_lm_train_step(lm, opt, mesh)
            else:
                opt = zero1_init_opt_state(make_opt, replicate(lm, mesh), mesh)
                step = make_fsdp_lm_train_step(lm, opt, mesh, shard_params=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, counts = counted(lambda: _mg_run(step, lm_batches, 177),
                                     add=label != "one device")
            peak = torch.cuda.max_memory_allocated() / 2**30
            if label != "one device":
                with record_collectives() as rec:
                    step(*lm_batches[0], generator=cuda_generator(177))
                seen_ops[label] = set(collective_summary(rec))
            lm_runs[label] = (losses, counts, peak)
            del lm, opt, step
            torch.cuda.empty_cache()
        ref_l, ref_c, ref_peak = lm_runs["one device"]
        for label in ("FSDP", "ZeRO-1"):
            losses, counts, peak = lm_runs[label]
            _same(f"17b {label} LM_quartet losses vs make_lm_train_step, bf16", losses, ref_l,
                  exact=False, atol=1e-3)
            check(counts[K5] == ref_c[K5] == 8 * MG_STEPS,
                  f"17b {label} K5 8 launches a step: {counts[K5]} vs {ref_c[K5]}")
            say(f"  17b {label}: peak memory {peak:.2f} GiB vs {ref_peak:.2f} GiB one device "
                f"(world 1: every shard is whole) [{smi}]")
        say(f"  17b took {time.perf_counter() - t0:.1f} s")

        # 17c: tensor parallel, A (the classifier) and GPT_MoP with and without
        # sequence parallelism, against the one-device steps.
        t0 = time.perf_counter()
        shapes = []

        def heads_of(model):
            """Record the (B, heads, N, dk) each attention module computes on
            (its kernel's launch shape): its own share of the heads under TP."""
            def hook(mod, args):
                x = args[0]
                heads = getattr(mod, "heads", None) or mod.n_head
                width = mod.qkv.weight.shape[0] // 3 if hasattr(mod, "qkv") else \
                    mod.q_proj.weight.shape[0]
                shapes.append((x.shape[0], heads, x.shape[1], width // heads))

            return [m.register_forward_pre_hook(hook) for m in model.modules()
                    if type(m).__name__ in ("MSA", "CausalSelfAttention")]

        make_a = MODELS["A"][0]
        tp_runs = {}
        for label in ("one device", "tensor parallel"):
            model = make_a(torch.Generator().manual_seed(178))
            opt = torch.optim.AdamW(model.parameters(), LR, weight_decay=WD)
            if label == "one device":
                step = make_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD)
            else:
                tp_shard_params(replicate(model, mesh), mesh)
                opt = tp_init_opt_state(lambda ps: torch.optim.AdamW(ps, LR, weight_decay=WD),
                                        model)
                step = make_tp_classifier_train_step(model, opt, mesh, CIFAR100_MEAN,
                                                     CIFAR100_STD)
            shapes.clear()
            hooks = heads_of(model)
            losses, counts = counted(lambda: _mg_run(step, batches, 179),
                                     add=label != "one device")
            for h in hooks:
                h.remove()
            tp_runs[label] = (losses, counts, sorted(set(shapes)))
            del model, opt, step
        _same("17c TP A losses vs one device, bf16", tp_runs["tensor parallel"][0],
              tp_runs["one device"][0], exact=False, atol=1e-3)
        check(tp_runs["tensor parallel"][1]["flash_attention"] == 8 * MG_STEPS
              == tp_runs["one device"][1]["flash_attention"],
              f"17c TP A: K1 8 launches a step on the local heads, "
              f"{tp_runs['tensor parallel'][2]} (one device {tp_runs['one device'][2]})")
        mop_cfg = TransformerConfig(**GPT_MOP_CONFIG)
        gidx = torch.randint(0, LM_VOCAB, (MG_STEPS, LM_BATCH, mop_cfg.block_size), device="cuda",
                             generator=cuda_generator(180))
        g_batches = [(gidx[i], gidx[i].roll(-1, -1)) for i in range(MG_STEPS)]
        g_runs = {}
        for label in ("one device", "tensor parallel", "tensor + sequence parallel"):
            lm = create_gpt_mop(LM_VOCAB, mop_cfg, generator=torch.Generator().manual_seed(181))
            if label == "one device":
                step = make_lm_train_step(lm, make_opt(lm.parameters()))
            else:
                tp_shard_params(replicate(lm, mesh), mesh)
                step = make_tp_lm_train_step(lm, tp_init_opt_state(make_opt, lm), mesh,
                                             sequence_parallel="sequence" in label)
            shapes.clear()
            hooks = heads_of(lm)
            losses, counts = counted(lambda: _mg_run(step, g_batches, 182),
                                     add=label != "one device")
            for h in hooks:
                h.remove()
            if label != "one device":
                with record_collectives() as rec:
                    step(*g_batches[0], generator=cuda_generator(182))
                seen_ops[label] = set(collective_summary(rec))
            g_runs[label] = (losses, counts, sorted(set(shapes)))
            del lm, step
            torch.cuda.empty_cache()
        for label in ("tensor parallel", "tensor + sequence parallel"):
            _same(f"17c {label} GPT_MoP losses vs make_lm_train_step, bf16", g_runs[label][0],
                  g_runs["one device"][0], exact=False, atol=1e-3)
            check(g_runs[label][1][K5] == g_runs["one device"][1][K5] == 6 * MG_STEPS,
                  f"17c {label} GPT_MoP: K5 6 launches a step on the local heads, "
                  f"{g_runs[label][2]}")
        say(f"  17c took {time.perf_counter() - t0:.1f} s")

        # 17d: the ring at world 1 against K1 and full attention, and the
        # expert-parallel op against dense_top1_mlp at MoE B_bench's shapes.
        t0 = time.perf_counter()
        gr = cuda_generator(183)
        q, k, v = (torch.randn(*MG_RING, device="cuda", generator=gr).requires_grad_()
                   for _ in range(3))
        w = torch.randn(*MG_RING, device="cuda", generator=gr)
        with record_collectives() as rec:
            out = ring.ring_attention(q, k, v, mesh)
        seen_ops["ring attention"] = set(collective_summary(rec))
        grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        with torch.no_grad():
            k1 = F.flash_attention(q, k, v)
        full = F.flash_attention_plain(q, k, v)
        want = torch.autograd.grad((full * w).sum(), (q, k, v))
        compare(f"17d ring {MG_RING} vs K1, fp32", out.detach(), k1, 2e-5, 0.0)
        compare(f"17d ring {MG_RING} vs full attention, fp32", out.detach(), full.detach(),
                2e-5, 0.0)
        for name, g_, w_ in zip("qkv", grads, want):
            compare(f"17d ring d{name} vs full attention's", g_, w_, 5e-5, 5e-5)
        del q, k, v, w, out, grads, want, full, k1
        mo = MG_MOE
        gm = cuda_generator(184)
        x = torch.randn(mo["tokens"], mo["dim"], device="cuda", generator=gm)
        gw = torch.randn(mo["dim"], mo["experts"], device="cuda", generator=gm) * 0.1
        gb = torch.zeros(mo["experts"], device="cuda")
        w1 = torch.randn(mo["experts"], mo["dim"], mo["hidden"], device="cuda",
                         generator=gm) / mo["dim"] ** 0.5
        w2 = torch.randn(mo["experts"], mo["hidden"], mo["dim"], device="cuda",
                         generator=gm) / mo["hidden"] ** 0.5
        with torch.no_grad(), record_collectives() as rec:
            ep = ops_moe.expert_parallel_top1_mlp(x, gw, gb, w1, w2, gelu_tanh, mesh,
                                                  capacity_factor=float(mo["experts"]))
        seen_ops["expert parallel"] = set(collective_summary(rec))
        with torch.no_grad():
            dense = ops_moe.dense_top1_mlp(x, gw, gb, w1, w2, gelu_tanh)
        compare(f"17d expert parallel vs dense_top1_mlp, {mo}, fp32", ep, dense, 1e-4, 1e-4)
        del x, w1, w2, ep, dense
        say(f"  17d took {time.perf_counter() - t0:.1f} s")

        # 17e: multi-seed, 2 seeds of B_bench, against two one-seed runs.
        t0 = time.perf_counter()
        seeds = [0, 1]
        k_ms = MG_STEPS
        xk = torch.stack([xs[:k_ms], xs[k_ms:2 * k_ms]], 1)
        yk = torch.stack([ys[:k_ms], ys[k_ms:2 * k_ms]], 1)
        stack = multiseed_init(lambda s: make_b(torch.Generator().manual_seed(190 + s)), seeds,
                               mesh)
        opts = multiseed_opt_init(lambda ps: torch.optim.AdamW(ps, LR, weight_decay=WD), stack)
        step = make_multiseed_scanned_train_step(stack, opts, mesh, CIFAR100_MEAN, CIFAR100_STD,
                                                 n_seeds=2, unroll_steps=k_ms)
        with record_collectives() as rec:
            m_ms, c_ms = counted(lambda: step(xk, yk, [cuda_generator(200 + s) for s in seeds]))
        seen_ops["multi-seed (seeds over ranks)"] = set(collective_summary(rec))
        for i, s in enumerate(seeds):
            model = make_b(torch.Generator().manual_seed(190 + s))
            opt = torch.optim.AdamW(model.parameters(), LR, weight_decay=WD)
            one = make_scanned_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD, k_ms)
            got = one(xk[:, i], yk[:, i], cuda_generator(200 + s))
            _same(f"17e seed {s}: multi-seed losses vs its own run", m_ms["loss"][:, i],
                  got["loss"])
            _same(f"17e seed {s}: multi-seed params vs its own run",
                  {k_: v_.to("cuda") for k_, v_ in unstack_seed(stack, i).items()}, _state(model))
            del model, opt, one
        check(not torch.equal(m_ms["loss"][:, 0], m_ms["loss"][:, 1]), "17e the seeds differ")
        check(c_ms["flash_attention"] == 6 * k_ms * 2, f"17e K1 launches: {launched(c_ms)}")
        del stack, opts, step
        torch.cuda.empty_cache()
        say(f"  17e took {time.perf_counter() - t0:.1f} s")

        # Each mode's recorded collectives against the table the gloo list
        # comes from (at world 1 a collective still runs: its group is there);
        # the ring at world 1 has no neighbour, so it sends nothing.
        check(sorted(seen_ops) == sorted(MODE_COLLECTIVES),
              f"17 every mode's collectives recorded: {sorted(seen_ops)}")
        for mode, ops in seen_ops.items():
            want = set() if mode == "ring attention" else MODE_COLLECTIVES[mode]
            check(ops == want, f"17 {mode}: collectives of one step {sorted(ops)}, "
                               f"expected {sorted(want)}")

        # 17f: the launcher with --nproc 1 running the worker over NCCL; and
        # at the visible card count where it is above 1.
        t0 = time.perf_counter()
        first = None
        for nproc in sorted({1, torch.cuda.device_count()}):
            cmd = [sys.executable, "-m", "mop_tpu_torch.cli.launch_multihost", "--nproc",
                   str(nproc), "--timeout", "300", "--", sys.executable, "-m",
                   "mop_tpu_torch.cli.multihost_train", "--steps", "3"]
            env_child = {k_: v_ for k_, v_ in os.environ.items() if k_ not in env}
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=360, env=env_child)
            recs = sorted(_records_of(out.stdout), key=lambda r: r["process"])
            check(out.returncode == 0 and len(recs) == nproc
                  and all(math.isfinite(r["loss"]) for r in recs),
                  f"17f launch_multihost --nproc {nproc} -- multihost_train over NCCL: rc "
                  f"{out.returncode}, records {recs}{'' if recs else out.stdout[-2000:]}")
            if recs:
                first = first or recs[0]
                same = all((r["loss"], r["param_l2"]) == (recs[0]["loss"], recs[0]["param_l2"])
                           for r in recs)
                close = abs(recs[0]["loss"] - first["loss"]) <= 2e-4 * abs(first["loss"]) + 2e-5
                check(same and close, f"17f {nproc} process(es): the same record on each, the "
                                      f"one process's loss {first['loss']:.6f} within 2e-4")
        say(f"  17f took {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1])
        dist.destroy_process_group()
        for k_, v_ in saved.items():
            if v_ is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v_
    say(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")


def later_phases(phases, smi) -> int:
    """``--phases``: only the named phases of 10-17, after the build."""
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if 10 in phases or 15 in phases:
            harness_phases(smi, os.path.join(work, "ab5"))
        if 11 in phases:
            whisper_phases(smi)
        if 12 in phases:
            moe_voc_imagenet_phases(smi)
        if 13 in phases:
            decode_phases(smi)
        if 14 in phases:
            serving_phases(smi)
        if 15 in phases:
            trainer_phase(smi, work)
            cli_phase(smi, work, os.path.join(work, "ab5"))
        if 16 in phases:
            serving_export_phases(smi)
        if 17 in phases:
            multi_gpu_phases(smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        say(f"FAILED: {failures}")
        return 1
    say(f"phases {phases}: every check passed")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", type=lambda v: sorted({int(p) for p in v.split(",")}),
                    help="comma-separated phases of 10-17 to run alone after the build")
    args = ap.parse_args(argv)
    if args.phases and not set(args.phases) <= set(range(10, 18)):
        ap.error(f"--phases takes phases of 10-17, not {args.phases}")
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this smoke test needs an NVIDIA GPU")
        return 1
    # fp32 means fp32: no TF32 in the plain versions' products or the convs.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    say(f"[1 device] {kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.time()
    libs = _build.build_all()
    for name, path in libs.items():
        report = ptxas_report(path.with_suffix(".log").read_text())
        say(f"  {name}: {' | '.join(report)}")
        if name == "edgewise_bwd":
            k3b = [r for r in report if "dense" in r]
            spills = not all(r.endswith("0 bytes spill stores, 0 bytes spill loads") for r in k3b)
            say(f"    K3b (both instantiations) spills: {spills}")
    say(f"[2 build] {len(libs)} kernels from mop_tpu_torch/csrc in {time.time() - t0:.1f} s")
    check_byte_counts()
    if args.phases:
        return later_phases(args.phases, smi)

    g = torch.Generator(device="cuda").manual_seed(0)
    # The dense head's phases draw from their own generator, so that the
    # other phases see the same inputs as before they were added.
    gd = torch.Generator(device="cuda").manual_seed(3)
    gk = torch.Generator(device="cuda").manual_seed(4)  # likewise for K4, K5 and the LM
    gn = torch.Generator(device="cuda").manual_seed(5)  # and for K2's and K3b's off shapes

    def rn(*s, dtype=torch.float32, gen=g):
        return torch.randn(*s, device="cuda", generator=gen).to(dtype)

    errs = {}
    say("[3 K1 flash_attention vs plain]")
    with torch.inference_mode():
        bf = torch.bfloat16
        for dtype, atol, rtol in ((torch.float32, 2e-5, 0.0), (bf, K1_BF16_ATOL, K1_BF16_RTOL)):
            q, k, v = (rn(1024, 64, 56, dtype=dtype) for _ in range(3))
            err = compare(f"(1024, 64, 56) {dtype}", F.flash_attention(q, k, v),
                          F.flash_attention_plain(q, k, v), atol, rtol)
            errs.setdefault("flash_attention", err)
        # B's MSA at dk = 54: strided q/k/v views of one fused qkv output.
        q, k, v = rn(256, 64, 3, 4, 54).permute(2, 0, 3, 1, 4)
        compare("strided qkv views (256, 4, 64, 54) float32", F.flash_attention(q, k, v),
                F.flash_attention_plain(q, k, v), 2e-5, 0.0)
        q, k, v = (rn(64, 200, 56) for _ in range(3))
        compare("causal (64, 200, 56) float32", F.flash_attention(q, k, v, causal=True),
                F.flash_attention_plain(q, k, v, causal=True), 2e-5, 0.0)
        q, k, v = rn(64, 64, 54), rn(64, 100, 54), rn(64, 100, 54)
        compare("ragged kv q (64, 64, 54) kv (64, 100, 54) float32",
                F.flash_attention(q, k, v), F.flash_attention_plain(q, k, v), 2e-5, 0.0)
        # bf16 at the same strided, causal and ragged cases; then a long
        # sequence whose key blocks stream through the copy ring.
        q, k, v = rn(256, 64, 3, 4, 54, dtype=bf).permute(2, 0, 3, 1, 4)
        compare(f"strided qkv views (256, 4, 64, 54) bfloat16, {F.copy_width((q, k, v), 54)}-byte "
                "copies", F.flash_attention(q, k, v), F.flash_attention_plain(q, k, v),
                K1_BF16_ATOL, K1_BF16_RTOL)
        q, k, v = (rn(64, 200, 56, dtype=bf) for _ in range(3))
        compare("causal (64, 200, 56) bfloat16", F.flash_attention(q, k, v, causal=True),
                F.flash_attention_plain(q, k, v, causal=True), K1_BF16_ATOL, K1_BF16_RTOL)
        q, k, v = rn(64, 64, 54, dtype=bf), rn(64, 100, 54, dtype=bf), rn(64, 100, 54, dtype=bf)
        compare("ragged kv q (64, 64, 54) kv (64, 100, 54) bfloat16", F.flash_attention(q, k, v),
                F.flash_attention_plain(q, k, v), K1_BF16_ATOL, K1_BF16_RTOL)
        for dtype, atol, rtol in ((torch.float32, 2e-5, 0.0), (bf, K1_BF16_ATOL, K1_BF16_RTOL)):
            q, k, v = (rn(4, 2, 1500, 64, dtype=dtype) for _ in range(3))
            for causal in (False, True):
                compare(f"(4, 2, 1500, 64) causal={causal} {dtype}",
                        F.flash_attention(q, k, v, causal=causal),
                        F.flash_attention_plain(q, k, v, causal=causal), atol, rtol)
        # Whisper's three attention sites (phase 11): encoder, causal decoder
        # and rectangular cross-attention, at the 20M config and the reference
        # width; from their own generator.
        gw = cuda_generator(6)
        for dtype, atol, rtol in ((torch.float32, 2e-5, 0.0), (bf, K1_BF16_ATOL, K1_BF16_RTOL)):
            for q_shape, kv_shape, causal in WHISPER_K1_SHAPES:
                q = rn(*q_shape, dtype=dtype, gen=gw)
                k, v = (rn(*kv_shape, dtype=dtype, gen=gw) for _ in range(2))
                compare(f"Whisper q {q_shape} kv {kv_shape[2]} causal={causal} {dtype}",
                        F.flash_attention(q, k, v, causal=causal),
                        F.flash_attention_plain(q, k, v, causal=causal), atol, rtol)
        del q, k, v

        say("[4 K2 fused_edgewise_lowrank_attention vs plain]")
        for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-4), (torch.bfloat16, 5e-2, 5e-2)):
            args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, dtype)
            err = compare(f"(256, 4, 5, 64, 56) r=4 {dtype}",
                          F.fused_edgewise_lowrank_attention(*args),
                          F.fused_edgewise_lowrank_attention_plain(*args), atol, rtol)
            errs.setdefault("fused_edgewise_lowrank_attention", err)
        # E's EdgewiseMSA: strided per-view views of one stacked qkv output.
        args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, torch.float32)
        qkv = rn(256, 64, 5, 3, 4, 56).permute(3, 0, 4, 2, 1, 5)
        args = (*qkv, *args[3:])
        compare("strided view inputs (256, 4, 5, 64, 56) r=4 float32",
                F.fused_edgewise_lowrank_attention(*args),
                F.fused_edgewise_lowrank_attention_plain(*args), 2e-5, 2e-4)
        # Off the main shape (two and eight views, N < 64 and odd, dk > 64:
        # two column tiles) and bf16's strided views; from their own generator.
        for bh_shape, nv, n, dk, r in K2_OFF_SHAPES:
            for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-4), (torch.bfloat16, 5e-2, 5e-2)):
                args = edgewise_inputs(gn, bh_shape, nv, n, dk, r, dtype)
                compare(f"{(*bh_shape, nv, n, dk)} r={r} {dtype}",
                        F.fused_edgewise_lowrank_attention(*args),
                        F.fused_edgewise_lowrank_attention_plain(*args), atol, rtol)
        args = edgewise_inputs(gn, (256, 4), 5, 64, 56, 4, torch.bfloat16)
        qkv = rn(256, 64, 5, 3, 4, 56, dtype=torch.bfloat16, gen=gn).permute(3, 0, 4, 2, 1, 5)
        args = (*qkv, *args[3:])
        compare(f"strided view inputs (256, 4, 5, 64, 56) r=4 bfloat16, "
                f"{F.copy_width(qkv, 56)}-byte copies", F.fused_edgewise_lowrank_attention(*args),
                F.fused_edgewise_lowrank_attention_plain(*args), 5e-2, 5e-2)

        say("[4b K3 fused_edgewise_dense_attention vs plain]")
        for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-4), (torch.bfloat16, 5e-2, 5e-2)):
            args = dense_inputs(gd, (256, 4), 5, 64, 56, dtype)
            err = compare(f"(256, 4, 5, 64, 56) {dtype}", F.fused_edgewise_dense_attention(*args),
                          F.fused_edgewise_dense_attention_plain(*args), atol, rtol)
            errs.setdefault("fused_edgewise_dense_attention", err)
        args = dense_inputs(gd, (256, 4), 5, 64, 56, torch.float32)
        qkv = rn(256, 64, 5, 3, 4, 56, gen=gd).permute(3, 0, 4, 2, 1, 5)
        args = (*qkv, *args[3:])
        compare("strided view inputs (256, 4, 5, 64, 56) float32",
                F.fused_edgewise_dense_attention(*args),
                F.fused_edgewise_dense_attention_plain(*args), 2e-5, 2e-4)
        args = dense_inputs(gd, (2, 2), 2, 40, 100, torch.float32)
        compare("(2, 2, 2, 40, 100) float32", F.fused_edgewise_dense_attention(*args),
                F.fused_edgewise_dense_attention_plain(*args), 2e-5, 2e-4)
        # Off the main shape in both dtypes (two and eight views, N < 64 and
        # odd, dk > 64, the fp32 maps A_i in the workspace), and bf16's
        # strided views; from their own generator.
        for bh_shape, nv, n, dk in K3_OFF_SHAPES:
            for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-4), (torch.bfloat16, 5e-2, 5e-2)):
                args = dense_inputs(gn, bh_shape, nv, n, dk, dtype)
                compare(f"{(*bh_shape, nv, n, dk)} {dtype}",
                        F.fused_edgewise_dense_attention(*args),
                        F.fused_edgewise_dense_attention_plain(*args), atol, rtol)
        args = dense_inputs(gn, (256, 4), 5, 64, 56, torch.bfloat16)
        qkv = rn(256, 64, 5, 3, 4, 56, dtype=torch.bfloat16, gen=gn).permute(3, 0, 4, 2, 1, 5)
        args = (*qkv, *args[3:])
        compare(f"strided view inputs (256, 4, 5, 64, 56) bfloat16, "
                f"{F.copy_width(qkv, 56)}-byte copies", F.fused_edgewise_dense_attention(*args),
                F.fused_edgewise_dense_attention_plain(*args), 5e-2, 5e-2)

        say("[4c K4 fused_multihop_attention vs plain] gates " + str(MULTIHOP_GATES))
        for hops in (3, 2):
            for dtype, atol, rtol in ((torch.float32, 2e-5, 2e-4), (torch.bfloat16, 5e-2, 5e-2)):
                ins = [rn(256, 4, 64, 64, dtype=dtype, gen=gk) for _ in range(6)]
                err = compare(f"(256, 4, 64, 64) hops {hops} {dtype}",
                              F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, hops, 0.4),
                              F.fused_multihop_attention_plain(*ins, MULTIHOP_GATES, 0.5, hops,
                                                               0.4), atol, rtol)
                if dtype == torch.float32:
                    errs[K4] = max(errs.get(K4, 0.0), err)
        # D's MultiHopMSA: strided q/k/v views of the two fused qkv outputs.
        qkv = rn(256, 64, 2, 3, 4, 64, gen=gk).permute(2, 3, 0, 4, 1, 5)
        ins = [qkv[p, i] for p in range(2) for i in range(3)]
        compare("strided qkv views (256, 4, 64, 64) hops 3 float32",
                F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, 3, 0.4),
                F.fused_multihop_attention_plain(*ins, MULTIHOP_GATES, 0.5, 3, 0.4), 2e-5, 2e-4)
        for hops in (3, 4):
            ins = [rn(2, 3, 40, 100, gen=gk) for _ in range(6)]
            compare(f"(2, 3, 40, 100) hops {hops} float32",
                    F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, hops, 0.4),
                    F.fused_multihop_attention_plain(*ins, MULTIHOP_GATES, 0.5, hops, 0.4),
                    2e-5, 2e-4)
        # The fp32 kernel off the main shape, with the default gates, with
        # chain_w 0, and at the Gated ViT's hops 2 on D's strided views;
        # from their own generator.
        gm = cuda_generator(6)
        for bh_shape, n, dk in K4_OFF_SHAPES:
            for hops in (2, 3, 4):
                ins = [rn(*bh_shape, n, dk, gen=gm) for _ in range(6)]
                compare(f"{(*bh_shape, n, dk)} hops {hops} float32",
                        F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, hops, 0.4),
                        F.fused_multihop_attention_plain(*ins, MULTIHOP_GATES, 0.5, hops, 0.4),
                        2e-5, 2e-4)
        ins = [rn(256, 4, 64, 64, gen=gm) for _ in range(6)]
        for gates, w in (({}, 0.4), (MULTIHOP_GATES, 0.0)):
            compare(f"(256, 4, 64, 64) hops 3 float32, gates {gates or 'default'}, chain_w {w}",
                    F.fused_multihop_attention(*ins, gates, 0.5, 3, w),
                    F.fused_multihop_attention_plain(*ins, gates, 0.5, 3, w), 2e-5, 2e-4)
        qkv = rn(256, 64, 2, 3, 4, 64, gen=gm).permute(2, 3, 0, 4, 1, 5)
        ins = [qkv[p, i] for p in range(2) for i in range(3)]
        compare(f"strided qkv views (256, 4, 64, 64) hops 2 float32, "
                f"{F.copy_width(ins, 64)}-byte copies",
                F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, 2, 0.4),
                F.fused_multihop_attention_plain(*ins, MULTIHOP_GATES, 0.5, 2, 0.4), 2e-5, 2e-4)
        qkv = rn(2, 33, 2, 3, 3, 54, gen=gm).permute(2, 3, 0, 4, 1, 5)
        ins = [qkv[p, i] for p in range(2) for i in range(3)]
        compare(f"strided qkv views (2, 3, 33, 54) hops 3 float32, "
                f"{F.copy_width(ins, 54)}-byte copies",
                F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, 3, 0.4),
                F.fused_multihop_attention_plain(*ins, MULTIHOP_GATES, 0.5, 3, 0.4), 2e-5, 2e-4)
        # Phase 10's D as the harness matches it at the 5M target (200 wide:
        # dk 50), with the harness's gates and the module's chain weight
        # sigmoid(-2) on the card, on the strided views of its two qkv outputs.
        mh = ab5.mh_extra(ab5.build_argparser().parse_args([]))
        w = torch.sigmoid(torch.tensor(-2.0, device="cuda"))
        ins = [t for _ in range(2) for t in rn(256, 64, 3, 4, 50, gen=gm).permute(2, 0, 3, 1, 4)]
        errs[K4] = max(errs[K4], compare(
            f"ab5's D: strided qkv views (256, 4, 64, 50) hops {mh['hops']} float32, gates "
            f"{mh['gates']}, {F.copy_width(ins, 50)}-byte copies",
            F.fused_multihop_attention(*ins, mh["gates"], mh["beta_not"], mh["hops"], w),
            F.fused_multihop_attention_plain(*ins, mh["gates"], mh["beta_not"], mh["hops"], w),
            2e-5, 2e-4))

        say("[4d K5 fused_quartet_attention vs plain] m 0.3, qscale 1.2")

        def quartet_case(label, ins, dtype):
            rows = "kept rows" if F.quartet_keeps_rows(dtype, ins[0].shape[-2],
                                                       ins[0].shape[-1]) else "streaming"
            got = F.fused_quartet_attention(*ins, 0.3, 1.2)
            want = F.fused_quartet_attention_plain(*ins, 0.3, 1.2)
            if dtype == torch.float32:
                return compare(f"{label} float32, {rows}", got, want, 2e-5, 2e-4)
            err = compare(f"{label} bfloat16, {rows}", got, want, 5e-2, 5e-2)
            # where the probabilities are rounded shows in how many outputs differ
            frac = (got != want).float().mean().item()
            check(frac < 1e-2, f"{frac:.3e} of the bf16 outputs differ from the plain "
                  "version's (limit 1e-2: the same rounding points)")
            return err

        # The LM's shape; N 1 and 100; both sides of the kept-rows threshold
        # at dk 80 (fp32 256 | 288, bf16 768 | 800) and at dk 128 (fp32 128).
        for shape in ((64, 8, 256, 80), (2, 3, 1, 80), (2, 3, 100, 80), (2, 8, 256, 80),
                      (2, 8, 288, 80), (2, 8, 768, 80), (2, 8, 800, 80), (2, 3, 100, 128),
                      (2, 3, 256, 128)):
            for dtype in (torch.float32, torch.bfloat16):
                ins = [rn(*shape, dtype=dtype, gen=gk) for _ in range(5)]
                err = quartet_case(str(shape), ins, dtype)
                if dtype == torch.float32:
                    errs[K5] = max(errs.get(K5, 0.0), err)
        # The LM's CausalSelfAttention: (B, H, T, dk) views of (B, T, C) projections.
        for dtype in (torch.float32, torch.bfloat16):
            ins = [rn(64, 256, 8, 80, dtype=dtype, gen=gk).transpose(1, 2) for _ in range(5)]
            quartet_case(f"strided views (64, 8, 256, 80), {F.copy_width(ins, 80)}-byte copies",
                         ins, dtype)
        # GPT-MoP's train shape (phase 8b), views as its attention passes them;
        # drawn from a generator of its own, so the other phases' inputs stay.
        gm = cuda_generator(6)
        for dtype in (torch.float32, torch.bfloat16):
            ins = [rn(64, 256, 6, 64, dtype=dtype, gen=gm).transpose(1, 2) for _ in range(5)]
            quartet_case(f"GPT-MoP's strided views (64, 6, 256, 64), "
                         f"{F.copy_width(ins, 64)}-byte copies", ins, dtype)

    say("[5 K2b fused_edgewise_lowrank_attention_bwd vs plain backward]")
    grad_names = ("dq", "dk", "dv", "dwrow", "dbrow", "dwcol", "dbcol", "dchain")
    k2b = K2B
    errs[k2b] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, dtype)
        dy = rn(256, 4, 64, 56, dtype=dtype)
        got = F.fused_edgewise_lowrank_attention_bwd(*args, dy)
        want = F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
        for gname, a, b in zip(grad_names, got, want):
            label = f"(256, 4, 5, 64, 56) r=4 {dtype} {gname}"
            if dtype == torch.float32:
                errs[k2b] = max(errs[k2b], compare(label, a, b, 2e-4, 2e-3))
            else:
                compare_rel(label, a, b, BF16_GRAD_FRAC)
    # Off the main shape: two views and rank 1; N < 64 with dk > 64 (two
    # column tiles of every N x dk product).
    for bh_shape, nv, n, dk, r in (((2, 2), 2, 16, 8, 1), ((2, 2), 3, 40, 100, 2)):
        args = edgewise_inputs(g, bh_shape, nv, n, dk, r, torch.float32)
        dy = rn(*bh_shape, n, dk)
        got = F.fused_edgewise_lowrank_attention_bwd(*args, dy)
        want = F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
        for gname, a, b in zip(grad_names, got, want):
            compare(f"{(*bh_shape, nv, n, dk)} r={r} float32 {gname}", a, b, 2e-4, 2e-3)
    # E's EdgewiseMSA: strided per-view views of one stacked qkv output, and
    # the strided dy that merging the heads gives back.
    args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, torch.float32)
    qkv = rn(256, 64, 5, 3, 4, 56).permute(3, 0, 4, 2, 1, 5)
    args = (*qkv, *args[3:])
    dy = rn(256, 64, 4, 56).transpose(1, 2)
    got = F.fused_edgewise_lowrank_attention_bwd(*args, dy)
    want = F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    for gname, a, b in zip(grad_names, got, want):
        compare(f"strided view inputs float32 {gname}", a, b, 2e-4, 2e-3)
    # bf16 off the main shape (two column tiles at dk > 64; N and dk not
    # multiples of 16 or 8) and at the strided view inputs.
    bf = torch.bfloat16
    for bh_shape, nv, n, dk, r in (((2, 2), 2, 16, 8, 1), ((2, 2), 3, 40, 100, 2),
                                   ((2, 3), 4, 33, 54, 2)):
        args = edgewise_inputs(g, bh_shape, nv, n, dk, r, bf)
        dy = rn(*bh_shape, n, dk, dtype=bf)
        got = F.fused_edgewise_lowrank_attention_bwd(*args, dy)
        want = F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
        for gname, a, b in zip(grad_names, got, want):
            compare_rel(f"{(*bh_shape, nv, n, dk)} r={r} bfloat16 {gname}", a, b, BF16_GRAD_FRAC)
    args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, bf)
    qkv = rn(256, 64, 5, 3, 4, 56, dtype=bf).permute(3, 0, 4, 2, 1, 5)
    args = (*qkv, *args[3:])
    dy = rn(256, 64, 4, 56, dtype=bf).transpose(1, 2)
    got = F.fused_edgewise_lowrank_attention_bwd(*args, dy)
    want = F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy)
    for gname, a, b in zip(grad_names, got, want):
        compare_rel(f"strided view inputs bfloat16 {gname}", a, b, BF16_GRAD_FRAC)

    say("[5b K3b fused_edgewise_dense_attention_bwd vs plain backward]")
    dense_names = ("dq", "dk", "dv", "dw1", "db1", "dw2", "db2", "dchain")
    errs[K3B] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = dense_inputs(gd, (256, 4), 5, 64, 56, dtype)
        dy = rn(256, 4, 64, 56, dtype=dtype, gen=gd)
        got = F.fused_edgewise_dense_attention_bwd(*args, dy)
        want = F.fused_edgewise_dense_attention_bwd_plain(*args, dy)
        for gname, a, b in zip(dense_names, got, want):
            label = f"(256, 4, 5, 64, 56) {dtype} {gname}"
            if dtype == torch.float32:
                errs[K3B] = max(errs[K3B], compare(label, a, b, 2e-4, 2e-3))
            else:
                compare_rel(label, a, b, BF16_GRAD_FRAC)
    # Off the main shape: two views, N < 64 with dk > 64 (two column tiles).
    args = dense_inputs(gd, (2, 2), 2, 40, 100, torch.float32)
    dy = rn(2, 2, 40, 100, gen=gd)
    got = F.fused_edgewise_dense_attention_bwd(*args, dy)
    want = F.fused_edgewise_dense_attention_bwd_plain(*args, dy)
    for gname, a, b in zip(dense_names, got, want):
        compare(f"(2, 2, 2, 40, 100) float32 {gname}", a, b, 2e-4, 2e-3)
    args = dense_inputs(gd, (256, 4), 5, 64, 56, torch.float32)
    qkv = rn(256, 64, 5, 3, 4, 56, gen=gd).permute(3, 0, 4, 2, 1, 5)
    args = (*qkv, *args[3:])
    dy = rn(256, 64, 4, 56, gen=gd).transpose(1, 2)
    got = F.fused_edgewise_dense_attention_bwd(*args, dy)
    want = F.fused_edgewise_dense_attention_bwd_plain(*args, dy)
    for gname, a, b in zip(dense_names, got, want):
        compare(f"strided view inputs float32 {gname}", a, b, 2e-4, 2e-3)
    # The redesigned dense edge walk: both instantiations off the main shape
    # (edge blocks cut by N, eight views) and bf16's strided inputs.
    for bh_shape, nv, n, dk, _ in K2_OFF_SHAPES:
        for dtype in (torch.float32, bf):
            args = dense_inputs(gn, bh_shape, nv, n, dk, dtype)
            dy = rn(*bh_shape, n, dk, dtype=dtype, gen=gn)
            got = F.fused_edgewise_dense_attention_bwd(*args, dy)
            want = F.fused_edgewise_dense_attention_bwd_plain(*args, dy)
            for gname, a, b in zip(dense_names, got, want):
                label = f"{(*bh_shape, nv, n, dk)} {dtype} {gname}"
                if dtype == torch.float32:
                    compare(label, a, b, 2e-4, 2e-3)
                else:
                    compare_rel(label, a, b, BF16_GRAD_FRAC)
    args = dense_inputs(gn, (256, 4), 5, 64, 56, bf)
    qkv = rn(256, 64, 5, 3, 4, 56, dtype=bf, gen=gn).permute(3, 0, 4, 2, 1, 5)
    args = (*qkv, *args[3:])
    dy = rn(256, 64, 4, 56, dtype=bf, gen=gn).transpose(1, 2)
    got = F.fused_edgewise_dense_attention_bwd(*args, dy)
    want = F.fused_edgewise_dense_attention_bwd_plain(*args, dy)
    for gname, a, b in zip(dense_names, got, want):
        compare_rel(f"strided view inputs bfloat16 {gname}", a, b, BF16_GRAD_FRAC)

    say("[6 K1 autograd (kernel forward, recompute backward) vs plain autograd]")
    # The ViT path's shape, then the Whisper 20M encoder's (its own generator).
    gw = cuda_generator(16)
    for shape, gen in (((256, 4, 64, 56), g), ((8, 6, 750, 64), gw)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rn(*shape, dtype=dtype, gen=gen).requires_grad_() for _ in range(3))
            do = rn(*shape, dtype=dtype, gen=gen)
            got = torch.autograd.grad(F.flash_attention(q, k, v), (q, k, v), do)
            want = torch.autograd.grad(F.flash_attention_plain(q, k, v), (q, k, v), do)
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                label = f"{shape} {dtype} {gname}"
                if dtype == torch.float32:
                    compare(label, a, b, 2e-4, 2e-3)
                else:
                    compare_rel(label, a, b, BF16_GRAD_FRAC)

    say("[6b K4 and K5 autograd (kernel forward, recompute backward) vs autograd through "
        "the composed reference]")
    for dtype in (torch.float32, torch.bfloat16):
        ins = [rn(256, 4, 64, 64, dtype=dtype, gen=gk).requires_grad_() for _ in range(6)]
        ins.append(torch.tensor(0.4, device="cuda", requires_grad=True))
        dy = rn(256, 4, 64, 64, dtype=dtype, gen=gk)
        outs = (F.fused_multihop_attention(*ins[:6], MULTIHOP_GATES, 0.5, 3, ins[6]),
                F._multihop_reference(*ins, MULTIHOP_GATES, 0.5, 3))
        got, want = (torch.autograd.grad(y, ins, dy) for y in outs)
        ins = [rn(64, 8, 256, 80, dtype=dtype, gen=gk).requires_grad_() for _ in range(5)]
        ins += [torch.tensor(x, device="cuda", requires_grad=True) for x in (0.3, 1.2)]
        dy = rn(64, 8, 256, 80, dtype=dtype, gen=gk)
        outs = (F.fused_quartet_attention(*ins), F._quartet_reference(*ins, 1e-5))
        got5, want5 = (torch.autograd.grad(y, ins, dy) for y in outs)
        for kname, a_s, b_s, names in (("K4", got, want, ("dq1", "dk1", "dv1", "dq2", "dk2",
                                                         "dv2", "dchain")),
                                       ("K5", got5, want5, ("dq", "dk", "dv", "dq2", "dk2",
                                                            "dmixture", "dqscale"))):
            for gname, a, b in zip(names, a_s, b_s):
                label = f"{kname} {dtype} {gname}"
                if dtype == torch.float32:
                    compare(label, a, b, 2e-4, 2e-3)
                else:
                    compare_rel(label, a, b, BF16_GRAD_FRAC)
    del ins, dy, outs, got, want, got5, want5

    say(f"[7 eval path] CIFAR-100 eval step, batch {BATCH}, fp32")
    x_u8 = torch.randint(0, 256, (BATCH, 3, 32, 32), dtype=torch.uint8, device="cuda",
                         generator=g)
    y = torch.randint(0, N_CLASSES, (BATCH,), device="cuda", generator=g)
    valid = torch.ones(BATCH, device="cuda")
    def expected(per_fwd, mode):
        """Launches of an "eval" forward, a "train" step or an "eval_grad"
        (a gradient through the eval forward)."""
        want = {k: 0 for k in launches}
        for k, n in per_fwd.items():
            if mode == "train" and k in EVAL_ONLY:
                continue
            want[k] = n
            if mode != "eval" and k in BWD:
                want[BWD[k]] = n
        return want

    models = {}
    for seed, (name, (ctor, per_fwd)) in enumerate(MODELS.items()):
        model = ctor(torch.Generator().manual_seed(seed))
        models[name] = model
        n_params = sum(p.numel() for p in model.parameters())
        step = make_classifier_eval_step(model, CIFAR100_MEAN, CIFAR100_STD)
        (correct, n_valid), counts = counted(lambda: step(x_u8, y, valid))
        say(f"  {name}: {n_params} params, correct {correct.item():.0f} / {n_valid.item():.0f}, "
            f"launches {launched(counts)}")
        check(counts == expected(per_fwd, "eval"), f"{name}: launches per forward {per_fwd}")
        check(n_valid.item() == BATCH and 0 <= correct.item() <= BATCH,
              f"{name}: eval counts in range")
        with torch.inference_mode():
            x = cifar_eval_transform(x_u8, CIFAR100_MEAN, CIFAR100_STD)
            logits = model(x)
            with plain_kernels():
                ref = model(x)
        check(tuple(logits.shape) == (BATCH, N_CLASSES), f"{name}: logits shape")
        compare(f"{name}: logits kernel path vs plain path", logits, ref, 2e-5, 2e-4)

    say(f"  layers at {N_WIDE} tokens (224/16 images), batch {BATCH_WIDE}, fp32, eval forward "
        "and a train-mode gradient")
    none = {f.__name__: 0 for f in F.KERNELS}
    for lname, (dim, ctor, want_eval, want_train) in WIDE_LAYERS.items():
        layer = init_params(ctor(), torch.Generator().manual_seed(21)).to("cuda")
        xw = rn(BATCH_WIDE, N_WIDE, dim, gen=gn)
        lparams = [p for p in layer.parameters()]

        def wide_grads():
            xr = xw.clone().requires_grad_()
            return torch.autograd.grad(layer.train()(xr).square().mean(), [xr, *lparams])

        with torch.inference_mode():
            y_w, counts = counted(lambda: layer.eval()(xw))
            with plain_kernels():
                ref_w = layer(xw)
        check(counts == {**none, **want_eval} and tuple(y_w.shape) == (BATCH_WIDE, N_WIDE, dim),
              f"{lname} at N {N_WIDE}: eval forward launches {launched(counts)} (expected "
              f"{want_eval or 'none: it composes'})")
        compare(f"{lname} at N {N_WIDE}: eval output vs plain path", y_w, ref_w, 2e-5, 2e-4)
        got, counts = counted(wide_grads)
        with plain_kernels():
            want = wide_grads()
        worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                    for a, b in zip(got, want))
        check(counts == {**none, **want_train} and worst <= 1e-3,
              f"{lname} at N {N_WIDE}: train-mode gradient launches {launched(counts)} "
              f"(expected {want_train or 'none: it composes'}); worst max-abs error "
              f"{worst:.2e} of the tensor's largest grad against the plain path (limit 1e-3)")
        del layer, xw, y_w, ref_w, got, want

    say(f"[7b gradient through the eval forward] batch {BATCH}, fp32")
    x = cifar_eval_transform(x_u8, CIFAR100_MEAN, CIFAR100_STD)
    for name in EVAL_GRAD:
        per_fwd = MODELS[name][1]
        model = models[name].eval()
        params = list(model.parameters())

        def eval_grads():
            loss = torch.nn.functional.cross_entropy(model(x).float(), y)
            return torch.autograd.grad(loss, params)

        got, counts = counted(eval_grads)
        check(counts == expected(per_fwd, "eval_grad"),
              f"{name}: launches of one gradient through the eval forward {launched(counts)}")
        with plain_kernels():
            want = eval_grads()
        worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                    for a, b in zip(got, want))
        check(worst <= 1e-3 and all(bool(torch.isfinite(t).all()) for t in got),
              f"{name}: fp32 grads through the eval forward, kernel path vs plain path over "
              f"{len(got)} tensors: worst max-abs error {worst:.2e} of the tensor's largest "
              "grad (limit 1e-3)")
        del got, want

    t_lm = LM_CONFIG["block_size"]
    say(f"[7c Quartet LM] create_gpt_quartet({LM_VOCAB}, {LM_CONFIG}), eval forward with "
        f"targets, {LM_BATCH} x {t_lm} tokens, fp32")
    lm = create_gpt_quartet(LM_VOCAB, TransformerConfig(**LM_CONFIG),
                            generator=torch.Generator().manual_seed(11)).eval()
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == LM_JAX_PARAMS,
          f"LM: {n_params} params; mop_tpu's count for the same config {LM_JAX_PARAMS}")
    idx = torch.randint(0, LM_VOCAB, (LM_BATCH, t_lm), device="cuda", generator=gk)
    tgt = torch.randint(0, LM_VOCAB, (LM_BATCH, t_lm), device="cuda", generator=gk)
    with torch.inference_mode():
        (logits, loss), counts = counted(lambda: lm(idx, targets=tgt))
        check(counts == expected({K5: LM_CONFIG["n_layer"]}, "eval"),
              f"LM: launches per forward {launched(counts)}")
        with plain_kernels():
            ref_logits, ref_loss = lm(idx, targets=tgt)
        check(tuple(logits.shape) == (LM_BATCH, t_lm, LM_VOCAB), "LM: logits shape")
        compare("LM: logits kernel path vs plain path", logits, ref_logits, 2e-5, 2e-4)
        compare("LM: loss kernel path vs plain path", loss, ref_loss, 2e-5, 2e-4)
        # Random weights predict about uniformly over the vocabulary.
        check(abs(loss.item() - math.log(LM_VOCAB)) < 0.5,
              f"LM: loss {loss.item():.4f} near ln(vocab) {math.log(LM_VOCAB):.4f}")
        del logits, ref_logits
        x0 = rn(LM_BATCH, t_lm, LM_CONFIG["n_embd"], gen=gk)
        (_, att), counts = counted(lambda: lm.blocks[0].attn(x0, need_weights=True))
        check(counts[K5] == 0 and tuple(att.shape) == (LM_BATCH, 8, t_lm, t_lm),
              f"LM: need_weights composes, K5 launches {counts[K5]}")
        lm.config.causal_std = True
        _, counts = counted(lambda: lm(idx, targets=tgt))
        lm.config.causal_std = False
        check(counts[K5] == 0, f"LM: causal_std composes, K5 launches {counts[K5]}")
        del x0, att

    say(f"[8 train path] bench.py recipe at batch {BATCH}: augment, bf16 compute, "
        f"AdamW {LR} / {WD}")
    xk = torch.randint(0, 256, (TRAIN_K, BATCH, 3, 32, 32), dtype=torch.uint8, device="cuda",
                       generator=g)
    yk = torch.randint(0, N_CLASSES, (TRAIN_K, BATCH), device="cuda", generator=g)
    for seed, (name, (ctor, per_fwd)) in enumerate(MODELS.items()):
        model = ctor(torch.Generator().manual_seed(seed), drop_path=0.0)
        got = one_step_grads(model, x_u8, y)
        with plain_kernels():
            want = one_step_grads(model, x_u8, y)
        worst = worst_rel(got, want)
        check(worst <= 1e-3 and all(bool(torch.isfinite(t).all()) for t in got.values()),
              f"{name}: one step's fp32 grads (augment off, drop_path 0), kernel path vs "
              f"plain path over {len(got)} tensors: worst max-abs error {worst:.2e} of the "
              "tensor's largest grad (limit 1e-3)")
        del model, got, want

        model = ctor(torch.Generator().manual_seed(seed))
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
        gen = cuda_generator(seed)
        step = make_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD)
        _, counts = counted(lambda: step(x_u8, y, gen))
        check(counts == expected(per_fwd, "train"),
              f"{name}: launches per train step {launched(counts)}")
        scanned = make_scanned_classifier_train_step(model, opt, CIFAR100_MEAN, CIFAR100_STD,
                                                     unroll_steps=TRAIN_K)
        losses = scanned(x_u8.expand(TRAIN_K, -1, -1, -1, -1), y.expand(TRAIN_K, -1),
                         gen)["loss"].tolist()
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"{name}: loss over {TRAIN_K} steps on one batch {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
        # The rate is every image over all the time of every timed window;
        # the per-window rates show the spread.
        if name == "E_dense":  # the composed train route first, in the same run
            with composed("edgewise_dense_fits"):
                ms, rate, per = train_windows(scanned, xk, yk, gen)
                rows, wall_us = device_breakdown(lambda: scanned(xk, yk, gen), reps=1)
            say(f"  {name} train step through the composed route: {ms:.3f} ms/step, {rate:.0f} "
                f"images/s [per window {', '.join(f'{r:.0f}' for r in per)} images/s], device "
                f"busy {100 * sum(t for _, t in rows) / wall_us:.1f}% [{smi}]")
        ms, rate, per = train_windows(scanned, xk, yk, gen)
        say(f"  {name} train step, batch {BATCH} (scanned K={TRAIN_K}, {TRAIN_WINDOWS} windows "
            f"in total): {ms:.3f} ms/step, {rate:.0f} images/s "
            f"[per window {', '.join(f'{r:.0f}' for r in per)} images/s] [{smi}]")
        rows, wall_us = device_breakdown(lambda: scanned(xk, yk, gen), reps=1)
        busy = sum(t for _, t in rows)
        top = "; ".join(f"{k[:48]} {100 * t / busy:.1f}%" for k, t in rows[:8])
        say(f"    device busy {100 * busy / wall_us:.1f}% of {wall_us / 1e3:.2f} ms "
            f"({TRAIN_K} steps, profiled); by kernel: {top}")
        evaluate = make_classifier_eval_step(model, CIFAR100_MEAN, CIFAR100_STD)
        first = [v.item() for v in evaluate(x_u8, y, valid)]
        again = [v.item() for v in evaluate(x_u8, y, valid)]
        check(not model.training and first == again and first[1] == BATCH,
              f"{name}: eval after training runs in eval mode, counts {first} twice")
        del model, opt, step, scanned

    say(f"[8b LM train path] make_lm_train_step, {LM_BATCH} x {t_lm} tokens, vocab "
        f"{LM_VOCAB}, bf16 compute, AdamW {LM_LR} / {LM_WD}")
    gl8 = cuda_generator(8)
    lm_idx = torch.randint(0, LM_VOCAB, (LM_BATCH, t_lm), device="cuda", generator=gl8)
    lm_tgt = torch.randint(0, LM_VOCAB, (LM_BATCH, t_lm), device="cuda", generator=gl8)

    def lm_train(label, model, per_step, grad_clip, seed):
        """The train path of one LM: fp32 grads and a bf16 loss against the
        plain path, launches per step, the loss over LM_STEPS steps on one
        batch, tokens/s over timed windows and a device-time breakdown."""
        got = lm_step_grads(model, lm_idx, lm_tgt)
        with plain_kernels():
            want = lm_step_grads(model, lm_idx, lm_tgt)
        worst = worst_rel(got, want)
        check(worst <= 1e-3 and all(bool(torch.isfinite(t).all()) for t in got.values()),
              f"{label}: one step's fp32 grads, kernel path vs plain path over {len(got)} "
              f"tensors: worst max-abs error {worst:.2e} of the tensor's largest grad (limit 1e-3)")
        del got, want
        loss = lm_step_loss(model, lm_idx, lm_tgt)
        with plain_kernels():
            ref = lm_step_loss(model, lm_idx, lm_tgt)
        # K5 in bf16 rounds like its plain version but for under 1e-2 of its
        # outputs, by one bf16 step; the mean over 16,384 tokens keeps far less.
        compare(f"{label}: one bf16 step's loss {loss.item():.6f}, kernel path vs plain path",
                loss, ref, 0.0, 1e-3)
        opt = torch.optim.AdamW(model.parameters(), lr=LM_LR, weight_decay=LM_WD)
        step = make_lm_train_step(model, opt, grad_clip=grad_clip)
        gen = cuda_generator(seed)
        first, counts = counted(lambda: step(lm_idx, lm_tgt, gen))
        check(counts == expected(per_step, "train"),
              f"{label}: launches per train step {launched(counts)}")
        losses = [first["loss"].item()] + [step(lm_idx, lm_tgt, gen)["loss"].item()
                                           for _ in range(LM_STEPS - 1)]
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"{label}: loss over {LM_STEPS} steps on one batch {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
        ms, rate, per = timed_windows(lambda: step(lm_idx, lm_tgt, gen), LM_WINDOWS,
                                      LM_WINDOW_STEPS, lm_idx.numel())
        say(f"  {label} train step, {LM_BATCH} x {t_lm} tokens ({LM_WINDOWS} windows of "
            f"{LM_WINDOW_STEPS} steps): {ms:.3f} ms/step, {rate:.0f} tokens/s [per window "
            f"{', '.join(f'{r:.0f}' for r in per)} tokens/s] [{smi}]")
        rows, wall_us = device_breakdown(lambda: step(lm_idx, lm_tgt, gen), reps=2)
        busy = sum(t for _, t in rows)
        top = "; ".join(f"{k[:90]} {100 * t / busy:.1f}%" for k, t in rows[:8])
        say(f"    device busy {100 * busy / wall_us:.1f}% of {wall_us / 1e3:.2f} ms "
            f"(2 steps, profiled); by class: {by_class(rows)}; by kernel: {top}")

    lm_cfg = TransformerConfig(**{**LM_CONFIG, "dropout": 0.0})
    say(f"  LM_quartet: create_gpt_quartet({LM_VOCAB}, {lm_cfg}), grad clip {LM_CLIP}")
    train_lm = create_gpt_quartet(LM_VOCAB, lm_cfg, generator=torch.Generator().manual_seed(12))
    lm_train("LM_quartet", train_lm, {K5: lm_cfg.n_layer}, LM_CLIP, 12)
    del train_lm
    # The whole LM_quartet train step both ways through the kernel switch
    # (config.fused_quartet): K5 with its recompute backward (the default, the
    # JAX module's route) and composed, in turns, with each route's peak memory.
    train_lm = create_gpt_quartet(LM_VOCAB, lm_cfg, generator=torch.Generator().manual_seed(12))
    step = make_lm_train_step(train_lm, torch.optim.AdamW(train_lm.parameters(), lr=LM_LR,
                                                          weight_decay=LM_WD), grad_clip=LM_CLIP)
    gen = cuda_generator(12)
    step_ms, peak_gb = {"kernel": [], "composed": []}, {"kernel": 0.0, "composed": 0.0}
    for route in ("kernel", "composed", "composed", "kernel"):
        kernel_switches.fused_quartet = route == "kernel"
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            F.reset_launch_counts()
            ms, _, _ = timed_windows(lambda: step(lm_idx, lm_tgt, gen), 1, LM_WINDOW_STEPS,
                                     lm_idx.numel())
            ran_k5 = F.fused_quartet_attention.launches > 0
        finally:
            kernel_switches.fused_quartet = True
        step_ms[route].append(ms)
        peak_gb[route] = max(peak_gb[route], torch.cuda.max_memory_allocated() / 2**30)
        check(ran_k5 == (route == "kernel"), f"LM_quartet step, fused_quartet "
              f"{route == 'kernel'}: K5 launched {ran_k5}")
    say(f"  LM_quartet train step by the kernel switch, {LM_BATCH} x {t_lm} tokens, "
        f"{LM_WINDOW_STEPS} steps a turn: K5 route {' / '.join(f'{t:.3f}' for t in step_ms['kernel'])}"
        f" ms/step, peak {peak_gb['kernel']:.2f} GiB; composed (fused_quartet off) "
        f"{' / '.join(f'{t:.3f}' for t in step_ms['composed'])} ms/step, peak "
        f"{peak_gb['composed']:.2f} GiB [{smi}]")
    del train_lm, step

    train_lm = create_gpt_quartet(LM_VOCAB, TransformerConfig(**LM_CONFIG),
                                  generator=torch.Generator().manual_seed(12))
    step = make_lm_train_step(train_lm, torch.optim.AdamW(train_lm.parameters(), lr=LM_LR,
                                                          weight_decay=LM_WD), grad_clip=LM_CLIP)
    m, counts = counted(lambda: step(lm_idx, lm_tgt, cuda_generator(13)))
    check(counts == expected({}, "train") and math.isfinite(m["loss"].item()),
          f"LM_quartet_drop (dropout {LM_CONFIG['dropout']}): one step composes, launches "
          f"{launched(counts)}, loss {m['loss'].item():.4f}")
    del train_lm, step

    mop_cfg = TransformerConfig(**GPT_MOP_CONFIG)
    train_lm = create_gpt_mop(LM_VOCAB, mop_cfg, generator=torch.Generator().manual_seed(14))
    n_params = sum(p.numel() for p in train_lm.parameters())
    say(f"  GPT_MoP: create_gpt_mop({LM_VOCAB}, {mop_cfg}) (tools/bench_lm.py), no grad clip")
    check(n_params == GPT_MOP_JAX_PARAMS,
          f"GPT_MoP: {n_params} params; mop_tpu's count for the same config "
          f"{GPT_MOP_JAX_PARAMS}")
    lm_train("GPT_MoP", train_lm, {K5: mop_cfg.n_layer}, None, 14)
    del train_lm

    # The comparison framework's GPT-MoP: Quartet off, so no kernel runs.
    fw = GPTComparisonFramework(ComparisonConfig())
    fw.build_models(LM_VOCAB)
    fw.init_params(seed=15)
    fw_mop = fw.models["mop"]
    step = make_lm_train_step(fw_mop, torch.optim.AdamW(fw_mop.parameters(), lr=LM_LR,
                                                        weight_decay=LM_WD))
    m, counts = counted(lambda: step(lm_idx, lm_tgt, cuda_generator(15)))
    smoke = fw.test_forward_pass()
    check(fw.param_counts == COMPARISON_JAX_PARAMS and counts == expected({}, "train")
          and math.isfinite(m["loss"].item()) and not any("error" in r for r in smoke.values()),
          f"comparison framework {fw.param_counts}: the GPT-MoP (Quartet off) step composes, "
          f"launches {launched(counts)}, loss {m['loss'].item():.4f}; test_forward_pass "
          f"{ {k: r.get('logits_shape', r.get('error')) for k, r in smoke.items()} }")
    del fw, fw_mop, step, smoke

    say(f"[9 timings] on {smi}")
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, dtype)
        dy = rn(256, 4, 64, 56, dtype=dtype)
        ms = time_ms(lambda: F.fused_edgewise_lowrank_attention_bwd(*args, dy), iters=10)
        plain = time_ms(lambda: F.fused_edgewise_lowrank_attention_bwd_plain(*args, dy),
                        iters=5, reps=3)
        bnd, by = bound_ms(*edgewise_bwd_cost(1024, 5, 64, 56, 4, dtype), dtype)
        say(f"  K2b (256, 4, 5, 64, 56) r=4 {dtype}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), no single library call [{smi}]")
        if dtype == torch.float32:
            k2b_record = dict(
                name=k2b, route="cuda", source="mop_tpu_torch/csrc/edgewise_bwd.cu",
                replaces="mop_tpu/ops/fused.py:641", launches=launches[k2b],
                max_abs_err=errs[k2b], ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None)
        else:  # E's train step runs the bf16 instantiation
            k2b_record["bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                      library_ms=None)
    for dtype in (torch.float32, torch.bfloat16):
        args = dense_inputs(gd, (256, 4), 5, 64, 56, dtype)
        dy = rn(256, 4, 64, 56, dtype=dtype, gen=gd)
        ms = time_ms(lambda: F.fused_edgewise_dense_attention_bwd(*args, dy), iters=10)
        plain = time_ms(lambda: F.fused_edgewise_dense_attention_bwd_plain(*args, dy),
                        iters=5, reps=3)
        bnd, by = bound_ms(*edgewise_dense_bwd_cost(1024, 5, 64, 56, dtype), dtype)
        say(f"  K3b (256, 4, 5, 64, 56) {dtype}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}), no single library call [{smi}]")
        if dtype == torch.float32:
            k3b_record = dict(
                name=K3B, route="cuda", source="mop_tpu_torch/csrc/edgewise_bwd.cu",
                replaces="mop_tpu/ops/fused.py:641", launches=launches[K3B],
                max_abs_err=errs[K3B], ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None)
        else:  # E_dense's train step runs the bf16 instantiation
            k3b_record["bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                      library_ms=None)
    # One E_dense attention layer at bf16, forward and backward in training
    # mode, through the kernel route (K3, K3b) and the composed route, in turns.
    layer = init_params(EdgewiseMSA(224, 4, n_views=5, gate_mode="dense"),
                        torch.Generator().manual_seed(9)).to("cuda", torch.bfloat16).train()
    xl = rn(BATCH, 64, 224, dtype=torch.bfloat16, gen=gd).requires_grad_()
    dyl = rn(BATCH, 64, 224, dtype=torch.bfloat16, gen=gd)
    lparams = [xl, *layer.parameters()]

    def layer_step():
        torch.autograd.grad(layer(xl), lparams, dyl)

    route_ms = {"kernel": [], "composed": []}
    for route in ("kernel", "composed", "composed", "kernel"):
        with composed("edgewise_dense_fits") if route == "composed" else contextlib.nullcontext():
            route_ms[route].append(time_ms(layer_step, iters=10, reps=3))
    say("  E_dense EdgewiseMSA layer (224, 4 heads, 5 views) bf16 forward + backward, batch "
        f"{BATCH}: kernel route (K3 + K3b) {route_ms['kernel'][0]:.4f} / "
        f"{route_ms['kernel'][1]:.4f} ms, composed route {route_ms['composed'][0]:.4f} / "
        f"{route_ms['composed'][1]:.4f} ms [{smi}]")
    say(f"    kernel route faster in both turns: "
        f"{max(route_ms['kernel']) < min(route_ms['composed'])} (EdgewiseMSA trains the "
        "dense head through the kernels)")
    del layer, xl, dyl, lparams
    # One D attention layer (MultiHopMSA, 256 wide, 4 heads, hops 3) at bf16,
    # forward and backward, through K4 with its recompute backward (the
    # layer in eval mode, which without dropout computes the train-mode
    # function) and through the composed route (train mode, the route D and
    # Gated train by), in turns, four of each.
    gl = cuda_generator(7)
    layer = init_params(MultiHopMSA(256, 4, beta_not=0.5, hops=3),
                        torch.Generator().manual_seed(9)).to("cuda", torch.bfloat16)
    xl = rn(BATCH, 64, 256, dtype=torch.bfloat16, gen=gl).requires_grad_()
    dyl = rn(BATCH, 64, 256, dtype=torch.bfloat16, gen=gl)
    lparams = [xl, *layer.parameters()]
    route_ms = {"kernel": [], "composed": []}
    for route in ("kernel", "composed", "composed", "kernel") * 2:
        layer.train(route == "composed")
        F.reset_launch_counts()
        route_ms[route].append(time_ms(layer_step, iters=10, reps=3))
        ran_k4 = F.fused_multihop_attention.launches > 0
        check(ran_k4 == (route == "kernel"), f"D layer {route} route: K4 launched {ran_k4}")
    say("  D MultiHopMSA layer (256, 4 heads, hops 3) bf16 forward + backward, batch "
        f"{BATCH}: K4 + recompute route {' / '.join(f'{t:.4f}' for t in route_ms['kernel'])} "
        f"ms, composed route {' / '.join(f'{t:.4f}' for t in route_ms['composed'])} ms [{smi}]")
    faster = [r for r, o in (("kernel", "composed"), ("composed", "kernel"))
              if max(route_ms[r]) < min(route_ms[o])]
    say(f"    faster in every turn: {faster[0] if faster else 'neither'} route (MultiHopMSA and "
        "DualPathMSA train composed)")
    del layer, xl, dyl, lparams
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rn(1024, 64, 56, dtype=dtype) for _ in range(3))
            ms = time_ms(lambda: F.flash_attention(q, k, v))
            plain = time_ms(lambda: F.flash_attention_plain(q, k, v))
            q4, k4, v4 = (t.view(256, 4, 64, 56) for t in (q, k, v))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)

            lib = time_ms(sdpa)
            dev = graph_ms(lambda: F.flash_attention(q, k, v))
            lib_dev = graph_ms(sdpa)
            bnd, by = bound_ms(*flash_cost(1024, 64, 64, 56, dtype), dtype)
            say(f"  K1 (1024, 64, 56) {dtype}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}); in a CUDA graph kernel "
                f"{dev:.4f} ms, sdpa {lib_dev:.4f} ms [{smi}]")
            row = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
                       device_ms=dev, library_device_ms=lib_dev)
            if dtype == torch.float32:
                k1_record = dict(
                    name="flash_attention", route="cuda",
                    source="mop_tpu_torch/csrc/flash_fwd.cu",
                    replaces="mop_tpu/ops/fused.py:109", launches=launches["flash_attention"],
                    max_abs_err=errs["flash_attention"], **row)
                records.append(k1_record)
            else:  # the train steps run K1 in bf16
                k1_record["bf16"] = row
        # K1 at Whisper's encoder and cross-attention shapes (phase 11's 20M
        # config), beside sdpa on the same (B, H, N, dk) tensors; from their own
        # generator.
        gw = cuda_generator(17)
        for dtype in (torch.float32, torch.bfloat16):
            for site, q_shape, kv_shape in (("encoder", (8, 6, 750, 64), (8, 6, 750, 64)),
                                            ("cross", (8, 6, 112, 64), (8, 6, 750, 64))):
                q = rn(*q_shape, dtype=dtype, gen=gw)
                k, v = (rn(*kv_shape, dtype=dtype, gen=gw) for _ in range(2))

                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(q, k, v)

                ms = time_ms(lambda: F.flash_attention(q, k, v))
                plain = time_ms(lambda: F.flash_attention_plain(q, k, v), iters=10)
                lib = time_ms(sdpa)
                dev = graph_ms(lambda: F.flash_attention(q, k, v))
                lib_dev = graph_ms(sdpa)
                bnd, by = bound_ms(*flash_cost(48, q_shape[2], kv_shape[2], 64, dtype), dtype)
                say(f"  K1 Whisper {site} q {q_shape} kv {kv_shape[2]} {dtype}: kernel "
                    f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms "
                    f"({by}); in a CUDA graph kernel {dev:.4f} ms, sdpa {lib_dev:.4f} ms [{smi}]")
                key = f"whisper_{site}_{'fp32' if dtype == torch.float32 else 'bf16'}"
                k1_record[key] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                      library_ms=lib, device_ms=dev, library_device_ms=lib_dev)
        del q, k, v
        for dtype in (torch.float32, torch.bfloat16):
            args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, dtype)
            ms = time_ms(lambda: F.fused_edgewise_lowrank_attention(*args))
            plain = time_ms(lambda: F.fused_edgewise_lowrank_attention_plain(*args))
            bnd, by = bound_ms(*edgewise_cost(1024, 5, 64, 56, 4, dtype), dtype)
            say(f"  K2 (256, 4, 5, 64, 56) r=4 {dtype}: kernel {ms:.4f} ms (before "
                f"{BEFORE_MS[('K2', dtype)]}), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}) "
                f"[{smi}]")
            if dtype == torch.float32:
                k2_record = dict(
                    name="fused_edgewise_lowrank_attention", route="cuda",
                    source="mop_tpu_torch/csrc/edgewise_lowrank_fwd.cu",
                    replaces="mop_tpu/ops/fused.py:628",
                    launches=launches["fused_edgewise_lowrank_attention"],
                    max_abs_err=errs["fused_edgewise_lowrank_attention"], ms=ms,
                    plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
                records.append(k2_record)
            else:  # E's train step runs the tensor-core kernel
                k2_record["bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=None)
        records.append(k2b_record)
        for dtype in (torch.float32, torch.bfloat16):
            args = dense_inputs(gd, (256, 4), 5, 64, 56, dtype)
            ms = time_ms(lambda: F.fused_edgewise_dense_attention(*args))
            plain = time_ms(lambda: F.fused_edgewise_dense_attention_plain(*args))
            bnd, by = bound_ms(*edgewise_dense_cost(1024, 5, 64, 56, dtype), dtype)
            say(f"  K3 (256, 4, 5, 64, 56) {dtype}: kernel {ms:.4f} ms (before "
                f"{BEFORE_MS[('K3', dtype)]}), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), no "
                f"single library call [{smi}]")
            if dtype == torch.float32:
                k3_record = dict(
                    name="fused_edgewise_dense_attention", route="cuda",
                    source="mop_tpu_torch/csrc/edgewise_dense_fwd.cu",
                    replaces="mop_tpu/ops/fused.py:628",
                    launches=launches["fused_edgewise_dense_attention"],
                    max_abs_err=errs["fused_edgewise_dense_attention"], ms=ms,
                    plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None)
                records.append(k3_record)
            else:  # E_dense's train step runs it in bf16
                k3_record["bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=None)
        records.append(k3b_record)
        for dtype in (torch.float32, torch.bfloat16):
            for hops in (3, 2):
                ins = [rn(256, 4, 64, 64, dtype=dtype, gen=gk) for _ in range(6)]
                # ms passes chain_w as a Python float, as K4 was timed before
                # its redesign: each call copies it to the card and waits for
                # the stream. device_w_ms passes a device scalar, as the
                # models do, and fp32's device_ms replays that from a CUDA
                # graph: the device time alone.
                w4 = torch.tensor(0.4, device="cuda")

                def k4():
                    return F.fused_multihop_attention(*ins, MULTIHOP_GATES, 0.5, hops, w4)

                ms = time_ms(lambda: F.fused_multihop_attention(
                    *ins, MULTIHOP_GATES, 0.5, hops, 0.4))
                ms_dev_w = time_ms(k4)
                plain = time_ms(lambda: F.fused_multihop_attention_plain(
                    *ins, MULTIHOP_GATES, 0.5, hops, 0.4), iters=10)
                bnd, by = bound_ms(*multihop_cost(1024, 64, 64, hops, dtype), dtype)
                dev = graph_ms(k4) if dtype == torch.float32 else None
                graphed = f", in a CUDA graph {dev:.4f} ms" if dev is not None else ""
                say(f"  K4 (256, 4, 64, 64) hops {hops} {dtype}: kernel {ms:.4f} ms (before "
                    f"{BEFORE_MS.get(('K4', dtype, hops), 'not measured')}); with a device "
                    f"chain_w {ms_dev_w:.4f} ms{graphed}; plain {plain:.4f} ms, bound "
                    f"{bnd:.4f} ms ({by}), no single library call [{smi}]")
                row = dict(ms=ms, device_w_ms=ms_dev_w, plain_ms=plain, bound_ms=bnd,
                           bound_by=by, library_ms=None)
                if dev is not None:
                    row["device_ms"] = dev
                if dtype == torch.float32 and hops == 3:
                    k4_record = dict(
                        name=K4, route="cuda", source="mop_tpu_torch/csrc/multihop_fwd.cu",
                        replaces="mop_tpu/ops/fused.py:289", launches=launches[K4],
                        max_abs_err=errs[K4], **row)
                    records.append(k4_record)
                else:  # Gated runs hops 2; no main path runs bf16 K4
                    k4_record[f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}_hops{hops}"] = row
        for dtype in (torch.float32, torch.bfloat16):
            ins = [rn(64, 8, 256, 80, dtype=dtype, gen=gk) for _ in range(5)]
            ms = time_ms(lambda: F.fused_quartet_attention(*ins, 0.3, 1.2), iters=10)
            plain = time_ms(lambda: F.fused_quartet_attention_plain(*ins, 0.3, 1.2), iters=5,
                            reps=3)
            bnd, by = bound_ms(*quartet_cost(512, 256, 80, dtype), dtype)
            say(f"  K5 (64, 8, 256, 80) {dtype}: kernel {ms:.4f} ms (before "
                f"{BEFORE_MS[('K5', dtype)]}), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), no "
                f"single library call [{smi}]")
            if dtype == torch.float32:
                k5_record = dict(
                    name=K5, route="cuda", source="mop_tpu_torch/csrc/quartet_fwd.cu",
                    replaces="mop_tpu/ops/fused.py:888", launches=launches[K5],
                    max_abs_err=errs[K5], ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=None)
                records.append(k5_record)
            else:
                k5_record["bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=None)
        # GPT-MoP's train launches (phase 8b): bf16 at (64, 6, 256, 64).
        ins = [rn(64, 6, 256, 64, dtype=torch.bfloat16, gen=gk) for _ in range(5)]
        ms = time_ms(lambda: F.fused_quartet_attention(*ins, 0.3, 1.2), iters=10)
        plain = time_ms(lambda: F.fused_quartet_attention_plain(*ins, 0.3, 1.2), iters=5, reps=3)
        bnd, by = bound_ms(*quartet_cost(384, 256, 64, torch.bfloat16), torch.bfloat16)
        say(f"  K5 (64, 6, 256, 64) torch.bfloat16 (GPT-MoP): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), no single library call [{smi}]")
        k5_record["bf16_gpt_mop"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                         library_ms=None)
        del ins
        x = cifar_eval_transform(x_u8, CIFAR100_MEAN, CIFAR100_STD)
        for name, model in models.items():
            ms = time_ms(lambda: model(x), iters=10)
            say(f"  {name} fp32 forward, batch {BATCH}: {ms:.3f} ms, "
                f"{BATCH / ms * 1e3:.0f} images/s [{smi}]")
            rows, wall_us = device_breakdown(lambda: model(x))
            busy = sum(t for _, t in rows)
            top = "; ".join(f"{k[:48]} {100 * t / busy:.1f}%" for k, t in rows[:6])
            say(f"    device busy {100 * busy / wall_us:.1f}% of {wall_us / 1e3:.2f} ms "
                f"(5 forwards, profiled); by kernel: {top}")
        ms = time_ms(lambda: lm(idx, targets=tgt), iters=3, reps=3)
        say(f"  LM fp32 eval forward with loss, {LM_BATCH} x {t_lm} tokens: {ms:.3f} ms, "
            f"{LM_BATCH * t_lm / ms * 1e3:.0f} tokens/s [{smi}]")
        rows, wall_us = device_breakdown(lambda: lm(idx, targets=tgt), reps=2)
        busy = sum(t for _, t in rows)
        top = "; ".join(f"{k[:48]} {100 * t / busy:.1f}%" for k, t in rows[:6])
        say(f"    device busy {100 * busy / wall_us:.1f}% of {wall_us / 1e3:.2f} ms "
            f"(2 forwards, profiled); by kernel: {top}")
    # The gradient through the eval forward (phase 7b), fp32: D's runs K4 in
    # its forward and recomputes the composed forward for its backward.
    x = cifar_eval_transform(x_u8, CIFAR100_MEAN, CIFAR100_STD)
    for name in EVAL_GRAD:
        model = models[name].eval()
        params = list(model.parameters())

        def eval_grads():
            loss = torch.nn.functional.cross_entropy(model(x).float(), y)
            return torch.autograd.grad(loss, params)

        ms = time_ms(eval_grads, iters=3, reps=3)
        say(f"  {name} fp32 gradient through the eval forward, batch {BATCH}: {ms:.3f} ms "
            f"[{smi}]")
        rows, wall_us = device_breakdown(eval_grads, reps=2)
        busy = sum(t for _, t in rows)
        top = "; ".join(f"{k[:48]} {100 * t / busy:.1f}%" for k, t in rows[:6])
        say(f"    device busy {100 * busy / wall_us:.1f}% of {wall_us / 1e3:.2f} ms "
            f"(2 gradients, profiled); by kernel: {top}")
    check(all(c > 0 for k, c in launches.items() if k not in (WIDE_FWD, WIDE_BWD)),
          f"every kernel but K2w and K2bw (phase 12's) launched on the main path: {launches}")
    # The ab5 run's totals (20 steps and its eval forwards) in a field of
    # their own: ``launches`` stays per train step and per forward.
    work = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 10's files, read in 15b
    try:
        ab5_counts = harness_phases(smi, os.path.join(work, "ab5"))
        whisper_phases(smi)
        k1_rows, wide_records = moe_voc_imagenet_phases(smi)
        k1_record.update(k1_rows)
        records.extend(wide_records)
        k5_record.update(decode_phases(smi))
        serving_phases(smi)
        t15 = time.perf_counter()
        for counts in (trainer_phase(smi, work), cli_phase(smi, work, os.path.join(work, "ab5"))):
            for k_name, c in counts.items():
                launches[k_name] += c
        say(f"  phase 15 took {time.perf_counter() - t15:.1f} s")
        serving_export_phases(smi)
        multi_gpu_phases(smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(all(c > 0 for c in launches.values()),
          f"every kernel launched on the main paths: {launches}")
    for rec in records:  # K1's main-path launches now include Whisper's, MoE's, VOC's and 15's
        rec["launches"] = launches[rec["name"]]
        rec["launches_ab5"] = ab5_counts[rec["name"]]
    say(f"total {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": records}))
    print(smi)
    if failures:
        say(f"FAILED: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
