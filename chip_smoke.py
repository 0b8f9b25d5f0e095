#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mop_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one line each (a failed phase makes the script exit non-zero):

1. the device, with ``nvidia-smi``'s name and power limit;
2. build every kernel of the path from ``mop_tpu_torch/csrc`` with nvcc;
3. K1 ``flash_attention`` against its plain PyTorch version on the card;
4. K2 ``fused_edgewise_lowrank_attention`` against its plain version;
5. the main path: CIFAR-100 eval steps of the full-width 5M-parameter A, B
   and E configurations at batch 256 in fp32, with kernel launch counts and
   the logits held against the same model run through the plain versions;
6. timings: each kernel at its path shape beside its plain version, its
   bound and one library call where there is one, and each model's
   images/s with a torch.profiler breakdown of its device time.

The last three lines are the kernels JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Weights and data are random,
made from fixed seeds. No JAX is imported.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

from mop_tpu_torch import (CIFAR100_MEAN, CIFAR100_STD, ViT_Baseline, ViT_MoP, ViTEdgewise,
                           make_classifier_eval_step)
from mop_tpu_torch.ops import _build
from mop_tpu_torch.ops import fused as F
from mop_tpu_torch.ops.preprocess import cifar_eval_transform

BATCH = 256
N_CLASSES = 100
# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 off the tensor cores
PEAK_BYTES = 3.35e12

# Full-width configs of experiments/cifar100_ab5_param_budgets.py at the 5M
# target (A, B, E) and of bench.py (B at 224/6/4).
MODELS = {
    "A": (lambda g: ViT_Baseline(dim=224, depth=8, heads=4, n_classes=N_CLASSES,
                                 generator=g), "flash_attention", 8),
    "B": (lambda g: ViT_MoP(dim=216, depth=8, heads=4, n_classes=N_CLASSES, n_views=5,
                            n_kernels=3, generator=g), "flash_attention", 8),
    "B_bench": (lambda g: ViT_MoP(dim=224, depth=6, heads=4, n_classes=N_CLASSES,
                                  n_views=5, n_kernels=3, generator=g),
                "flash_attention", 6),
    "E": (lambda g: ViTEdgewise(dim=224, depth=4, heads=4, n_classes=N_CLASSES,
                                n_views=5, share_qkv=False, gate_mode="lowrank",
                                gate_rank=4, gate_init="mix5", mlp_ratio=4.0, generator=g),
          "fused_edgewise_lowrank_attention", 4),
}

failures = []


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


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_cost(bh, n, n_kv, dk, dtype):
    esize = torch.finfo(dtype).bits // 8
    return 4 * bh * n * n_kv * dk, esize * bh * dk * (2 * n + 2 * n_kv)


def edgewise_cost(bh, nv, n, dk, r, dtype):
    esize = torch.finfo(dtype).bits // 8
    c = 2 * nv + 2
    per_prog = (nv * 2 * n * n * dk            # S_i
                + 2 * (nv - 1) * 2 * n ** 3     # forward and backward chains
                + 2 * 2 * n * c * 4 * r         # rank factors
                + 4 * 2 * n * n * r             # gates
                + (nv - 1) * 2 * n * n * dk     # value transport
                + 2 * 2 * n * n * dk)           # att v_0 and A_0 transport
    nbytes = esize * bh * dk * n * (3 * nv + 1) + 4 * (2 * c * 4 * r + 2 * 4 * r + 1)
    return bh * per_prog, nbytes


@contextlib.contextmanager
def plain_kernels():
    """Route the models through the kernels' plain versions (the reference)."""
    saved = F.flash_attention, F.fused_edgewise_lowrank_attention
    F.flash_attention = F.flash_attention_plain
    F.fused_edgewise_lowrank_attention = F.fused_edgewise_lowrank_attention_plain
    try:
        yield
    finally:
        F.flash_attention, F.fused_edgewise_lowrank_attention = saved


def edgewise_inputs(g, bh_shape, nv, n, dk, r, dtype):
    def rn(*s):
        return torch.randn(*s, device="cuda", generator=g)
    c = 2 * nv + 2
    qs, ks, vs = (rn(*bh_shape, nv, n, dk).to(dtype) for _ in range(3))
    return (qs, ks, vs, rn(c, 4 * r) * 0.3, torch.linspace(-0.5, 0.5, 4 * r, device="cuda"),
            rn(c, 4 * r) * 0.3, torch.linspace(0.5, -0.5, 4 * r, device="cuda"), 0.5,
            torch.tensor(0.4, device="cuda"))


def main() -> int:
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
        regs = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"  {name}: {' | '.join(regs)}")
    say(f"[2 build] {len(libs)} kernels from mop_tpu_torch/csrc in {time.time() - t0:.1f} s")

    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*s, dtype=torch.float32):
        return torch.randn(*s, device="cuda", generator=g).to(dtype)

    errs = {}
    say("[3 K1 flash_attention vs plain]")
    with torch.inference_mode():
        for dtype, atol, rtol in ((torch.float32, 2e-5, 0.0), (torch.bfloat16, 5e-2, 5e-2)):
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

    say(f"[5 main path] CIFAR-100 eval step, batch {BATCH}, fp32")
    x_u8 = torch.randint(0, 256, (BATCH, 3, 32, 32), dtype=torch.uint8, device="cuda",
                         generator=g)
    y = torch.randint(0, N_CLASSES, (BATCH,), device="cuda", generator=g)
    valid = torch.ones(BATCH, device="cuda")
    launches = {f.__name__: 0 for f in F.KERNELS}
    models = {}
    for seed, (name, (ctor, kernel, expect)) in enumerate(MODELS.items()):
        model = ctor(torch.Generator().manual_seed(seed))
        models[name] = model
        n_params = sum(p.numel() for p in model.parameters())
        step = make_classifier_eval_step(model, CIFAR100_MEAN, CIFAR100_STD)
        F.reset_launch_counts()
        correct, n_valid = step(x_u8, y, valid)
        torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in F.KERNELS}
        for k_name, c in counts.items():
            launches[k_name] += c
        say(f"  {name}: {n_params} params, correct {correct.item():.0f} / {n_valid.item():.0f}, "
            f"launches {counts}")
        check(counts[kernel] == expect and sum(counts.values()) == expect,
              f"{name}: {expect} launches of {kernel} per forward")
        check(n_valid.item() == BATCH and 0 <= correct.item() <= BATCH,
              f"{name}: eval counts in range")
        with torch.inference_mode():
            x = cifar_eval_transform(x_u8, CIFAR100_MEAN, CIFAR100_STD)
            logits = model(x)
            with plain_kernels():
                ref = model(x)
        check(tuple(logits.shape) == (BATCH, N_CLASSES), f"{name}: logits shape")
        compare(f"{name}: logits kernel path vs plain path", logits, ref, 2e-5, 2e-4)

    say(f"[6 timings] on {smi}")
    records = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rn(1024, 64, 56, dtype=dtype) for _ in range(3))
            ms = time_ms(lambda: F.flash_attention(q, k, v))
            plain = time_ms(lambda: F.flash_attention_plain(q, k, v))
            q4, k4, v4 = (t.view(256, 4, 64, 56) for t in (q, k, v))
            lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4))
            bnd, by = bound_ms(*flash_cost(1024, 64, 64, 56, dtype), dtype)
            say(f"  K1 (1024, 64, 56) {dtype}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}) [{smi}]")
            if dtype == torch.float32:
                records.append(dict(
                    name="flash_attention", route="cuda",
                    source="mop_tpu_torch/csrc/flash_fwd.cu",
                    replaces="mop_tpu/ops/fused.py:109", launches=launches["flash_attention"],
                    max_abs_err=errs["flash_attention"], ms=ms, plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=lib))
        for dtype in (torch.float32, torch.bfloat16):
            args = edgewise_inputs(g, (256, 4), 5, 64, 56, 4, dtype)
            ms = time_ms(lambda: F.fused_edgewise_lowrank_attention(*args))
            plain = time_ms(lambda: F.fused_edgewise_lowrank_attention_plain(*args))
            bnd, by = bound_ms(*edgewise_cost(1024, 5, 64, 56, 4, dtype), dtype)
            say(f"  K2 (256, 4, 5, 64, 56) r=4 {dtype}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}) [{smi}]")
            if dtype == torch.float32:
                records.append(dict(
                    name="fused_edgewise_lowrank_attention", route="cuda",
                    source="mop_tpu_torch/csrc/edgewise_lowrank_fwd.cu",
                    replaces="mop_tpu/ops/fused.py:628",
                    launches=launches["fused_edgewise_lowrank_attention"],
                    max_abs_err=errs["fused_edgewise_lowrank_attention"], ms=ms,
                    plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=None))
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
    check(all(c > 0 for c in launches.values()), f"every kernel launched on the main path: {launches}")
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
