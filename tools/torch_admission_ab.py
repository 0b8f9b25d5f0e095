"""Time the port's serving admissions on one CUDA card, eager and graphed, so
that two trees of the repo can be compared in one run on one machine.

    PYTHONPATH=. python tools/torch_admission_ab.py --label change
    PYTHONPATH=<other tree> python tools/torch_admission_ab.py --label parent

``PYTHONPATH`` names the tree whose ``mop_tpu_torch`` is timed; the script
uses only the engines' public constructors, ``submit`` / ``step`` / ``run``
and the admission methods both trees have (``_admit_one``,
``_chunk_advance``), which it wraps with a wall clock. Random weights from
fixed seeds, ``chip_smoke.py`` phase 14's configurations, each workload
run once to warm (graphed: every graph captured) and then timed:

- ``bucketed``: Serve_6x512 (6 x 512, vocab 512, buckets 64-512, 8 slots),
  32 mixed jobs of 48-249 prompt tokens and 64 new in one run: tokens/s, the
  admissions' share of the wall and each admission's wall;
- ``chunked``: the same model, ``chunk_prefill=64``, the first 8 jobs: each
  admission call's and each chunk's wall;
- ``prefix``: a 192-token system prompt and 7 prompts that share it, served
  one at a time through ``prefix_cache_entries=4``: each hit's admission;
- ``slo``: Serve_170M (12 x 1024, block 2048, vocab 512, bucket 128, 4
  slots) under a closed loop of 4 users, 16 requests of 128 + 32 tokens:
  requests/s, TTFT and TPOT p50, each admission's wall.

Prints one JSON line per (workload, form), the card's name and power limit
in each. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

VOCAB = 512
SERVE_CFG = dict(n_layer=6, n_head=8, n_embd=512, dropout=0.0, block_size=512)
BUCKETS = [64, 128, 256, 512]
MAX_BATCH, JOBS, NEW, PROMPTS = 8, 32, 64, (48, 250)
CHUNK, SYSTEM, TAILS, PREFIX_NEW = 64, 192, (16, 48), 32
SLO_CFG = dict(n_layer=12, n_head=16, n_embd=1024, dropout=0.0, block_size=2048)
SLO_MB, SLO_PROMPT, SLO_NEW, SLO_REQS = 4, 128, 32, 16


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def watch(eng) -> list:
    """Each admission-side call's wall, appended as (method, seconds, a prefix hit,
    returned a value)."""
    walls = []
    for name in ("_admit_one", "_chunk_advance"):
        fn = getattr(eng, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            hits = eng.prefix_cache_hits
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            walls.append((_name, time.perf_counter() - t0, eng.prefix_cache_hits > hits,
                          out is not None))
            return out

        setattr(eng, name, timed)
    return walls


def ms(xs) -> dict:
    xs = 1e3 * np.asarray(xs, dtype=float)
    return {"n": int(xs.size), "mean_ms": float(xs.mean()) if xs.size else None,
            "p50_ms": float(np.median(xs)) if xs.size else None}


def serve(eng, jobs) -> list:
    rids = [eng.submit(p, n) for p, n in jobs]
    res = eng.run()
    return [res[r] for r in rids]


def bucketed(model, params, graphed, jobs):
    from mop_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, params, max_batch=MAX_BATCH, prefill_buckets=BUCKETS,
                       cuda_graph=graphed)
    serve(eng, [(p, 2) for p, _ in jobs])  # every bucket admitted once
    walls = watch(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve(eng, jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    adm = [s for name, s, _, done in walls if name == "_admit_one" and done]
    return {"tokens_per_s": sum(map(len, out)) / wall, "wall_s": wall,
            "admit_share": sum(adm) / wall, "admission": ms(adm)}


def chunked(model, params, graphed, jobs):
    from mop_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, params, max_batch=MAX_BATCH, chunk_prefill=CHUNK,
                       cuda_graph=graphed)
    serve(eng, jobs[:MAX_BATCH])
    walls = watch(eng)
    serve(eng, jobs[:MAX_BATCH])
    return {"admit_call": ms([s for name, s, _, done in walls
                              if name == "_admit_one" and done]),
            "chunk": ms([s for name, s, _, _ in walls if name == "_chunk_advance"])}


def prefix(model, params, graphed, rs):
    from mop_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, params, max_batch=MAX_BATCH, prefix_cache_entries=4,
                       cuda_graph=graphed)
    tails = [[int(t) for t in rs.randint(0, VOCAB, rs.randint(*TAILS))]
             for _ in range(MAX_BATCH)]
    walls = []
    for timed in (False, True):  # a system prompt of its own each pass: its first a miss
        system = [int(t) for t in rs.randint(0, VOCAB, SYSTEM)]
        walls = watch(eng) if timed else walls
        for tail in tails:
            serve(eng, [(system + tail, PREFIX_NEW)])
    return {"hit": ms([s for name, s, hit, _ in walls if name == "_admit_one" and hit])}


def slo(model, params, graphed, prompts):
    from mop_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, params, max_batch=SLO_MB, prefill_buckets=[SLO_PROMPT],
                       cuda_graph=graphed)
    serve(eng, [(prompts[0], 4), (prompts[1], 4)])
    walls = watch(eng)
    queue, submit_t, first_t, last_t, ntok, live = list(prompts), {}, {}, {}, {}, set()

    def submit():
        rid = eng.submit(queue.pop(0), SLO_NEW)
        submit_t[rid] = time.perf_counter()
        live.add(rid)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SLO_MB):
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
    ttft = [first_t[r] - submit_t[r] for r in submit_t]
    tpot = [(last_t[r] - first_t[r]) / (ntok[r] - 1) for r in submit_t if ntok[r] > 1]
    adm = [s for name, s, _, done in walls if name == "_admit_one" and done]
    return {"requests_per_s": len(submit_t) / wall, "ttft": ms(ttft), "tpot": ms(tpot),
            "admit_share": sum(adm) / wall, "admission": ms(adm)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="the tree's name in the output")
    ap.add_argument("--forms", default="eager,graphed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mop_tpu_torch import TransformerConfig, create_gpt_quartet, decode_params
    smi = card()
    rs = np.random.RandomState(0)
    jobs = [([int(t) for t in rs.randint(0, VOCAB, rs.randint(*PROMPTS))], NEW)
            for _ in range(JOBS)]
    slo_prompts = [[int(t) for t in rs.randint(0, VOCAB, SLO_PROMPT)] for _ in range(SLO_REQS)]
    small = create_gpt_quartet(VOCAB, TransformerConfig(**SERVE_CFG),
                               generator=torch.Generator().manual_seed(50)).eval()
    big = create_gpt_quartet(VOCAB, TransformerConfig(**SLO_CFG),
                             generator=torch.Generator().manual_seed(51)).eval()
    sp, bp = decode_params(small), decode_params(big)
    for form in args.forms.split(","):
        graphed = form == "graphed"
        for name, fn in (("bucketed", lambda: bucketed(small, sp, graphed, jobs)),
                         ("chunked", lambda: chunked(small, sp, graphed, jobs)),
                         ("prefix", lambda: prefix(small, sp, graphed,
                                                   np.random.RandomState(1))),
                         ("slo", lambda: slo(big, bp, graphed, slo_prompts))):
            with torch.no_grad():
                row = fn()
            print(json.dumps({"label": args.label, "workload": name, "form": form, **row,
                              "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
