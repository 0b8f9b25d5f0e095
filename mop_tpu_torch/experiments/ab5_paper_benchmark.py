#!/usr/bin/env python
"""Aggregate A/B/C/D/E result CSVs into Markdown / LaTeX mean±std tables.

The counterpart of ``experiments/ab5_paper_benchmark.py``, copied (it is
plain Python over files): globs ``tournament_target_*.csv``,
``cifar100_ab5_target_*.csv`` and ``imagenet_ab_target_*.csv`` under the
input directories, groups the per-seed accuracies by the target in each
file name and writes ``ab5_benchmark.md`` and ``ab5_benchmark.tex``. It
computes nothing on a device, so it has no ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List

import numpy as np

TARGET_KEYS = ("tournament_target_", "cifar100_ab5_target_", "imagenet_ab_target_")
MODEL_ORDER = ("A", "B", "C", "D", "E")


def _read_rows(path: str):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    headers = [h.strip() for h in lines[0].split(",")]
    rows = []
    for ln in lines[1:]:
        vals = []
        for v in ln.split(",")[1:]:  # col 0 is the seed
            try:
                vals.append(float(v))
            except ValueError:
                vals.append(float("nan"))
        rows.append(vals)
    return headers, rows


def _target_of(filename: str) -> str:
    for key in TARGET_KEYS:
        if key in filename:
            return filename.split(key, 1)[1].split(".")[0]
    return "unknown"


def collect_results(inputs: List[str], patterns: List[str]) -> Dict[str, Dict[str, List[float]]]:
    """target -> model key -> per-seed accuracies."""
    files = sorted({
        p for root in inputs for pat in patterns
        for p in glob.glob(os.path.join(root, pat))
    })
    out: Dict[str, Dict[str, List[float]]] = {}
    for path in files:
        target = _target_of(os.path.basename(path))
        headers, rows = _read_rows(path)
        keys = [h.split("acc_", 1)[1] if h.startswith("acc_") else h
                for h in headers[1:]]
        bucket = out.setdefault(target, {})
        for i, k in enumerate(keys):
            bucket.setdefault(k, []).extend(r[i] for r in rows if i < len(r))
    return out


def _pm(vals: List[float], decimals: int = 4) -> str:
    arr = np.asarray([v for v in vals if np.isfinite(v)], np.float64)
    if arr.size == 0:
        return "-"
    return f"{arr.mean():.{decimals}f}±{arr.std():.{decimals}f}"


def to_markdown(collected) -> str:
    lines = ["| Target | A | B | C | D | E |", "|---|---|---|---|---|---|"]
    for target in sorted(collected, key=lambda x: (len(x), x)):
        cells = [target] + [_pm(collected[target].get(k, [])) for k in MODEL_ORDER]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def to_latex(collected) -> str:
    lines = ["\\begin{tabular}{lccccc}", "\\toprule",
             "Target & A & B & C & D & E \\\\", "\\midrule"]
    for target in sorted(collected, key=lambda x: (len(x), x)):
        vals = [_pm(collected[target].get(k, [])) for k in MODEL_ORDER]
        lines.append(f"{target} & " + " & ".join(vals) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines) + "\n"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Aggregate A/B/C/D/E results and emit Markdown/LaTeX tables"
    )
    ap.add_argument("--inputs", type=str, nargs="+", default=[
        "results/ab5_tournament",
        "results/cifar100_ab5_param_budgets",
        "results/imagenet_ab_param_budgets",
    ])
    ap.add_argument("--patterns", type=str, nargs="+", default=[
        "tournament_target_*.csv",
        "cifar100_ab5_target_*.csv",
        "imagenet_ab_target_*.csv",
    ])
    ap.add_argument("--out_dir", type=str, default="results/paper_benchmark")
    ap.add_argument("--md_name", type=str, default="ab5_benchmark.md")
    ap.add_argument("--tex_name", type=str, default="ab5_benchmark.tex")
    return ap


def main(argv=None):
    """Returns the collected {target: {model: [accuracies]}}."""
    args = build_argparser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    collected = collect_results(args.inputs, args.patterns)
    md_path = os.path.join(args.out_dir, args.md_name)
    tex_path = os.path.join(args.out_dir, args.tex_name)
    with open(md_path, "w") as f:
        f.write(to_markdown(collected))
    with open(tex_path, "w") as f:
        f.write(to_latex(collected))
    print(f"Wrote Markdown: {md_path}")
    print(f"Wrote LaTeX:   {tex_path}")
    return collected


if __name__ == "__main__":
    main()
