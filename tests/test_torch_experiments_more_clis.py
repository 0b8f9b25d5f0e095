"""The port's eleven later experiment CLIs against the JAX scripts, on the CPU.

- Each CLI's parser has the JAX script's flags with their defaults, types,
  nargs and choices, plus ``--device`` (not ``ab5_paper_benchmark``, which
  computes nothing on a device), and parses a command line to the same
  values.
- The fixed-width CLIs (``cifar{10,100}_multi_seed``, ``cifar10_mop_sweep``)
  build the JAX script's models, in its order, with its widths.
- ``ab5_tournament --plan_only`` writes the JAX script's plan file and
  builds no model; ``ab5_paper_benchmark`` writes the JAX script's Markdown
  and LaTeX, byte for byte, from the same CSVs.
- Every new entry point that trains raises without a GPU when no device is
  given (the counterpart of ``test_torch_experiments_cli.py``'s test of
  the same name for the earlier CLIs).

The runs on the CPU are in ``test_torch_experiments_more_runs*.py``; the
matched configs at the default targets in ``test_torch_experiments_more_plans*.py``.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from _torch_more_clis_common import CLIS, flags, jax_parser, jax_stub_run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name):
    return importlib.import_module(f"mop_tpu_torch.experiments.{name}")


# A command line of flags each CLI has (beyond the defaults).
ARGV = {
    "cifar10_ab_param_budgets": ["--seeds", "3", "4", "--targets", "123", "--mop_views", "2"],
    "cifar10_ab3_param_budgets": ["--xview_transpose", "--xview_anchor_mode", "fixed",
                                  "--lr_large", "1e-4"],
    "cifar100_ab3_param_budgets": ["--xview_t1", "0.5", "--warmup_frac", "0.0"],
    "cifar100_ab4_param_budgets": ["--mh_hops", "4", "--mh_gate_or", "0.5", "--xview_k_star",
                                   "2"],
    "cifar10_twohop_param_budgets": ["--gate_chain", "1.0", "--beta_not", "0.25"],
    "cifar100_twohop_param_budgets": ["--gate_not", "0.5", "--tiny"],
    "cifar10_multi_seed": ["--seeds", "7", "--synthetic", "--steps", "3"],
    "cifar100_multi_seed": ["--eval_every", "9", "--lr", "1e-3"],
    "cifar10_mop_sweep": ["--views", "2", "--kernels", "1", "2"],
    "ab5_tournament": ["--plan_only", "--models", "A", "D", "--targets", "2000000000"],
    "ab5_paper_benchmark": ["--inputs", "a", "b", "--md_name", "x.md"],
}


@pytest.mark.parametrize("name", CLIS)
def test_parser_equals_jax(monkeypatch, name):
    want = flags(jax_parser(monkeypatch, name))
    port = _port(name).build_argparser()
    got = flags(port)
    if name == "ab5_paper_benchmark":
        assert "--device" not in got
    else:
        assert got.pop("--device")[:2] == ("device", None)
    assert got == want
    jargs = jax_parser(monkeypatch, name).parse_args(ARGV[name])
    targs = vars(port.parse_args(ARGV[name]))
    targs.pop("device", None)
    assert targs == vars(jargs)


FIXED = {  # name -> (argv, keys per seed)
    "cifar10_multi_seed": (["--seeds", "0", "1"], ["b", "m"]),
    "cifar100_multi_seed": (["--seeds", "2"], ["b", "m"]),
    "cifar10_mop_sweep": (["--seeds", "0", "--views", "3", "5", "--kernels", "2"], ["m", "m"]),
}


@pytest.mark.parametrize("name", FIXED)
def test_fixed_width_clis_build_the_jax_models(monkeypatch, tmp_path, name):
    argv, keys = FIXED[name]
    built = jax_stub_run(monkeypatch, name, argv, tmp_path / "jax")
    mod = _port(name)
    impl = sys.modules[getattr(mod, "run", mod.main).__module__]  # cifar100_* reuse cifar10_*
    seen = []
    for cls_name in ("ViT_Baseline", "ViT_MoP"):
        if hasattr(impl, cls_name):
            cls = getattr(impl, cls_name)
            monkeypatch.setattr(impl, cls_name, lambda _c=cls, **kw: (seen.append(
                (_c.__name__, kw)), _c(**kw))[1])
    monkeypatch.setattr(impl.C, "lockstep_train", lambda *a, **k: {})
    monkeypatch.setattr(impl.C.ModelRun, "evaluate", lambda self, b: 0.5)
    monkeypatch.setattr(impl.C.ModelRun, "per_sample_correct",
                        lambda self, b: np.array([1, 0, 1], bool))
    monkeypatch.setattr(impl.C, "get_loaders", lambda *a, **k: (
        lambda s: None, lambda: [], lambda: [], None, None, 10))
    mod.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert [k for k, _ in built] == keys * (len(built) // len(keys)) and len(seen) == len(built)
    for (cls_name, kw), (_, jm) in zip(seen, built):
        assert cls_name == type(jm).__name__
        for f in ("dim", "depth", "heads", "n_classes", "n_views", "n_kernels"):
            if hasattr(jm, f):
                assert kw[f] == getattr(jm, f), (f, kw[f], getattr(jm, f))


def test_tournament_plan_only_writes_the_jax_plan(monkeypatch, tmp_path):
    argv = ["--plan_only", "--targets", "5000000", "2000000000", "--models", "A", "C", "E"]
    built = jax_stub_run(monkeypatch, "ab5_tournament", argv, tmp_path / "jax")
    assert built == []
    mod = _port("ab5_tournament")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no device needed
    assert mod.main(argv + ["--out", str(tmp_path / "port")]) is None
    for t in (5_000_000, 2_000_000_000):
        f = f"tournament_plan_{t}.txt"
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    from experiments.ab5_tournament import heuristic_plan_1b
    for t in (1, 999_999_999, 1_000_000_000):
        assert mod.heuristic_plan_1b(t) == heuristic_plan_1b(t)


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")


def test_paper_benchmark_writes_the_jax_tables(monkeypatch, tmp_path):
    rng = np.random.default_rng(0)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    acc = lambda: f"{rng.uniform(0.2, 0.6):.4f}"  # noqa: E731
    _write_csv(a / "tournament_target_5000000.csv", ["seed"] + [f"acc_{k}" for k in "ABCDE"],
               [[s] + [acc() for _ in range(5)] for s in range(5)])
    _write_csv(b / "cifar100_ab5_target_5000000.csv", ["seed", "acc_A", "acc_B", "acc_E"],
               [[0, acc(), "-", acc()], [1, acc(), acc(), acc()]])
    _write_csv(b / "cifar100_ab5_target_50000000.csv", ["seed", "acc_A", "acc_D"],
               [[0, acc(), acc()]])
    _write_csv(b / "cifar100_ab5_target_50000000_test.csv", ["model", "test_acc"],
               [["A", acc()], ["D", acc()]])
    _write_csv(b / "imagenet_ab_target_300000000.csv", ["seed", "acc_A", "acc_B", "acc_E"],
               [[0, acc(), acc(), acc()]])
    argv = ["--inputs", str(a), str(b), "--out_dir"]
    jmod = importlib.import_module("experiments.ab5_paper_benchmark")
    monkeypatch.setattr(sys, "argv", ["ab5_paper_benchmark.py", *argv, str(tmp_path / "jax")])
    jmod.main()
    got = _port("ab5_paper_benchmark").main(argv + [str(tmp_path / "port")])
    for f in ("ab5_benchmark.md", "ab5_benchmark.tex"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    np.testing.assert_equal(got, jmod.collect_results(  # NaN for the "-" cell on both sides
        [str(a), str(b)], ["tournament_target_*.csv", "cifar100_ab5_target_*.csv",
                           "imagenet_ab_target_*.csv"]))
    md = (tmp_path / "port" / "ab5_benchmark.md").read_text().splitlines()
    assert md[0] == "| Target | A | B | C | D | E |"
    assert [r.split(" | ")[0] for r in md[2:]] == ["| 5000000", "| 50000000", "| 300000000",
                                                   "| 50000000_test"]


TRAINING = [n for n in CLIS if n != "ab5_paper_benchmark"]


@pytest.mark.parametrize("name", TRAINING)
def test_entry_points_raise_without_a_gpu_or_device(tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main(["--synthetic", "--out", str(tmp_path)])
