"""Shared set-up of the tests of the port's eleven later experiment CLIs
(``test_torch_experiments_more_*.py``): each JAX script's parser, captured
as its ``main`` parses, and a run of the JAX script with its training,
data and matcher stubbed out, which writes the script's files and headers
without computing anything."""

import argparse
import importlib
import inspect
import os
import sys

import numpy as np
import pytest

# The port's CLI -> the JAX script of the same name (every one has one).
CLIS = ["cifar10_ab_param_budgets", "cifar10_ab3_param_budgets", "cifar100_ab3_param_budgets",
        "cifar100_ab4_param_budgets", "cifar10_twohop_param_budgets",
        "cifar100_twohop_param_budgets", "cifar10_multi_seed", "cifar100_multi_seed",
        "cifar10_mop_sweep", "ab5_tournament", "ab5_paper_benchmark"]


class _Parsed(Exception):
    pass


def jax_parser(monkeypatch, name):
    """The ``ArgumentParser`` the JAX script builds in its ``main``."""
    mod = importlib.import_module(f"experiments.{name}")
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        m.setattr(sys, "argv", [f"{name}.py"])
        with pytest.raises(_Parsed):
            mod.main()
    return seen["parser"]


def flags(parser):
    """{option string: (dest, default, type, nargs, choices, const, action)}."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.option_strings[0]] = (a.dest, a.default, a.type, a.nargs, a.choices, a.const,
                                    type(a).__name__)
    return out


class _StubRun:
    """The JAX harness's ``ModelRun`` without a model run: records the
    model it is given."""

    built = []

    def __init__(self, key, model, *a, **kw):
        _StubRun.built.append((key, model))
        self.n_params = 1000

    def evaluate(self, batches):
        return 0.5

    def per_sample_correct(self, batches):
        return np.array([1, 0, 1, 1], bool)


STUB_CFG = {"dim": 64, "depth": 2, "heads": 4}


def _recorder(real, calls, result):
    """A stand-in for the matcher ``real`` that appends (its name, every
    argument by name with the defaults filled in and the model class by
    name) to ``calls`` and returns ``result(those arguments)``."""
    sig = inspect.signature(real)

    def matcher(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        got = dict(bound.arguments, ctor=bound.arguments["ctor"].__name__)
        calls.append((real.__name__, got))
        return result(got)

    return matcher


def stub_harness(m, common, calls):
    """``common``'s training, data and matcher stubbed on ``m``: the
    matchers record their calls into ``calls`` and answer ``STUB_CFG`` with
    a parameter count that tells the targets apart (target - 1 for A's grid
    search, target - 2 under A's budget)."""
    m.setattr(common, "ModelRun", _StubRun)
    m.setattr(common, "lockstep_train", lambda *a, **k: {})
    m.setattr(common, "get_loaders", lambda ds, *a, **k: (
        lambda s: None, lambda: [], lambda: [], None, None, 10))
    m.setattr(common, "find_config_for_target", _recorder(
        common.find_config_for_target, calls,
        lambda got: (dict(STUB_CFG), int(got["target_params"]) - 1)))
    m.setattr(common, "find_model_config_match_baseline", _recorder(
        common.find_model_config_match_baseline, calls,
        lambda got: (dict(STUB_CFG), int(got["target_params"]) - 2, True)))


def jax_stub_run(monkeypatch, name, argv, out, calls=None):
    """Run the JAX script with stubbed training, data and matcher into
    ``out`` (the matcher's calls recorded into ``calls``); returns the
    models it built, [(key, model)]."""
    import experiments.common as JC

    mod = importlib.import_module(f"experiments.{name}")
    _StubRun.built = []
    with monkeypatch.context() as m:
        stub_harness(m, JC, [] if calls is None else calls)
        m.setattr(sys, "argv", [f"{name}.py", *argv, "--out", str(out)])
        mod.main()
    return list(_StubRun.built)


def port_stub_run(monkeypatch, name, argv, out, calls):
    """The port's CLI on the CPU with the same stubs as ``jax_stub_run``,
    the matcher's calls recorded into ``calls``."""
    from mop_tpu_torch.experiments import common as TC

    mod = importlib.import_module(f"mop_tpu_torch.experiments.{name}")
    _StubRun.built = []
    with monkeypatch.context() as m:
        stub_harness(m, TC, calls)
        mod.main([*argv, "--device", "cpu", "--out", str(out)])


def files_and_headers(out):
    """{file name: its first line} of the files under ``out``."""
    got = {}
    for f in sorted(os.listdir(out)):
        with open(os.path.join(out, f)) as fh:
            got[f] = fh.readline().strip() if f.endswith(".csv") else None
    return got


# Each training CLI's flags for a run on the CPU over the small set: one
# seed, 2 steps at batch 16, the budget CLIs at a 200,000-parameter target
# (A at the grid's smallest, 128 / 6 / 4), the sweep at one pair.
RUN_FLAGS = ["--synthetic", "--tiny", "--steps", "2", "--eval_every", "1", "--batch", "16",
             "--seeds", "0"]
RUN_EXTRA = {
    "cifar10_ab_param_budgets": ["--targets", "200000"],
    "cifar10_ab3_param_budgets": ["--targets", "200000"],
    "cifar100_ab3_param_budgets": ["--targets", "200000"],
    "cifar100_ab4_param_budgets": ["--targets", "200000"],
    "cifar10_twohop_param_budgets": ["--targets", "200000"],
    "cifar100_twohop_param_budgets": ["--targets", "200000"],
    "cifar10_multi_seed": [],
    "cifar100_multi_seed": [],
    "cifar10_mop_sweep": ["--views", "3", "--kernels", "2"],
    "ab5_tournament": ["--targets", "200000", "--models", "A", "B"],
}


@pytest.fixture
def small_data(monkeypatch):
    """A 320 / 48 image synthetic set in place of the 10,000 / 2,000 one."""
    from mop_tpu_torch.data import synthetic_cifar
    from mop_tpu_torch.experiments import common as TC

    monkeypatch.setattr(TC, "load_cifar",
                        lambda name, **kw: synthetic_cifar(name, 320, 48, seed=0))


def check_cpu_run(monkeypatch, tmp_path, name):
    """The port's CLI run on the CPU writes the files the JAX script writes
    (names and CSV headers; the JAX run stubbed), one row per seed, with
    accuracies in [0, 1]."""
    argv = RUN_FLAGS + RUN_EXTRA[name]
    jax_stub_run(monkeypatch, name, argv, tmp_path / "jax")
    mod = importlib.import_module(f"mop_tpu_torch.experiments.{name}")
    mod.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    got, want = files_and_headers(tmp_path / "port"), files_and_headers(tmp_path / "jax")
    assert got == want
    for f in got:
        if not f.endswith(".csv"):
            continue
        with open(tmp_path / "port" / f) as fh:
            lines = fh.read().splitlines()
        header = lines[0].split(",")
        for row in lines[1:]:
            cells = dict(zip(header, row.split(",")))
            for k, v in cells.items():
                if k in ("acc", "baseline", "mop", "baseline_acc", "mop_acc", "test_acc",
                         "mean_val") or k.startswith("acc_"):
                    assert 0.0 <= float(v) <= 1.0, (f, k, v)
    return got
