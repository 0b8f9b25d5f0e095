"""The port's experiment CLIs on the CPU.

- ``cifar100_ab5_param_budgets.run`` end to end (``--device cpu --synthetic
  --tiny --steps 3 --eval_every 2 --batch 16`` at a small target, every
  model): the four files of the JAX harness's output contract, with its
  names and headers; ``--ckpt_every`` then ``--resume`` continuing from the
  saved step. The data set is cut to a few hundred images (the CPU's eval
  passes dominate otherwise); ``test_torch_experiments_data.py`` holds the
  loaders at their real sizes.
- Without ``--device`` and with no GPU the CLIs raise instead of running on
  the CPU.
- Each of the eight single-model CLIs parses the JAX script's flags to the
  same values (defaults too) and builds the same model class with the same
  configuration and parameter count; one of them runs end to end.
"""

import dataclasses
import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from mop_tpu_torch.data import synthetic_cifar
from mop_tpu_torch.experiments import cifar100_ab5_param_budgets as ab5
from mop_tpu_torch.experiments import common as TC
from mop_tpu_torch.training import load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_data(monkeypatch):
    """A 320 / 48 image synthetic set in place of the 10,000 / 2,000 one."""
    monkeypatch.setattr(TC, "load_cifar",
                        lambda name, **kw: synthetic_cifar(name, 320, 48, seed=0))


AB5_FLAGS = ["--device", "cpu", "--synthetic", "--tiny", "--steps", "3", "--eval_every", "2",
             "--batch", "16", "--targets", "200000", "--seeds", "0"]


def test_ab5_writes_the_jax_output_contract(tmp_path, small_data, capsys):
    args = ab5.build_argparser().parse_args(AB5_FLAGS + ["--out", str(tmp_path)])
    res = ab5.run(args)[200_000]
    keys = ["A", "B", "C", "D", "E"]
    assert list(res["params"]) == keys
    prefix = tmp_path / "cifar100_ab5_target_200000"
    lines = {s: open(f"{prefix}{s}").read().splitlines()
             for s in (".csv", "_test.csv", "_val_summary.csv")}
    assert lines[".csv"][0] == "seed,acc_A,acc_B,acc_C,acc_D,acc_E"
    assert lines[".csv"][1].startswith("0,") and len(lines[".csv"]) == 2
    assert lines["_test.csv"][0] == "model,test_acc"
    assert [r.split(",")[0] for r in lines["_test.csv"][1:]] == keys
    assert lines["_val_summary.csv"][0] == "model,mean_val,std_val"
    summary = json.loads(open(f"{prefix}_summary.json").read())
    assert summary["seed"] == 0 and summary["target"] == 200_000
    assert summary["params"] == res["params"]
    assert sorted(summary["vs_A"]) == ["B", "C", "D", "E"]
    assert set(summary["vs_A"]["E"]) == {"mcnemar_n01", "mcnemar_n10", "mcnemar_chi2",
                                         "delta_acc_mean", "delta_acc_lo", "delta_acc_hi"}
    assert not any(p.suffix == ".png" for p in tmp_path.iterdir())  # only with --plot
    out = capsys.readouterr().out
    assert "step    1 | LA=" in out and "step    2 | LA=" in out and "step    3" not in out
    for k in keys:
        assert res["hist"][k]["steps"] == [1, 2]


def test_ab5_ew_variants_and_lr_rules(tmp_path, small_data, monkeypatch):
    """``--ew_variants`` spawns one ``E_{mode}_{init}`` run per item; E's LR
    is ``--lr_e`` when set, else the base LR times ``--lr_mult_e``; ``--plot``
    writes the two PNGs."""
    seen = {}
    init = TC.ModelRun.__init__

    def spy(self, key, model, lr, *a, **kw):
        mode = model.blocks[0].attn.gate_mode if key.startswith("E") else None
        seen[key] = (lr, type(model).__name__, mode)
        init(self, key, model, lr, *a, **kw)

    monkeypatch.setattr(TC.ModelRun, "__init__", spy)
    args = ab5.build_argparser().parse_args(
        AB5_FLAGS + ["--out", str(tmp_path), "--models", "A", "E", "--steps", "1",
                     "--ew_variants", "lowrank:neutral", "dense:and", "--lr_mult_e", "0.5",
                     "--plot"])
    ab5.run(args)
    for png in ("val_curve", "test_bar"):
        assert (tmp_path / f"cifar100_ab5_target_200000_{png}.png").stat().st_size > 0
    assert seen["A"][0] == 3e-3
    assert seen["E_lowrank_neutral"] == (1.5e-3, "ViTEdgewise", "lowrank")
    assert seen["E_dense_and"] == (1.5e-3, "ViTEdgewise", "dense")
    header = open(tmp_path / "cifar100_ab5_target_200000.csv").readline().strip()
    assert header == "seed,acc_A,acc_E_lowrank_neutral,acc_E_dense_and"
    with pytest.raises(SystemExit):
        ab5.model_keys_for(ab5.build_argparser().parse_args(["--ew_variants", "dense"]))
    args = ab5.build_argparser().parse_args(["--lr_e", "7e-4"])
    assert args.lr_e == 7e-4 and args.large_threshold == 50_000_000 and args.lr_large == 1e-3


def test_ab5_resume_continues_from_the_saved_step(tmp_path, small_data, capsys):
    flags = AB5_FLAGS + ["--out", str(tmp_path), "--models", "A", "B", "--ckpt_every", "2"]
    ab5.run(ab5.build_argparser().parse_args(flags + ["--steps", "2"]))  # saved at step 2
    ckpt = tmp_path / "ckpt_t200000_s0"
    assert load_checkpoint(str(ckpt / "A.ckpt"))["step"] == 2
    capsys.readouterr()
    ab5.run(ab5.build_argparser().parse_args(flags + ["--steps", "4", "--resume"]))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "step    1 |" not in out and "step    4 | LA=" in out
    for k in ("A", "B"):
        payload = load_checkpoint(str(ckpt / f"{k}.ckpt"))
        assert payload["step"] == 4
        assert all(int(s["step"]) == 4 for s in payload["opt_state"]["state"].values())


def test_entry_points_raise_without_a_gpu_or_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab5.run(ab5.build_argparser().parse_args(["--synthetic", "--out", str(tmp_path)]))
    from mop_tpu_torch.experiments import cifar100_multihop_gates
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cifar100_multihop_gates.main(["--synthetic", "--out", str(tmp_path)])


# The eight single-model CLIs: module name -> flags beyond the shared ones.
CLIS = {
    "cifar10_crossview_mixer": ["--use_transpose_cues", "--t1", "0.25", "--enable_prior",
                                "--anchor_mode", "fixed", "--k_star", "3"],
    "cifar100_crossview_mixer": ["--prior_weight", "0.3", "--anchor_mode", "none"],
    "cifar10_edgewise_gates": ["--ew_gate_mode", "lowrank", "--ew_gate_init", "xor",
                               "--beta_not", "0.25"],
    "cifar100_edgewise_gates": ["--use_lens_bank_qk", "--lens_qk_dilations", "1", "3",
                                "--use_lens_bank", "--lens_dilations", "2",
                                "--ew_gate_init", "chain"],
    "cifar10_multihop_gates": ["--hops", "2", "--gate_or", "0.5", "--gate_chain", "0.25"],
    "cifar100_multihop_gates": ["--hops", "4", "--gate_not", "0.5"],
    "cifar10_twohop_gates": ["--gate_base", "0.8", "--gate_and", "0.5"],
    "cifar100_twohop_gates": ["--gate_chain", "1.0", "--beta_not", "0.75"],
}
SHARED = ["--seeds", "3", "--steps", "7", "--dim", "64", "--depth", "2", "--heads", "4",
          "--drop_path", "0.2", "--lr", "1e-3"]


def _jax_cli(monkeypatch, name, flags):
    """(args, dataset, model, csv name) that the JAX script hands its runner."""
    import importlib

    mod = importlib.import_module(f"experiments.{name}")
    got = {}

    def capture(args, dataset, factory, csv_name, **_):
        got.update(args=args, dataset=dataset, model=factory(), csv=csv_name)

    monkeypatch.setattr(mod, "run_single_model_seeds", capture)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *flags])
    mod.main()
    return got


def _torch_cli(monkeypatch, name, flags, class_name):
    """(args, dataset, model kwargs, model, csv name) of the port's CLI."""
    import importlib

    mod = importlib.import_module(f"mop_tpu_torch.experiments.{name}")
    got = {}

    def capture(args, dataset, factory, csv_name, **_):
        fmod = sys.modules[factory.__module__]
        cls = getattr(fmod, class_name)
        kwargs = {}

        def record(**kw):
            kwargs.update(kw)
            return cls(**kw)

        monkeypatch.setattr(fmod, class_name, record)
        got.update(args=args, dataset=dataset, model=factory("meta", None), kwargs=kwargs,
                   csv=csv_name, cls=cls)

    monkeypatch.setattr(mod, "run_single_model_seeds", capture)
    mod.main(flags)
    return got


def _same(a, b):
    norm = lambda v: list(v) if isinstance(v, (tuple, list)) else v  # noqa: E731
    return norm(a) == norm(b)


@pytest.mark.parametrize("name", CLIS)
@pytest.mark.parametrize("given", [False, True], ids=["defaults", "flags"])
def test_single_model_cli_matches_jax(monkeypatch, name, given):
    flags = SHARED + CLIS[name] if given else []
    j = _jax_cli(monkeypatch, name, flags)
    class_name = type(j["model"]).__name__
    t = _torch_cli(monkeypatch, name, flags, class_name)
    targs = vars(t["args"])
    assert targs.pop("device") is None
    assert targs == vars(j["args"])
    assert (t["dataset"], t["csv"]) == (j["dataset"], j["csv"])
    assert type(t["model"]).__name__ == class_name
    # Every configuration field the two classes share: the value the JAX
    # model got, and the one the port's got (passed or by default).
    params = inspect.signature(t["cls"]).parameters
    shared = [f.name for f in dataclasses.fields(j["model"])
              if f.name in params and f.name not in ("device", "generator")]
    assert {"dim", "depth", "heads", "n_classes", "drop_path"} <= set(shared)
    for f in shared:
        want = getattr(j["model"], f)
        got = t["kwargs"].get(f, params[f].default)
        assert _same(got, want), (f, got, want)
    if given:  # at the small width: the same parameter count
        tree = jax.eval_shape(lambda x: j["model"].init(jax.random.PRNGKey(0), x),
                              jax.ShapeDtypeStruct((1, 3, 32, 32), jnp.float32))
        n_jax = sum(int(x.size) for x in jax.tree_util.tree_leaves(tree))
        assert sum(p.numel() for p in t["model"].parameters()) == n_jax


def test_single_model_cli_runs_on_the_cpu(tmp_path, small_data, capsys):
    from mop_tpu_torch.experiments import cifar10_twohop_gates

    accs = cifar10_twohop_gates.main(
        ["--device", "cpu", "--synthetic", "--tiny", "--seeds", "0", "1", "--steps", "2",
         "--eval_every", "1", "--batch", "16", "--dim", "32", "--depth", "1",
         "--out", str(tmp_path)])
    rows = open(tmp_path / "cifar10_twohop_gates.csv").read().splitlines()
    assert rows == ["seed,acc", f"0,{accs[0]:.4f}", f"1,{accs[1]:.4f}"]
    out = capsys.readouterr().out
    assert "Params: " in out and "step    2 | Lm=" in out


def test_run_module_entry_point(tmp_path):
    """``python -m mop_tpu_torch.experiments.<name>`` runs the CLI."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "mop_tpu_torch.experiments.cifar100_ab5_param_budgets",
                        "--help"], cwd=root, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "--device" in r.stdout and "--ew_variants" in r.stdout, r.stderr
