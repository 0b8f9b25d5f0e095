"""The port's VOC localization and ImageNet A/B/E CLIs on the CPU: each
parser's flags and defaults equal the JAX script's (every option, its
default, type, choices and nargs; ``--device`` added); the ImageNet matcher
at the 50M target gives the JAX matcher's configs and counts; a tiny run of
each CLI writes the JAX script's files with their headers; the ImageNet
CLI's ``--ckpt_every`` then ``--resume`` restores the model, the optimizer
and the EMA, which goes on from where it was saved."""

import argparse
import importlib
import os

import numpy as np
import pytest
import torch

from mop_tpu_torch.experiments import imagenet_ab_param_budgets as inet
from mop_tpu_torch.experiments import voc_localization_vit as voc
from mop_tpu_torch.training import load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Parser(Exception):
    pass


def _jax_parser(monkeypatch, name):
    """The parser the JAX script builds in its ``main``, caught at its
    ``parse_args``."""
    mod = importlib.import_module(f"experiments.{name}")

    def catch(self, *a, **k):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parser) as e:
        mod.main()
    monkeypatch.undo()
    return e.value.args[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs,
                     type(a).__name__) for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name,port", [("voc_localization_vit", voc),
                                       ("imagenet_ab_param_budgets", inet)],
                         ids=["voc", "imagenet"])
def test_flags_and_defaults_equal_the_jax_script(monkeypatch, name, port):
    want = _options(_jax_parser(monkeypatch, name))
    got = _options(port.build_argparser())
    assert got.pop("device")[1] is None
    assert got == want


class _Matched(Exception):
    pass


def _jax_matcher(monkeypatch, argv):
    """A's, B's and E's (config, params) as the JAX script's ``main`` matches
    them for ``argv``: its calls of the two search functions recorded, and
    ``main`` stopped once E's search returns (before any model is built)."""
    mod = importlib.import_module("experiments.imagenet_ab_param_budgets")
    args = inet.build_argparser().parse_args(argv)
    del args.device
    found = {}
    real_target, real_match = mod.C.find_config_for_target, mod.C.find_model_config_match_baseline

    def target(cls, **kw):
        found["A"] = real_target(cls, **kw)
        return found["A"]

    def match(cls, **kw):
        key = {"ViT_MoP": "B", "ViTEdgewise": "E"}[cls.__name__]
        found[key] = real_match(cls, **kw)[:2]
        if key == "E":
            raise _Matched
        return found[key] + (True,)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", lambda self, *a, **k: args)
    monkeypatch.setattr(mod.C, "find_config_for_target", target)
    monkeypatch.setattr(mod.C, "find_model_config_match_baseline", match)
    monkeypatch.setattr(mod, "synthetic_imagenet", lambda n_tr, n_te, n_classes, size: (
        np.zeros((2, size, size, 3), np.uint8), np.zeros(2, np.int32),
        np.zeros((10, size, size, 3), np.uint8), np.zeros(10, np.int32)))
    with pytest.raises(_Matched):
        mod.main()
    monkeypatch.undo()
    return found


# A narrowed grid for the search against the JAX script's: the JAX counts cost
# a trace each (the full grids at 224 px and 50M took 400 s on the CPU), so the
# test searches at 32 px over small dims, depths and heads, where A's grid
# search and B's and E's windowed searches still choose among several.
INET_GRID = dict(IMAGENET_DIMS=(96, 128, 160, 192), IMAGENET_DEPTHS=(2, 3),
                 IMAGENET_HEADS=(2, 4))


def test_imagenet_matcher_at_50m_gives_the_jax_configs(monkeypatch):
    """The port's matcher and the JAX script's own, run on the same flags and
    grids: the same A, B and E configs and parameter counts. The grids are
    narrowed (above); at the CLI's grids and the 50M target both give A
    640/10/4, B 632/10/4 and E 504/8/4, which ``chip_smoke.py`` holds the
    port's matcher to on the card (``IMAGENET_MATCH``)."""
    mod = importlib.import_module("experiments.imagenet_ab_param_budgets")
    for name, grid in INET_GRID.items():
        monkeypatch.setattr(mod, name, grid)
        monkeypatch.setattr(inet, name, grid)
    argv = ["--synthetic", "--tiny", "--targets", "700000", "--img_size", "32", "--patch", "8",
            "--models", "A", "B", "E"]
    want = {k: ((c["dim"], c["depth"], c["heads"]), p)
            for k, (c, p) in _jax_matcher(monkeypatch, argv).items()}
    for name, grid in INET_GRID.items():
        monkeypatch.setattr(inet, name, grid)
    args = inet.build_argparser().parse_args(argv)
    cfgs = inet.match_configs(args, 700_000, 100)
    got = {k: ((c["dim"], c["depth"], c["heads"]), p) for k, (c, p) in cfgs.items()}
    assert got == want
    assert len({c for c, _ in got.values()}) == 3
    args = inet.build_argparser().parse_args(["--models", "A", "B", "E"])
    assert inet.model_keys_for(args) == ["A", "B", "E"]
    args = inet.build_argparser().parse_args(["--models", "E", "--ew_variants", "dense:and",
                                              "lowrank:neutral"])
    assert inet.model_keys_for(args) == ["A", "E_dense_and", "E_lowrank_neutral"]
    model = inet.make_model(args, {"E": ({"dim": 64, "depth": 1, "heads": 4}, 0)},
                            "E_lowrank_neutral", 100, "meta", None)
    attn = model.blocks[0].attn
    assert attn.gate_mode == "lowrank" and model.pos.shape[1] == 196


def test_voc_cli_writes_the_jax_file(tmp_path, capsys):
    res = voc.main(["--device", "cpu", "--synthetic", "--tiny", "--epochs", "2", "--dim", "32",
                    "--depth", "1", "--heads", "2", "--img_size", "48", "--batch", "32",
                    "--model", "E", "--ew_views", "2", "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == ["voc_E_results.csv"]
    lines = open(res["csv"]).read().splitlines()
    assert lines == ["model,val_iou,val_l1", f"E,{res['iou']:.4f},{res['l1']:.4f}"]
    assert len(res["losses"]) == 2 * 256 // 32 and all(np.isfinite(res["losses"]))
    assert [e for e, _, _ in res["evals"]] == [1, 2] and 0.0 <= res["iou"] <= 1.0
    assert "Synthetic rectangles: 256 train / 64 val" in capsys.readouterr().out


INET_FLAGS = ["--device", "cpu", "--synthetic", "--tiny", "--targets", "200000", "--batch", "8",
              "--img_size", "48", "--seeds", "0", "--ema", "--ema_decay", "0.5",
              "--eval_every", "2", "--models", "A", "B"]


@pytest.fixture
def small_imagenet(monkeypatch):
    """64 / 40 synthetic images in place of the tiny set's 512 / 256."""
    real = inet.synthetic_imagenet
    monkeypatch.setattr(inet, "synthetic_imagenet",
                        lambda n_tr, n_te, n_classes, img_size: real(64, 40, n_classes, img_size))


def test_imagenet_cli_writes_the_jax_files_and_resumes_its_ema(tmp_path, small_imagenet):
    out = str(tmp_path)
    res = inet.main(INET_FLAGS + ["--steps", "2", "--ckpt_every", "2", "--out", out])[200_000]
    prefix = os.path.join(out, "imagenet_ab_target_200000")
    lines = {s: open(prefix + s).read().splitlines()
             for s in (".csv", "_val_summary.csv", "_test.csv")}
    assert lines[".csv"][0] == "seed,acc_A,acc_B" and lines[".csv"][1].startswith("0,")
    assert lines["_val_summary.csv"][0] == "model,mean_val,std_val"
    assert lines["_test.csv"][0] == "model,test_acc"
    assert [r.split(",")[0] for r in lines["_test.csv"][1:]] == ["A", "B"]
    assert sorted(os.listdir(out)) == sorted(
        ["ckpt_s0_A_step2.pkl", "ckpt_s0_B_step2.pkl"] + [
            os.path.basename(prefix + s) for s in lines])
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in res["losses"].values())
    run_a = res["runs"]["A"]
    # The EMA at decay 0.5 lags the params.
    ema = dict(run_a.ema.named_parameters())
    assert any(not torch.equal(p, ema[k]) for k, p in run_a.model.named_parameters())
    payload = load_checkpoint(os.path.join(out, "ckpt_s0_A_step2.pkl"))
    assert payload["step"] == 2
    for k, v in run_a.ema.state_dict().items():
        assert torch.equal(payload["extra"][k], v)

    resumed = inet.main(INET_FLAGS + ["--steps", "3", "--resume", "--out", out])[200_000]
    r = resumed["runs"]["A"]
    assert r.count == 3 and len(resumed["losses"]["A"]) == 1  # only step 3 ran
    before = {k: v.clone() for k, v in payload["extra"].items()}
    # Step 3 updated the restored EMA once: e3 = 0.5 e2 + 0.5 p3.
    for k, p in r.model.named_parameters():
        torch.testing.assert_close(dict(r.ema.named_parameters())[k],
                                   0.5 * before[k] + 0.5 * p.detach())
