"""The port's text-generation demo, ``python -m mop_tpu_torch.cli.generate_text``,
on the CPU at tiny flags: the corpus and prompt of ``examples/generate_text.py``,
the loss printed at its steps and falling, both samplers' text continuing
the prompt, the flags and defaults of the JAX example, and no run without a
GPU unless ``--device cpu`` is given."""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from mop_tpu_torch.cli import generate_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "examples", "generate_text.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example_flags():
    """The JAX example's ``--flag``: default pairs, read from its source."""
    flags = {}
    for node in ast.walk(ast.parse(open(EXAMPLE).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = ast.literal_eval(kw["default"])
    return flags


def test_corpus_prompt_and_flags_are_the_examples():
    spec = importlib.util.spec_from_file_location("jax_generate_text", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert generate_text.CORPUS == example.CORPUS
    assert 'prompt_txt = "the quick brown "' in open(EXAMPLE).read()
    assert generate_text.PROMPT == "the quick brown "
    ours = {a.option_strings[0]: a.default for a in generate_text._parser()._actions}
    assert {k: ours[k] for k in _example_flags()} == _example_flags()
    assert ours["--device"] is None


def test_cli_trains_and_both_samplers_continue_the_prompt(capsys):
    out = generate_text.main(["--device", "cpu", "--steps", "101", "--tokens", "8",
                              "--batch", "8", "--seq", "32"])
    printed = capsys.readouterr().out
    assert sorted(out["losses"]) == [0, 100] and out["losses"][100] < out["losses"][0]
    assert "step 0: loss" in printed and "step 100: loss" in printed
    for name in ("full", "cached"):
        assert out[name].startswith("the quick brown ") and len(out[name]) == 16 + 8
        assert f"{out[name]!r}" in printed
        assert set(out[name]) <= set(generate_text.CORPUS)


def test_cli_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI runs there")
    proc = subprocess.run([sys.executable, "-m", "mop_tpu_torch.cli.generate_text", "--steps",
                           "1", "--tokens", "2"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "mop_tpu_torch.cli.generate_text", "--device",
                           "cpu", "--steps", "2", "--tokens", "4", "--batch", "2", "--seq", "8"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "full-window" in proc.stdout and "kv-cached" in proc.stdout
