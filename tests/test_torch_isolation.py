"""The port stands alone: no file of ``mop_tpu_torch`` and not ``chip_smoke.py``
imports JAX, flax, optax, the JAX package or its experiment scripts
(checked on the source, since the test process has JAX loaded anyway)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "mop_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mop_tpu", "experiments"}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"mop_tpu_torch/__init__.py", "mop_tpu_torch/ops/fused.py",
            "mop_tpu_torch/models/quartet_attn_patch.py", "chip_smoke.py",
            "mop_tpu_torch/config.py", "mop_tpu_torch/data/cifar.py",
            "mop_tpu_torch/data/native_loader.py", "mop_tpu_torch/training/utils.py",
            "mop_tpu_torch/training/preemption.py", "mop_tpu_torch/experiments/common.py",
            "mop_tpu_torch/experiments/cifar100_ab5_param_budgets.py",
            "mop_tpu_torch/ops/mel.py", "mop_tpu_torch/data/audio.py",
            "mop_tpu_torch/models/whisper_mop.py", "mop_tpu_torch/models/whisper_comparison.py",
            "mop_tpu_torch/models/generate.py", "mop_tpu_torch/cli/whisper_demo.py",
            "mop_tpu_torch/ops/moe.py", "mop_tpu_torch/models/vit_localizer.py",
            "mop_tpu_torch/data/voc.py", "mop_tpu_torch/data/imagenet.py",
            "mop_tpu_torch/experiments/voc_localization_vit.py",
            "mop_tpu_torch/experiments/imagenet_ab_param_budgets.py",
            "mop_tpu_torch/data/tokenizer.py", "mop_tpu_torch/ops/quant.py",
            "mop_tpu_torch/models/beam.py", "mop_tpu_torch/models/speculative.py",
            "mop_tpu_torch/cli/generate_text.py", "mop_tpu_torch/serving/engine.py",
            "mop_tpu_torch/serving/http.py", "mop_tpu_torch/training/lora.py",
            "mop_tpu_torch/cli/serve_http.py", "mop_tpu_torch/parallel/mesh.py",
            "mop_tpu_torch/parallel/multihost.py", "mop_tpu_torch/parallel/fsdp.py",
            "mop_tpu_torch/parallel/tp.py", "mop_tpu_torch/parallel/multiseed.py",
            "mop_tpu_torch/parallel/comm.py", "mop_tpu_torch/parallel/paths.py",
            "mop_tpu_torch/ops/ring_attention.py", "mop_tpu_torch/utils/collectives.py",
            "mop_tpu_torch/cli/launch_multihost.py",
            "mop_tpu_torch/cli/multihost_train.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_source_is_in_the_package():
    from mop_tpu_torch.ops import _build

    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).is_file()
