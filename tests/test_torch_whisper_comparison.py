"""Parameter counts of the port's Whisper against JAX's ``eval_shape``
counts (the port's built on the ``meta`` device) at the golden's,
``tools/bench_lm.py``'s 20M, the reference's and the comparison framework's
widths; and the comparison framework (``WhisperComparisonFramework``)
against the JAX one: counts, matching analysis, forward and gate-map smoke
tests, summary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mop_tpu.models as J
import mop_tpu_torch.models as PM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The golden's config (tests/test_golden_numerics.py), tools/bench_lm.py's
# WHISPER (the README's 20M row) and the reference width (WhisperConfig's
# defaults), with mop_tpu's eval_shape counts (chip_smoke.py phase 11 holds
# the port's to the same numbers).
GOLDEN_CFG = dict(n_layer_enc=2, n_layer_dec=2, n_head=2, n_embd=32, n_mels=16, n_audio_ctx=32,
                  n_text_ctx=32, dropout=0.0, bias=False, n_views=2, n_kernels=1,
                  kernel_size=3, vocab_size=50)
BENCH_CFG = dict(n_mels=80, n_audio_ctx=750, vocab_size=8192, n_text_ctx=112, n_embd=384,
                 n_head=6, n_layer_enc=4, n_layer_dec=4, dropout=0.0)
COUNTS = {"golden": 62328, "bench_20m": 20041016, "reference": 407639720}
COMPARISON_COUNT = 620995496
CONFIGS = {"golden": GOLDEN_CFG, "bench_20m": BENCH_CFG, "reference": {}}
FACTORIES = {"mop": (J.create_whisper_mop, PM.create_whisper_mop),
             "baseline": (J.create_whisper_baseline, PM.create_whisper_baseline)}


# ------------------------------ parameter counts ------------------------------


def _jax_count(factory, cfg):
    tree = jax.eval_shape(lambda: factory(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, cfg.n_mels)), jnp.zeros((1, 8), jnp.int32)))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("width", sorted(CONFIGS))
def test_parameter_counts_equal_jax(width):
    for kind, (jfac, pfac) in FACTORIES.items():
        jax_n = _jax_count(jfac, J.WhisperConfig(**CONFIGS[width]))
        with torch.device("meta"):
            pm = pfac(PM.WhisperConfig(**CONFIGS[width]), device="meta")
        assert sum(p.numel() for p in pm.parameters()) == jax_n == COUNTS[width], kind


# ------------------------------ comparison framework ------------------------------


def test_comparison_framework_counts_equal_jax():
    jfw = J.create_whisper_comparison_framework(J.WhisperComparisonConfig())
    jfw.build_models()
    pfw = PM.create_whisper_comparison_framework(PM.WhisperComparisonConfig(), device="cpu")
    pfw.build_models()
    assert pfw.param_counts == jfw.param_counts == {"baseline": COMPARISON_COUNT,
                                                    "mop": COMPARISON_COUNT}
    assert pfw.parameter_matching_analysis() == jfw.parameter_matching_analysis()
    assert all(p.is_meta for m in pfw.models.values() for p in m.parameters())


def test_comparison_framework_smoke_tests_match_jax(capsys):
    small = dict(n_mels=16, n_audio_ctx=24, n_layer=1, n_head=2, n_embd=32, n_views=2,
                 n_kernels=1, kernel_size=3, vocab_size=40)
    jfw = J.create_whisper_comparison_framework(J.WhisperComparisonConfig(**small))
    jfw.build_models()
    pfw = PM.create_whisper_comparison_framework(PM.WhisperComparisonConfig(**small),
                                                 device="cpu")
    pfw.build_models()
    assert pfw.param_counts == jfw.param_counts
    params = pfw.init_params(seed=3)
    assert set(params) == {"baseline", "mop"}
    assert all(not p.is_meta for ps in params.values() for p in ps.values())
    assert not pfw.models["baseline"].encoder[0].mop.fuse.alpha.detach().any()
    assert pfw.models["mop"].encoder[0].mop.fuse.alpha.detach().eq(1.0).all()
    got, want = pfw.test_forward_pass(), jfw.test_forward_pass()
    for name in ("baseline", "mop"):
        assert "error" not in got[name], got[name]
        assert got[name]["logits_shape"] == want[name]["logits_shape"]
        assert got[name]["gates_shape"] == want[name]["gates_shape"]
        assert np.isfinite(got[name]["loss_value"])
    assert pfw.test_audio_processing() == jfw.test_audio_processing()
    pfw.print_comparison_summary()
    out = capsys.readouterr().out
    assert "WHISPER MODEL COMPARISON" in out and "MATCHED" in out
