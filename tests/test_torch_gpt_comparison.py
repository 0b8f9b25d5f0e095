"""The GPT comparison framework of the port against ``mop_tpu``'s: its
counts, component breakdown, matching analysis and model info at a small
config and at the reference comparison config, its forward pass and summary,
and its GPU default. (Split from ``test_torch_gpt_mop.py``, so that neither
file is the long pole of a parallel run.)"""

import numpy as np
import pytest
import torch

import mop_tpu_torch.models as PM
from mop_tpu.models.gpt_comparison import ComparisonConfig as JaxComparisonConfig
from mop_tpu.models.gpt_comparison import GPTComparisonFramework as JaxFramework


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 50


def _configs(small):
    if small:
        kw = dict(n_layer=2, n_head=2, n_embd=32, block_size=16, n_views=3, n_kernels=2)
        return JaxComparisonConfig(**kw), PM.ComparisonConfig(**kw), VOCAB
    return JaxComparisonConfig(), PM.ComparisonConfig(), 8192


@pytest.mark.parametrize("small", [True, False], ids=["small", "comparison"])
def test_comparison_framework_counts_match_jax(small):
    """param_counts, the component breakdown (the reference's substring
    rules: the gate convs count under no component), the matching analysis
    and the model info equal the JAX framework's."""
    jcfg, pcfg, vocab = _configs(small)
    jf = JaxFramework(jcfg)
    jf.build_models(vocab)
    pf = PM.create_comparison_framework(pcfg, device="cpu")
    models = pf.build_models(vocab)
    assert all(p.is_meta for m in models.values() for p in m.parameters())
    assert pf.param_counts == jf.param_counts
    summary, want = pf.get_param_summary(), jf.get_param_summary()
    for name in want:
        assert summary[name] == want[name], name
    assert pf.parameter_matching_analysis() == jf.parameter_matching_analysis()
    assert pf.get_model_info() == jf.get_model_info()
    if not small:
        assert pf.param_counts == {"baseline": 44750080, "quartet": 51303696, "mop": 44776184}
        assert summary["mop"]["components"] == {
            "embeddings": 5406720, "attention": 13107200, "mlp": 26214400,
            "layer_norm": 21760, "lm_head": 0, "mop_components": 25600}


def test_comparison_framework_forward_pass_and_summary(capsys):
    jcfg, pcfg, vocab = _configs(small=True)
    pf = PM.create_comparison_framework(pcfg, device="cpu")
    pf.build_models(vocab)
    params = pf.init_params(seed=3)
    assert set(params) == {"baseline", "quartet", "mop"}
    assert all(p.device.type == "cpu" for ps in params.values() for p in ps.values())
    res = pf.test_forward_pass(batch_size=2, seq_len=8, vocab_size=vocab)
    jf = JaxFramework(jcfg)
    jf.build_models(vocab)
    want = jf.test_forward_pass(batch_size=2, seq_len=8, vocab_size=vocab)
    for name, w in want.items():
        assert "error" not in res[name], res[name]
        assert res[name]["logits_shape"] == w["logits_shape"] == (2, 8, vocab)
        assert np.isfinite(res[name]["loss_value"])
        assert res[name].get("mop_maps") == w.get("mop_maps")
    assert res["mop"]["mop_maps"]["views_shape"] == (2, 2, 3, 8)
    # A token beyond the vocabulary is reported for each model, not raised.
    bad = pf.test_forward_pass(batch_size=1, seq_len=4, vocab_size=10 * vocab)
    assert all("error" in r for r in bad.values())
    pf.print_comparison_summary()
    out = capsys.readouterr().out
    assert "PARAMETER MATCHING" in out and "quartet" in out


def test_comparison_framework_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.GPTComparisonFramework(PM.ComparisonConfig())
