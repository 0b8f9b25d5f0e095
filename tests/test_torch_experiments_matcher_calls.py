"""How each budget CLI of the port turns its flags into the matcher's
inputs, against the JAX script's own. Both sides run with the same argv,
their training and data stubbed and both matchers
(``find_config_for_target``, ``find_model_config_match_baseline``)
replaced by recorders (``tests/_torch_more_clis_common.py``); the recorded
calls must be equal, in order: the model class, ``n_classes``, the target,
A's config and parameter count, ``max_ratio_diff``, the search grids and
``extra_kwargs``. Each CLI runs at its defaults and with non-default
``--mop_*``, ``--xview_*``, ``--mh_*``, ``--ew_*`` or ``--gate_*`` flags.
The searches themselves are held to JAX's in
``test_torch_experiments_search.py`` and ``test_torch_experiments_params.py``."""

import pytest
import torch

from _torch_more_clis_common import jax_stub_run, port_stub_run

MOP = ["--mop_views", "4", "--mop_kernels", "2"]
XVIEW = ["--xview_transpose", "--xview_t1", "0.25", "--xview_t2", "0.5", "--xview_enable_prior",
         "--xview_prior_weight", "0.3", "--xview_anchor_mode", "fixed", "--xview_k_star", "2"]
MH = ["--mh_hops", "2", "--mh_beta_not", "0.25", "--mh_gate_chain", "0.5"]
MH_GATES = ["--mh_gate_base", "0.5", "--mh_gate_and", "0.75", "--mh_gate_or", "0.125",
            "--mh_gate_not", "0.25"]
GATES = ["--gate_base", "0.5", "--gate_and", "0.25", "--gate_or", "0.75", "--gate_not", "0.125",
         "--gate_chain", "1.0", "--beta_not", "0.25"]
EW = ["--ew_views", "3", "--ew_gate_rank", "2", "--ew_beta_not", "0.25", "--ew_mlp_ratio", "2.0",
      "--ew_share_qkv"]
TARGETS = ["--targets", "300000", "60000000"]

CASES = {
    "cifar10_ab_param_budgets": MOP,
    "cifar10_ab3_param_budgets": MOP + XVIEW,
    "cifar100_ab3_param_budgets": MOP + XVIEW,
    "cifar100_ab4_param_budgets": MOP + XVIEW + MH + MH_GATES,
    "cifar10_twohop_param_budgets": GATES,
    "cifar100_twohop_param_budgets": GATES,
    "ab5_tournament": MOP + XVIEW + MH + EW,
}
# The classes each CLI matches (A's grid search first).
CLASSES = {
    "cifar10_ab_param_budgets": {"ViT_Baseline", "ViT_MoP"},
    "cifar10_ab3_param_budgets": {"ViT_Baseline", "ViT_MoP", "ViTCrossView"},
    "cifar100_ab3_param_budgets": {"ViT_Baseline", "ViT_MoP", "ViTCrossView"},
    "cifar100_ab4_param_budgets": {"ViT_Baseline", "ViT_MoP", "ViTCrossView", "ViTMultiHop"},
    "cifar10_twohop_param_budgets": {"ViTGated"},
    "cifar100_twohop_param_budgets": {"ViTGated"},
    "ab5_tournament": {"ViT_Baseline", "ViT_MoP", "ViTCrossView", "ViTMultiHop", "ViTEdgewise"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's stubbed runs still build small models,
    and the lane's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", ["defaults", "non_defaults"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matcher_calls_equal_the_jax_scripts(monkeypatch, tmp_path, name, flags):
    argv = ["--seeds", "0"] + ([] if flags == "defaults" else CASES[name] + TARGETS)
    want, got = [], []
    jax_stub_run(monkeypatch, name, argv, tmp_path / "jax", calls=want)
    port_stub_run(monkeypatch, name, argv, tmp_path / "port", got)
    assert {c["ctor"] for _, c in want} == CLASSES[name]
    assert got == want
