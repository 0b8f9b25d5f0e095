"""Parameter matching of the port's harness: ``estimate_params`` (a model built
on the ``meta`` device) against the JAX harness's ``eval_shape`` count for
every family, and the ab5 search at the 5M target against the configs and
counts the JAX harness's own functions give (``find_config_for_target``,
``find_model_config_match_baseline`` with the ab5 flag defaults,
``fit_edgewise``). The JAX search takes over a minute on a CPU, so the 5M
test holds the port to its recorded result; ``tests/test_param_parity.py``
keeps checking A and B there on the JAX side."""

import pytest
import torch

import experiments.common as JC
import mop_tpu.models as J
import mop_tpu_torch.models as P
from mop_tpu_torch.experiments import cifar100_ab5_param_budgets as ab5
from mop_tpu_torch.experiments import common as TC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GATES = dict(base=1.0, and_=1.0, or_=0.0, not_=0.0, chain=1.0)
XVIEW = dict(use_transpose_cues=False, t1=0.0, t2=0.0, enable_per_key_prior=False,
             prior_weight=0.5, anchor_mode="argmax_row_sum", fixed_k_star=0)
EW = dict(beta_not=0.5, n_views=5, share_qkv=False, mlp_ratio=4.0, gate_rank=4,
          gate_init="neutral")
# family -> (JAX class name, extra kwargs), the kwargs as the ab5 harness passes them.
FAMILIES = {
    "A": ("ViT_Baseline", {}),
    "B": ("ViT_MoP", {"n_views": 5, "n_kernels": 3}),
    "C": ("ViTCrossView", XVIEW),
    "C_transpose": ("ViTCrossView", {**XVIEW, "use_transpose_cues": True}),
    "D": ("ViTMultiHop", dict(gates=GATES, beta_not=0.5, hops=3)),
    "Gated": ("ViTGated", dict(gates=GATES, beta_not=0.5)),
    "E_lowrank": ("ViTEdgewise", {**EW, "gate_mode": "lowrank"}),
    "E_dense": ("ViTEdgewise", {**EW, "gate_mode": "dense"}),
    "E_use_k3": ("ViTEdgewise", {**EW, "gate_mode": "dense", "use_k3": True}),
    "E_views2_mlp2": ("ViTEdgewise", {**EW, "gate_mode": "lowrank", "n_views": 2,
                                      "mlp_ratio": 2.0}),
}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dim,depth,heads", [(32, 2, 4), (48, 3, 6)])
def test_estimate_params_equals_the_jax_count(family, dim, depth, heads):
    cls, extra = FAMILIES[family]
    got = TC.estimate_params(getattr(P, cls), 100, dim, depth, heads, dict(extra))
    want = JC.estimate_params(getattr(J, cls), 100, dim, depth, heads, dict(extra))
    assert got == want


def test_estimate_params_allocates_nothing_and_memoizes():
    TC._ESTIMATE_CACHE.clear()
    n = TC.estimate_params(P.ViT_Baseline, 100, 224, 8, 4)
    assert n == 4_872_000 and len(TC._ESTIMATE_CACHE) == 1
    assert TC.estimate_params(P.ViT_Baseline, 100, 224, 8, 4) == n
    with pytest.raises(ValueError):  # dim not divisible by heads: the search skips it
        TC.estimate_params(P.ViT_Baseline, 100, 226, 8, 4)


# The JAX harness's result at the 5M target, ab5's flag defaults:
# key -> ((dim, depth, heads), params).
JAX_5M = {"A": ((224, 8, 4), 4_872_000), "B": ((216, 8, 4), 4_534_044),
          "C": ((200, 8, 4), 4_849_232), "D": ((200, 8, 4), 4_849_208),
          "E": ((224, 4, 4), 4_870_084)}


def test_ab5_matcher_at_5m_gives_the_jax_configs():
    args = ab5.build_argparser().parse_args([])
    assert args.ew_gate_mode == "lowrank" and not args.ew_use_k3
    cfgs = ab5.match_configs(args, 5_000_000)
    got = {k: ((c["dim"], c["depth"], c["heads"]), p) for k, (c, p) in cfgs.items()}
    assert got == JAX_5M
    e_cfg = cfgs["E"][0]
    assert (e_cfg["_ew_views"], e_cfg["_ew_mlp_ratio"], e_cfg["_ew_use_k3"]) == (5, 4.0, False)
    # B is not within 1% of A (it is the best under A's budget); C and D are.
    b_cfg, b_p, b_within = TC.find_model_config_match_baseline(
        P.ViT_MoP, 100, 5_000_000, {"dim": 224, "depth": 8, "heads": 4}, 4_872_000,
        extra_kwargs={"n_views": 5, "n_kernels": 3})
    assert (b_p, b_within) == (4_534_044, False)
    assert abs(4_872_000 - JAX_5M["C"][1]) / 4_872_000 <= 0.01


def test_fit_edgewise_equals_the_jax_ladder():
    """The E fit under A's config at a small budget, port against JAX."""
    import experiments.cifar100_ab5_param_budgets as jab5

    base_cfg, base_p = {"dim": 128, "depth": 6, "heads": 4}, 1_210_112
    assert TC.estimate_params(P.ViT_Baseline, 100, 128, 6, 4) == base_p
    got = ab5.fit_edgewise(ab5.build_argparser().parse_args([]), 300_000, base_cfg, base_p)
    want = jab5.fit_edgewise(jab5.build_argparser().parse_args([]), 300_000, base_cfg, base_p)
    assert got == want
