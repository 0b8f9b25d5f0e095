"""The parameter-matching search of the port's harness against the JAX
harness's on the same inputs: ``find_config_for_target`` and
``find_model_config_match_baseline`` (the windowed binary search over dims and
its scoring) for B, C and D with the extras the ab5 harness passes. The grids
are narrowed so that the JAX side's traces stay few; the search at the 5M
target is held to the JAX result in ``tests/test_torch_experiments_params.py``."""

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


XVIEW = dict(use_transpose_cues=False, t1=0.0, t2=0.0, enable_per_key_prior=False,
             prior_weight=0.5, anchor_mode="argmax_row_sum", fixed_k_star=0)
GATES_D = dict(gates=dict(base=1.0, and_=1.0, or_=0.0, not_=0.0, chain=1.0), beta_not=0.5,
               hops=3)

# A narrowed grid for the search-against-search test: the JAX counts cost a
# trace each, so the grids stay small while the windowed binary search and the
# scoring still choose among several dims, depths and heads.
SEARCH_GRID = dict(dims=(96, 128, 160), depths=(4, 6), heads_list=(4, 6, 8))
SEARCH_DIMS = tuple(range(64, 161, 8))


# (target, max_ratio_diff): at these widths no candidate comes within 1% of A
# (one dim step is more), so the second case widens the band to reach the
# search's within-the-band branch.
@pytest.mark.parametrize("target,ratio", [(600_000, 0.01), (1_000_000, 0.1)])
def test_matcher_search_equals_the_jax_search(target, ratio):
    """``find_config_for_target`` and ``find_model_config_match_baseline`` of
    both packages on the same narrowed grids, B, C and D with the extras the
    ab5 harness passes at its flag defaults: the same (config, params, within)."""
    args = ab5.build_argparser().parse_args([])
    base_cfg, base_p = TC.find_config_for_target(P.ViT_Baseline, 100, target, **SEARCH_GRID)
    assert (base_cfg, base_p) == JC.find_config_for_target(J.ViT_Baseline, 100, target,
                                                           **SEARCH_GRID)
    families = {"B": ("ViT_MoP", {"n_views": args.mop_views, "n_kernels": args.mop_kernels}),
                "C": ("ViTCrossView", ab5.xview_extra(args)),
                "D": ("ViTMultiHop", ab5.mh_extra(args))}
    assert families["C"][1] == XVIEW and families["D"][1] == GATES_D
    within = []
    for key, (cls, extra) in families.items():
        kw = dict(max_ratio_diff=ratio, dims_choices=SEARCH_DIMS, depths_choices=(4, 6),
                  extra_kwargs=extra)
        got = TC.find_model_config_match_baseline(getattr(P, cls), 100, target, base_cfg,
                                                  base_p, **kw)
        want = JC.find_model_config_match_baseline(getattr(J, cls), 100, target, base_cfg,
                                                   base_p, **kw)
        assert got == want, key
        within.append(got[2])
    assert any(within) == (ratio > 0.01)
