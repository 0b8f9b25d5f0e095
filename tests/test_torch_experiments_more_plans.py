"""The configs the port's CIFAR-10 budget CLIs plan at their default
targets (5M and 50M), against the JAX scripts' own: ``cifar10_ab``,
``cifar10_ab3`` and ``cifar10_twohop_param_budgets``. The JAX searches take
over a minute each on a CPU (a trace per candidate), so these tables are a
regression record of their results: the JAX script's ``main`` at its
defaults, its training stubbed out, the configs it built and the counts it
printed. The tie to JAX is ``test_torch_experiments_matcher_calls.py``,
which holds each CLI's matcher calls to the JAX script's, live, and the
matcher tests that hold the search itself. The CIFAR-100 CLIs are in
``test_torch_experiments_more_plans_b.py``."""

import pytest
import torch

from mop_tpu_torch.experiments import _param_budgets as PB
from mop_tpu_torch.experiments import cifar10_ab3_param_budgets as ab3
from mop_tpu_torch.experiments import cifar10_ab_param_budgets as ab
from mop_tpu_torch.experiments import cifar10_twohop_param_budgets as twohop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# target -> family -> ((dim, depth, heads), params), the JAX scripts' at 10 classes.
JAX_PLANS = {
    5_000_000: {"base": ((224, 8, 4), 4_851_840), "mop": ((216, 8, 4), 4_514_604),
                "xview": ((200, 8, 4), 4_831_232)},
    50_000_000: {"base": ((640, 10, 4), 49_256_960), "mop": ((632, 10, 4), 48_038_540),
                 "xview": ((640, 8, 4), 49_251_872)},
}
JAX_TWOHOP = {5_000_000: ((160, 12, 4), 4_635_532), 50_000_000: ((640, 8, 4), 49_251_848)}


def _plain(cfgs):
    return {k: ((c["dim"], c["depth"], c["heads"]), p) for k, (c, p, _) in cfgs.items()}


@pytest.mark.parametrize("cli,families", [(ab, ["base", "mop"]), (ab3, ab3.FAMILIES)],
                         ids=["ab", "ab3"])
def test_budget_plans_equal_the_jax_scripts(cli, families):
    args = cli.build_argparser().parse_args([])
    assert args.targets == [5_000_000, 50_000_000]
    for target in args.targets:
        cfgs = PB.match_configs(args, 10, target, families)
        assert _plain(cfgs) == {f: JAX_PLANS[target][f] for f in families}
        assert cfgs["mop"][2] is False  # B is the best under A's budget, not within 1%


def test_twohop_plans_equal_the_jax_script():
    args = twohop.build_argparser().parse_args([])
    for target in args.targets:
        cfg, p = twohop.match_config(args, 10, target)
        assert ((cfg["dim"], cfg["depth"], cfg["heads"]), p) == JAX_TWOHOP[target]
