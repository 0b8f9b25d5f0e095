"""The configs the port's CIFAR-100 budget CLIs plan at their default
targets (5M and 50M), against the JAX scripts' own recorded results, a
regression record as in ``test_torch_experiments_more_plans.py`` (the live
tie to JAX is ``test_torch_experiments_matcher_calls.py``): ``cifar100_ab3``,
``cifar100_ab4`` and ``cifar100_twohop_param_budgets``. ab4's 5M configs
are ab5's (``tests/test_torch_experiments_params.py``): the same families
and extras."""

import pytest
import torch

from mop_tpu_torch.experiments import _param_budgets as PB
from mop_tpu_torch.experiments import cifar100_ab3_param_budgets as ab3
from mop_tpu_torch.experiments import cifar100_ab4_param_budgets as ab4
from mop_tpu_torch.experiments import cifar100_twohop_param_budgets as twohop
from mop_tpu_torch.experiments.cifar10_twohop_param_budgets import match_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# target -> family -> ((dim, depth, heads), params), the JAX scripts' at 100 classes.
JAX_PLANS = {
    5_000_000: {"base": ((224, 8, 4), 4_872_000), "mop": ((216, 8, 4), 4_534_044),
                "xview": ((200, 8, 4), 4_849_232), "multihop": ((200, 8, 4), 4_849_208)},
    50_000_000: {"base": ((640, 10, 4), 49_314_560), "mop": ((632, 10, 4), 48_095_420),
                 "xview": ((640, 8, 4), 49_309_472), "multihop": ((640, 8, 4), 49_309_448)},
}
JAX_TWOHOP = {5_000_000: ((160, 12, 4), 4_649_932), 50_000_000: ((640, 8, 4), 49_309_448)}


@pytest.mark.parametrize("cli", [ab3, ab4], ids=["ab3", "ab4"])
def test_budget_plans_equal_the_jax_scripts(cli):
    args = cli.build_argparser().parse_args([])
    assert args.targets == [5_000_000, 50_000_000]
    for target in args.targets:
        cfgs = PB.match_configs(args, 100, target, cli.FAMILIES)
        got = {k: ((c["dim"], c["depth"], c["heads"]), p) for k, (c, p, _) in cfgs.items()}
        assert got == {f: JAX_PLANS[target][f] for f in cli.FAMILIES}


def test_twohop_plans_equal_the_jax_script():
    args = twohop.build_argparser().parse_args([])
    for target in args.targets:
        cfg, p = match_config(args, 100, target)  # what cifar100_twohop's run() calls
        assert ((cfg["dim"], cfg["depth"], cfg["heads"]), p) == JAX_TWOHOP[target]
