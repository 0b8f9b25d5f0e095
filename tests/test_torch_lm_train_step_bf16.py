"""The port's LM train step against ``mop_tpu``'s at bf16 compute: the baseline
GPT, the Quartet LM and GPT-MoP, three steps each, with the tolerances and
the whole-model update criterion that ``test_torch_lm_train_step.py``
states. (Split from that file, so that neither is the long pole of a
parallel run.)"""

import pytest
import torch

from test_torch_lm_train_step import MODELS, check_lm_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are small, and the lane's parallel
    workers share the cores, which torch's spinning pool would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_lm_train_step_matches_jax(name, dtype):
    check_lm_train_step(name, dtype)
