"""The 1F1B pipeline schedule on the port, over gloo on the CPU (one
4-process group for the file), the counterpart of
``tests/test_parallel_pp_1f1b.py``: at dropout 0.1 the step equals the
port's ``reference_1f1b_composition`` (the same masks on one process, no
pipeline) for the base, Quartet and MoP families at (pp, microbatches)
(2, 4), (4, 2) and (4, 8) (loss rtol 1e-6; the params after one AdamW step
rtol 2e-3 / atol 5e-4), with at most min(M, 2 pp - 1) stage inputs stored;
at dropout 0 it equals the GPipe step and JAX's one-device step."""

import numpy as np
import pytest
import torch

from mop_tpu_torch.parallel import pp
from tests import _torch_pp_common as C
from tests._torch_parallel_common import assert_params_close, run_ranks

CASES = [(2, 4, 16), (4, 2, 16), (4, 8, 16)]  # (pp, microbatches, batch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return C.jax_setup()


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    idx, tgt = C.batch()
    inputs = dict(pp_cfg=C.CFG, pp_kw=C.KW, pp_sd={f: v[2] for f, v in setup.items()},
                  idx=torch.from_numpy(idx), tgt=torch.from_numpy(tgt), **{"1f1b_cases": CASES})
    inputs["idx_b"] = {b: torch.from_numpy(C.batch(b)[0]) for _, _, b in CASES}
    inputs["tgt_b"] = {b: torch.from_numpy(C.batch(b)[1]) for _, _, b in CASES}
    return run_ranks("pp_1f1b", inputs, tmp_path_factory.mktemp("pp_1f1b"))


def _reference(setup, fam, micro, b, n_data):
    """The composition's loss and the params after one AdamW step on its grads."""
    sd = setup[fam][2]
    model = C.port_model(fam, dropout=0.1)
    idx, tgt = (torch.from_numpy(a) for a in C.batch(b))
    stem, stacked, head = pp.split_gpt_params(sd, 4)
    loss, grads = pp.reference_1f1b_composition(model, stem, stacked, head, idx, tgt, 7, micro,
                                                n_data=n_data)
    ps = [torch.nn.Parameter(t.clone()) for tree in (stem, stacked, head) for t in tree.values()]
    for p, g in zip(ps, [g for tree in grads for g in tree.values()]):
        p.grad = g
    torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4).step()
    it = iter(ps)
    after = tuple({k: next(it).detach() for k in tree} for tree in (stem, stacked, head))
    return loss.item(), pp.merge_gpt_params(*after, 4)


@pytest.mark.parametrize("pp_size,micro,b", CASES)
@pytest.mark.parametrize("family", C.FAMILIES)
def test_1f1b_with_dropout_matches_composition(setup, ranks, family, pp_size, micro, b):
    want_loss, want = _reference(setup, family, micro, b, 4 // pp_size)
    for r in ranks:
        loss, got, shapes, peak = r[("1f1b", family, pp_size, micro)]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
        assert_params_close(got, want, 2e-3, 5e-4)
        assert shapes["attn.q_proj.weight"][0] == 4 // pp_size
        assert peak <= min(micro, 2 * pp_size - 1)


def test_1f1b_stores_at_most_2s_minus_1_inputs(ranks):
    """At 4 stages and 8 microbatches the second stage holds the most
    inputs: 2 (S - 1 - s) + 1 = 5 of the bound min(M, 2S - 1) = 7."""
    peaks = [r[("1f1b", "base", 4, 8)][3] for r in ranks]
    assert peaks == [0, 5, 3, 0]


def test_1f1b_matches_gpipe_and_jax_at_zero_dropout(setup, ranks):
    idx, tgt = C.batch()
    model, params, _ = setup["base"]
    want_loss, after = C.jax_ref_step(model, params, idx, tgt)
    want = C.port_model("base", after).state_dict()
    for r in ranks:
        (l_g, p_g), (l_1, p_1) = r[("zero_dropout", "gpipe")], r[("zero_dropout", "1f1b")]
        np.testing.assert_allclose(l_1, l_g, rtol=1e-6)
        assert_params_close(p_1, p_g, 2e-3, 5e-4)
        np.testing.assert_allclose(l_1, want_loss, rtol=1e-5)
        assert_params_close(p_1, want, 2e-3, 5e-4)
