"""GPipe pipeline parallelism on the port, over gloo on the CPU (one
4-process group for the file): the GPT families of ``tests/test_parallel_pp.py``
(4 layers, 64 wide, batch 16) at (pp, microbatches) (2, 4) and (4, 2), one
AdamW step against JAX's one-device step (loss rtol 1e-5, params rtol 2e-3 /
atol 5e-4, the JAX test's) and the port's; each process holding only its
stage's layers; the Quartet stages through the fused op's route (its plain
version on the CPU); the handoffs recorded as collective-permutes of one
microbatch's activations, the counterpart of
``tests/test_parallel_hlo.py::test_pp_lowers_to_collective_permute``."""

import numpy as np
import pytest
import torch

from mop_tpu_torch.parallel import pp
from mop_tpu_torch.utils.jax_weights import load_jax_params
from tests import _torch_pp_common as C
from tests._torch_parallel_common import assert_params_close, run_ranks

CASES = [(2, 4), (4, 2)]


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
def refs(setup):
    idx, tgt = C.batch()
    out = {}
    for fam, (model, params, sd) in setup.items():
        loss, after = C.jax_ref_step(model, params, idx, tgt)
        out[fam] = (loss, C.port_model(fam, after).state_dict(), C.port_ref_step(fam, sd, idx, tgt))
    return out


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    idx, tgt = C.batch()
    inputs = dict(pp_cfg=C.CFG, pp_kw=C.KW, pp_sd={f: v[2] for f, v in setup.items()},
                  idx=torch.from_numpy(idx), tgt=torch.from_numpy(tgt))
    return run_ranks("pp", inputs, tmp_path_factory.mktemp("pp"))


@pytest.mark.parametrize("pp_size,micro", CASES)
@pytest.mark.parametrize("family", C.FAMILIES)
def test_gpipe_step_matches_jax(ranks, refs, family, pp_size, micro):
    want_loss, want, (port_loss, port) = refs[family]
    for r in ranks:
        loss, got, _, _ = r[("gpipe", family, pp_size, micro)]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert_params_close(got, want, 2e-3, 5e-4)
        np.testing.assert_allclose(loss, port_loss, rtol=1e-5)
        assert_params_close(got, port, 2e-3, 5e-4)


@pytest.mark.parametrize("pp_size,micro", CASES)
def test_each_process_holds_its_stage(ranks, setup, pp_size, micro):
    """Every stacked tensor of a process holds n_layer / pp layers."""
    full = pp.split_gpt_params(setup["mop"][2], 4)[1]
    for r in ranks:
        shapes = r[("gpipe", "mop", pp_size, micro)][2]
        assert sorted(shapes) == sorted(full)
        for n, shape in shapes.items():
            assert shape == (4 // pp_size,) + tuple(full[n].shape[1:]), n


def test_quartet_stages_run_the_fused_op(ranks):
    """The Quartet stages call the fused op (its plain version on the CPU):
    once a layer for each microbatch a process runs, none for the others."""
    for pp_size, micro in CASES:
        for r in ranks:
            assert r[("gpipe", "quartet", pp_size, micro)][3] == micro * 4 // pp_size
            assert r[("gpipe", "base", pp_size, micro)][3] == 0


@pytest.mark.parametrize("pp_size,micro", CASES)
def test_handoffs_are_collective_permutes(ranks, pp_size, micro):
    """Forward and backward handoffs are point-to-point sends, each no larger
    than one microbatch's local activations (fp32), and nothing else but the
    gradient and loss reductions."""
    n_data = 4 // pp_size
    act = (16 // micro // n_data) * 16 * 64 * 4
    for r in ranks:
        rec = r[("collectives", pp_size, micro)]
        sends = [e["bytes"] for e in rec if e["op"] == "collective-permute"]
        assert sends and max(sends) <= act, (sends, act)
        assert {e["op"] for e in rec} <= {"collective-permute", "all-reduce", "broadcast"}
    # Inner stages send forward and back for each microbatch; the ends one way.
    n = [len([e for e in r[("collectives", pp_size, micro)]
              if e["op"] == "collective-permute"]) for r in ranks]
    assert sum(n) == 2 * micro * (pp_size - 1) * n_data


def test_stage_checkpoint_restores_at_other_stage_count(ranks):
    """A checkpoint of the 2-stage run (each process writing its stage's
    slices, ``torch.distributed.checkpoint``) restores into 4 stages with
    its AdamW moments: every value bit-equal."""
    for r in ranks:
        step, got, q_shape, n_states, n_params = r["pp_restored"]
        assert step == 2 and q_shape == (1, 64, 64) and n_states == n_params
        want = ranks[0]["pp_saved"]
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_split_merge_round_trip(setup):
    sd = setup["quartet"][2]
    stem, stacked, head = pp.split_gpt_params(sd, 4)
    assert stacked["attn.q_proj.weight"].shape == (4, 64, 64)
    back = pp.merge_gpt_params(stem, stacked, head, 4)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
