"""``WhisperServingEngine(cuda_graph=True)`` on the CPU, where no CUDA graph
can be captured (the refusal is in ``test_torch_graph_engines.py``).

With ``require_graph`` lifted (``StepGraph`` then runs its body eagerly over
the same static buffers, the form a replay computes; no host read in it):
the batched step over the device lengths and live rows (``DeviceMirror``;
the live slots' lengths held equal to the host's after every step) and the
admission (the encoder, then the cross K/V written into the slot a device
index names), one graph each, against the eager engine token for token
(staggered admissions, ``step(n_tokens=3)``, EOS, bf16 KV, int8 weights),
the cross K/V pools bit-equal; and against JAX's engine up to each row's
first near tie, as ``test_torch_serving_whisper.py`` holds the eager one.
"""

import jax
import numpy as np
import pytest
import torch

from mop_tpu.serving import WhisperServingEngine as JaxWhisperEngine
from mop_tpu_torch.ops.quant import quantize_params
from mop_tpu_torch.serving import WhisperServingEngine
from mop_tpu_torch.serving import whisper as W

from _torch_decode_common import lift_graphs
from _torch_serving_common import G, TIE, _one_torch_thread, to_torch  # noqa: F401
from test_torch_serving_whisper import BOS, BUDGETS, _margins, _setup


@pytest.fixture
def lifted(monkeypatch):
    """The graphed engine on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, W)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _staggered(eng, mels, n_tokens=1, eos=None):
    """Two requests, two steps, then two more: every request's tokens; after
    each step the port's live slots' device lengths equal the host's."""
    def run():
        while eng.n_queued or eng.n_active:
            eng.step(n_tokens=n_tokens)
            if isinstance(eng, WhisperServingEngine):
                live = np.asarray([r >= 0 for r in eng._slot_rid])
                assert (eng._dlens.dev.numpy()[live] == eng._lens[live]).all()

    rids = [eng.submit(m, n, eos_id=eos) for m, n in zip(mels[:2], BUDGETS[:2])]
    eng.step(n_tokens=n_tokens)
    eng.step(n_tokens=n_tokens)
    rids += [eng.submit(m, n, eos_id=eos) for m, n in zip(mels[2:], BUDGETS[2:])]
    run()
    return [eng.results[r] for r in rids]


@pytest.mark.parametrize("kv,n_tokens,eos", [("fp32", 1, None), ("fp32", 3, None),
                                             ("bf16", 1, None), ("fp32", 1, "third")])
def test_graphed_engine_is_the_eager_engine(setup, kv, n_tokens, eos, lifted):
    _, _, pm, mels = setup
    kv_dtype = torch.float32 if kv == "fp32" else torch.bfloat16
    if eos == "third":  # the first clip's third token: a stream retires early
        eos = G.whisper_transcribe_cached(pm, torch.from_numpy(mels[0]), BOS, 3)[0, 2].item()
    runs = []
    for graphed in (False, True):
        eng = WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS, kv_dtype=kv_dtype,
                                   cuda_graph=graphed)
        runs.append((_staggered(eng, mels, n_tokens, eos), eng.engine_steps, eng._ck.clone(),
                     eng._cv.clone()))
    assert runs[1][:2] == runs[0][:2] and len({tuple(t) for t in runs[0][0]}) > 1
    for a, b in zip(runs[1][2:], runs[0][2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert eng._admit_graph.calls == len(mels) and eng._step_graph.calls > 2


def test_graphed_engine_int8_weights_is_the_eager_engine(setup, lifted):
    """int8 weights: the decode reads them, the admission's encoder reads
    their dequantized copy."""
    _, _, pm, mels = setup
    params = quantize_params(G.whisper_decode_params(pm), min_size=1024)
    runs = [_staggered(WhisperServingEngine(pm, params, max_batch=2, bos_token=BOS,
                                            cuda_graph=graphed), mels)
            for graphed in (False, True)]
    assert runs[1] == runs[0]


def test_graphed_engine_equals_jax(setup, lifted):
    jm, jp, pm, mels = setup
    want = _staggered(JaxWhisperEngine(jm, jp, max_batch=2, bos_token=BOS), mels)
    got = _staggered(WhisperServingEngine(pm, None, max_batch=2, bos_token=BOS,
                                          cuda_graph=True), mels)
    pp = to_torch(jax.device_get(jp))
    for i, mel in enumerate(mels):
        margins = _margins(pm, pp, mel, want[i])
        stop = next((j for j, m in enumerate(margins) if m < TIE), len(want[i]))
        assert stop > 0 and got[i][:stop] == want[i][:stop], (i, got[i], want[i])
