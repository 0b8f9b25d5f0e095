"""Shared set-up of the admission graph tests
(``tests/test_torch_graph_engines_admission*.py``): the graphed engines on
the CPU with ``require_graph`` lifted (``StepGraph`` then runs its body
eagerly over the same buffers, the form a replay computes; no host read in
it), every admission's route, width and graph calls recorded, and an eager
and a graphed engine stepped side by side with the device state they hold
compared bit for bit after every step."""

import numpy as np
import pytest
import torch

from mop_tpu_torch.serving import engine as E

from _torch_decode_common import lift_graphs


@pytest.fixture
def lifted(monkeypatch):
    """The graphed engines on the CPU: ``require_graph`` accepts any device,
    and no captured body reads the device on the host (``HostReads``)."""
    seen = lift_graphs(monkeypatch, E)
    yield
    assert not seen, f"host reads in a captured body: {sorted(set(seen))}"


def device_state(eng) -> dict:
    """What an engine holds on the device: the slots' tokens, output counts,
    prompt masks, bias rows and lengths, every pool (the paged engine's
    pages, the speculative engine's draft pool) and the LoRA rows."""
    out = {k: getattr(eng, k) for k in ("_tokens", "_ocounts", "_pseen", "_lbias")}
    out["lens"] = eng._dlens.dev
    pools = eng._cache if eng._cache is not None else eng._pool
    out.update({f"pool/{k}": v for k, v in pools.items()})
    out.update({f"draft/{k}": v for k, v in getattr(eng, "_dcache", {}).items()})
    for path, (a, b) in eng._lora_rows.items():
        out[f"lora/{path}"] = torch.cat([a.reshape(-1), b.reshape(-1)])
    return out


def record_admissions(eng) -> list:
    """Wrap ``eng._admit_run``: each call appends (route, width, its graph
    calls, slot, tok0)."""
    seen, run = [], eng._admit_run

    def recorded(route, width, slot, *a, **kw):
        before = eng._adm_graph.calls if eng._adm_graph is not None else 0
        out = run(route, width, slot, *a, **kw)
        after = eng._adm_graph.calls if eng._adm_graph is not None else 0
        seen.append((route, width, after - before, slot, None if out is None else out[0]))
        return out

    eng._admit_run = recorded
    return seen


def lockstep(make, jobs, staggered=0, n_tokens=1):
    """``make(graphed)``'s eager and graphed engines stepped side by side over
    ``jobs`` ((prompt, budget, options) each; the first ``staggered`` ones
    submitted a step ahead of the rest): each call's tokens equal, the
    generators' states and every device buffer (``device_state``) equal
    after it, the graphed engine's length and output-position mirrors what
    its host recorded. Returns the engines, their request ids and the
    graphed engine's admissions (``record_admissions``)."""
    engs = [make(False), make(True)]
    logs = [record_admissions(e) for e in engs]
    waves = [jobs[:staggered], jobs[staggered:]] if staggered else [jobs]
    rids = [[], []]
    for w, wave in enumerate(waves):
        for e, r in zip(engs, rids):
            r.extend(e.submit(p, n, **kw) for p, n, kw in wave)
        while any(e.n_queued or e.n_active for e in engs):
            outs = [e.step() if n_tokens == 1 else e.step(n_tokens=n_tokens) for e in engs]
            assert outs[1] == outs[0]
            assert torch.equal(engs[1]._gen.get_state(), engs[0]._gen.get_state())
            want, got = device_state(engs[0]), device_state(engs[1])
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], want[k]), k
            for mirror in (engs[1]._dlens, engs[1]._dntok):
                assert torch.equal(mirror.dev, torch.from_numpy(mirror._held))
            if w + 1 < len(waves):
                break  # the next wave joins the running one
    eager, graphed = engs
    assert [graphed.results[r] for r in rids[1]] == [eager.results[r] for r in rids[0]]
    assert graphed.logprobs == eager.logprobs and graphed.top_logprobs == eager.top_logprobs
    assert [(r, w, s, t) for r, w, _, s, t in logs[1]] == \
        [(r, w, s, t) for r, w, _, s, t in logs[0]]
    assert not any(calls for _, _, calls, _, _ in logs[0])
    return engs, rids, logs[1]


def expected_form(kw: dict) -> str:
    """The picker form of a request's first pick alone in its slot."""
    if kw.get("temperature", 0) <= 0:
        return E.GREEDY
    return E.SAMPLE if "seed" in kw else E.DRAW


def assert_one_call_each(log, routes=(E.BUCKET, E.TAIL, E.CHUNK)):
    """Every admission on a graphed route made one graph call, every exact
    one none."""
    assert log and all(calls == (1 if route in routes else 0) for route, _, calls, _, _ in log), log


def bincount(tokens, vocab) -> np.ndarray:
    return np.bincount(np.asarray(tokens, np.int64), minlength=vocab).astype(np.int32)
