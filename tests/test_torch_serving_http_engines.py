"""The port's ``ServingServer`` over the paged and the speculative engine on
loopback: ``/generate`` answers each engine's own tokens (the paged server
with ``steps_per_dispatch=2``); ``steps_per_dispatch=2`` with a
``SpecDecodeEngine`` is refused at construction (its step takes no
``n_tokens``) and ``num_beams`` on it (``/v1/completions``) is a clean
400; and the demo ``serve_http --spec`` trains its draft, serves and passes
its self-test on the CPU. Every request has a timeout and every server stops
in a ``finally``."""

import json
import urllib.error
import urllib.request

import pytest

from mop_tpu_torch.cli import serve_http
from mop_tpu_torch.serving import PagedDecodeEngine, ServingServer, SpecDecodeEngine

from _torch_serving_common import _one_torch_thread, lm_pair  # noqa: F401

TIMEOUT = 60
PROMPTS = [[3, 1, 4, 1, 5], [2, 7], [9, 9, 2, 6]]


def _post(port, payload, path="/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _serve_and_compare(make, **server_kw):
    """The server's answers against a fresh engine's own run."""
    ref = make()
    rids = [ref.submit(p, 7) for p in PROMPTS]
    res = ref.run()
    srv = ServingServer(make(), port=0, **server_kw)
    srv.start()
    try:
        for p, rid in zip(PROMPTS, rids):
            assert _post(srv.port, {"prompt": p, "max_new_tokens": 7})["tokens"] == res[rid]
    finally:
        if srv._running:
            srv.stop()


def test_paged_server_answers_generate():
    pm = lm_pair("quartet", scale=3.0)[2]
    _serve_and_compare(lambda: PagedDecodeEngine(pm, None, max_batch=2, n_pages=8, page_size=4),
                       steps_per_dispatch=2)


def test_spec_server_answers_generate_and_refuses_bursts_and_beams():
    pm = lm_pair("quartet", scale=3.0)[2]
    draft = lm_pair("quartet", seed=7, scale=3.0, n_layer=1, n_embd=16)[2]

    def make():
        return SpecDecodeEngine(pm, None, draft, None, max_batch=2, gamma=3)

    with pytest.raises(ValueError, match="n_tokens"):
        ServingServer(make(), port=0, steps_per_dispatch=2)
    ref = make()
    rid = ref.submit(PROMPTS[0], 7)
    want = ref.run()[rid]
    srv = ServingServer(make(), port=0)
    srv.start()
    try:
        assert _post(srv.port, {"prompt": PROMPTS[0], "max_new_tokens": 7})["tokens"] == want
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.port, {"model": "mop", "prompt": PROMPTS[1], "max_tokens": 4,
                             "num_beams": 2}, "/v1/completions")
        assert err.value.code == 400
    finally:
        if srv._running:
            srv.stop()


def test_demo_serves_speculatively():
    out = serve_http.main(["--device", "cpu", "--spec", "--steps", "3", "--clients", "2"])
    eng = out["engine"]
    assert isinstance(eng, SpecDecodeEngine) and eng.gamma == 4
    assert eng.draft_model.config.n_layer == 2 and eng.draft_model.config.n_embd == 64
    assert out["drained"] is True and not eng.n_active
    assert len(out["texts"]) == 2 and all(out["texts"])
    assert out["completion"]["finish_reason"] in ("stop", "length")
    assert int(out["metrics"]["mop_requests_completed_total"]) >= 4
