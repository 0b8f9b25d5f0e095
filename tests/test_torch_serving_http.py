"""The port's ``ServingServer`` on loopback against the JAX package's over
the same weights: ``/generate`` (token and text prompts, blocking and SSE)
answering JAX's server's greedy tokens, ``/cancel``, ``/health``,
``/metrics`` (counters and the TTFT / TPOT histograms), 429 backpressure
and drain; and the device worker's ``inference_mode`` (after a served
request no cache tensor records autograd state). Every request has a
timeout and every server stops in the fixture's teardown."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from mop_tpu.data import CharTokenizer as JaxCharTokenizer
from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu.serving import ServingServer as JaxServer
from mop_tpu_torch.data.tokenizer import CharTokenizer
from mop_tpu_torch.serving import DecodeEngine, ServingServer

from _torch_serving_common import _one_torch_thread, lm_pair, to_torch  # noqa: F401

TIMEOUT = 60
CHARS = "abcdefghijklmnopqrstuvwxyz .,!?0123456"  # 38 characters, + <eos> and <unk> = 40


def _req(port, path, payload=None, timeout=TIMEOUT):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read().decode()
    return json.loads(body) if body.startswith("{") else body


def _stream(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return events


@pytest.fixture(scope="module")
def servers():
    jm, jp, pm = lm_pair("quartet", scale=2.0, block_size=64)
    pp = to_torch(jax.device_get(jp))
    jtok, ptok = JaxCharTokenizer(CHARS), CharTokenizer(CHARS)
    assert ptok.vocab_size == 40
    jsrv = JaxServer(JaxEngine(jm, jp, max_batch=3, eos_id=jtok.eos_id, prefill_buckets=[64]),
                     tokenizer=jtok)
    psrv = ServingServer(DecodeEngine(pm, pp, max_batch=3, eos_id=ptok.eos_id), tokenizer=ptok)
    jsrv.start()
    psrv.start()
    try:
        yield jsrv, psrv
    finally:
        for s in (jsrv, psrv):
            if s._running:
                s.stop()


def test_generate_equals_jax_server(servers):
    jsrv, psrv = servers
    for payload in ({"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 10},
                    {"text": "hello there", "max_new_tokens": 12},
                    {"prompt": [7, 8], "max_new_tokens": 6, "stop": [[5, 5]],
                     "logit_bias": {"9": -50.0}}):
        want = _req(jsrv.port, "/generate", payload)
        got = _req(psrv.port, "/generate", payload)
        assert got["tokens"] == want["tokens"] and got.get("text") == want.get("text")


def test_concurrent_clients_and_sse(servers):
    _, psrv = servers
    prompts = [[3, 1, 4], [2, 7, 1, 8], [1, 6], [9, 9, 9, 2], [5]]
    direct = {}
    for i, p in enumerate(prompts):  # what each gets alone
        direct[i] = _req(psrv.port, "/generate", {"prompt": p, "max_new_tokens": 8})["tokens"]
    got = {}

    def client(i):
        got[i] = _req(psrv.port, "/generate", {"prompt": prompts[i], "max_new_tokens": 8})["tokens"]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert got == direct
    events = _stream(psrv.port, {"prompt": prompts[0], "max_new_tokens": 8, "stream": True})
    assert "request_id" in events[0] and events[-1]["done"]
    assert [e["token"] for e in events if "token" in e] == direct[0] == events[-1]["tokens"]
    text = _stream(psrv.port, {"text": "abc", "max_new_tokens": 6, "stream": True})
    assert "".join(e["text"] for e in text if "token" in e) == text[-1]["text"]


def test_cancel_health_metrics_and_inference_mode(servers):
    _, psrv = servers
    assert _req(psrv.port, "/cancel", {"request_id": 10 ** 6}) == {"request_id": 10 ** 6,
                                                                  "cancelled": False}
    eng = psrv.engine
    step = eng.step
    modes = []

    def slow_step(*a, **k):  # 10 ms a step: the stream outlasts the cancel's round trip
        time.sleep(0.01)
        modes.append(torch.is_inference_mode_enabled())
        return step(*a, **k)

    eng.step = slow_step
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{psrv.port}/generate",
            data=json.dumps({"prompt": [1, 2], "max_new_tokens": 60, "stream": True,
                             "logit_bias": {"38": -100.0}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            rid = json.loads(r.readline().decode()[len("data: "):])["request_id"]
            assert _req(psrv.port, "/cancel", {"request_id": rid})["cancelled"] is True
            rest = [json.loads(line.decode()[len("data: "):]) for line in r
                    if line.startswith(b"data: ")]
        # a request the worker steps whatever the cancel's timing
        _req(psrv.port, "/generate", {"prompt": [1, 2], "max_new_tokens": 2})
    finally:
        eng.step = step
    assert rest[-1]["done"] and len(rest[-1]["tokens"]) < 60
    health = _req(psrv.port, "/health")
    assert health["status"] == "ok" and health["active"] == 0
    metrics = _req(psrv.port, "/metrics")
    for name in ("mop_requests_completed_total", "mop_tokens_generated_total",
                 "mop_ttft_seconds_bucket", "mop_ttft_seconds_count", "mop_tpot_seconds_sum"):
        assert name in metrics, name
    with psrv._lock:  # the worker's steps ran under inference_mode
        for key in eng._pool_keys:
            assert not eng._cache[key].requires_grad and eng._cache[key].grad_fn is None
        assert modes and all(modes)
        assert not eng._tokens.requires_grad and eng._tokens.grad_fn is None
        assert not eng._ocounts.requires_grad


def test_backpressure_429():
    """The queue bound: with the queue full, a new request is refused with
    429 and Retry-After (no device worker runs here, so the queue stays)."""
    _, _, pm = lm_pair("quartet", block_size=64)
    srv = ServingServer(DecodeEngine(pm, None, max_batch=1), max_queue=2)
    thread = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    thread.start()
    try:
        srv.engine.submit([1, 2], 4)
        srv.engine.submit([3], 4)
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(srv.port, "/generate", {"prompt": [1], "max_new_tokens": 2})
        assert e.value.code == 429 and e.value.headers["Retry-After"] is not None
        assert "mop_requests_rejected_total 1" in _req(srv.port, "/metrics")
    finally:
        srv._httpd.shutdown()
        srv._httpd.server_close()
        thread.join(TIMEOUT)


def test_drain_finishes_inflight_and_refuses_new():
    """A request queued before the drain starts (the worker held off by the
    server's lock until then) runs to its end; one after it gets 503."""
    _, _, pm = lm_pair("quartet", block_size=64)
    srv = ServingServer(DecodeEngine(pm, None, max_batch=2))
    srv.start()
    try:
        ret = {}
        with srv._lock:
            rid = srv.engine.submit([3, 1, 4], 40)
            d = threading.Thread(target=lambda: ret.setdefault(
                "finished", srv.drain(stop_when_drained=False)))
            d.start()
            deadline = time.time() + TIMEOUT
            while not srv._draining:
                assert time.time() < deadline
                time.sleep(0.002)
        assert _req(srv.port, "/health")["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(srv.port, "/generate", {"prompt": [1], "max_new_tokens": 2})
        assert e.value.code == 503 and e.value.headers["Retry-After"] is not None
        d.join(TIMEOUT)
        assert ret["finished"] is True and len(srv.engine.results[rid]) == 40
    finally:
        if srv._running:
            srv.stop()
    assert np.all(srv.engine._lens == 0)


def test_server_lock_is_granted_in_order():
    """The device worker asks for the lock again as soon as it releases it;
    a handler that asked first gets it first (with a plain lock the worker
    wins that race while the engine is busy, and /cancel waits for idle)."""
    from mop_tpu_torch.serving.http import _FairLock

    lock, order = _FairLock(), []

    def handler():
        with lock:
            order.append("handler")

    lock.__enter__()  # the worker's step
    waiter = threading.Thread(target=handler)
    waiter.start()
    deadline = time.time() + TIMEOUT
    while lock._next < 2:  # the handler holds the next ticket
        assert time.time() < deadline
        time.sleep(0.001)
    lock.__exit__()
    with lock:  # the worker's next step
        order.append("worker")
    waiter.join(TIMEOUT)
    assert order == ["handler", "worker"]
