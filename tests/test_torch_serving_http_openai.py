"""The port's OpenAI-compatible endpoints on loopback against the JAX
package's server over the same weights: ``/v1/models``,
``/v1/completions`` (blocking with ``logprobs`` and ``echo``, and SSE
chunks), ``/v1/chat/completions`` (``n`` choices, ``response_format``
json_schema, ``logprobs``), ``/v1/embeddings`` and
``/v1/audio/transcriptions`` through a ``WhisperServingEngine``: the same
JSON, texts and tokens, logprobs and vectors at rtol 2e-4 / atol 2e-5.
Every request has a timeout and every server stops in the teardown."""

import base64
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mop_tpu.models as J
import mop_tpu_torch.models as PM
from mop_tpu.data import CharTokenizer as JaxCharTokenizer
from mop_tpu.serving import DecodeEngine as JaxEngine
from mop_tpu.serving import ServingServer as JaxServer
from mop_tpu.serving import WhisperServingEngine as JaxWhisperEngine
from mop_tpu_torch.data.audio import wav_bytes
from mop_tpu_torch.data.tokenizer import CharTokenizer
from mop_tpu_torch.serving import DecodeEngine, ServingServer, WhisperServingEngine
from mop_tpu_torch.utils.jax_weights import load_jax_params

from _torch_serving_common import ATOL, RTOL, _one_torch_thread, lm_pair, to_torch  # noqa: F401

TIMEOUT = 60
CHARS = sorted(set('{}[]":,-0123456789truefalsenulxyokag bhi\n'))
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "tag": {"enum": ["x", "y"]}}}
WHISPER = dict(n_mels=8, n_audio_ctx=16, n_text_ctx=16, n_embd=32, n_head=2, n_layer_enc=1,
               n_layer_dec=1, dropout=0.0)
BOUNDARY = "mopboundary31337"


def _post(port, path, payload, raw=False):
    body = payload if raw else json.dumps(payload).encode()
    ctype = f"multipart/form-data; boundary={BOUNDARY}" if raw else "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        text = r.read().decode()
    return json.loads(text) if not text.startswith("data: ") else [
        line[len("data: "):] for line in text.splitlines() if line.startswith("data: ")]


@pytest.fixture(scope="module")
def servers():
    jtok, ptok = JaxCharTokenizer(CHARS), CharTokenizer(CHARS)
    v = ptok.vocab_size
    jm, jp, pm = lm_pair("quartet", scale=2.0, vocab=v, block_size=96)
    pp = to_torch(jax.device_get(jp))
    wcfg = dict(WHISPER, vocab_size=v)
    wj = J.create_whisper_mop(J.WhisperConfig(**wcfg))
    wparams = jax.device_get(wj.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 8)),
                                     jnp.zeros((1, 4), jnp.int32)))
    wp = load_jax_params(PM.create_whisper_mop(PM.WhisperConfig(**wcfg), device="cpu"), wparams)
    kw = dict(model_name="mop-test")
    jsrv = JaxServer(JaxEngine(jm, jp, max_batch=3, eos_id=jtok.eos_id, logprobs_topk=3,
                               prefill_buckets=[96]), tokenizer=jtok,
                     whisper_engine=JaxWhisperEngine(wj, jax.tree_util.tree_map(
                         jnp.asarray, wparams), max_batch=2, bos_token=1), **kw)
    psrv = ServingServer(DecodeEngine(pm, pp, max_batch=3, eos_id=ptok.eos_id, logprobs_topk=3),
                         tokenizer=ptok,
                         whisper_engine=WhisperServingEngine(wp.eval(), None, max_batch=2,
                                                             bos_token=1), **kw)
    jsrv.start()
    psrv.start()
    try:
        yield jsrv, psrv
    finally:
        for s in (jsrv, psrv):
            if s._running:
                s.stop()


def _strip(body):
    """The response without its volatile fields (ids, timestamps)."""
    return {k: v for k, v in body.items() if k not in ("id", "created", "system_fingerprint")}


def _assert_close(got, want, path="$"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("path,payload", [
    ("/v1/completions", {"prompt": "the big", "max_tokens": 10, "logprobs": 2, "echo": True}),
    ("/v1/completions", {"prompt": "hi", "max_tokens": 40, "response_format": {
        "type": "json_schema", "json_schema": {"name": "out", "schema": SCHEMA}}}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "go"}], "max_tokens": 8,
                              "n": 2, "logprobs": True, "top_logprobs": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "go"}], "max_tokens": 40,
                              "response_format": {"type": "json_schema", "json_schema": {
                                  "name": "out", "schema": SCHEMA}}}),
    ("/v1/embeddings", {"input": ["the big", "oak"], "dimensions": 16}),
    ("/v1/embeddings", {"input": [[3, 4, 5]], "encoding_format": "base64"}),
])
def test_openai_bodies_equal_jax(servers, path, payload):
    jsrv, psrv = servers
    want, got = _post(jsrv.port, path, payload), _post(psrv.port, path, payload)
    if payload.get("encoding_format") == "base64":
        for d in (want, got):
            for e in d["data"]:
                e["embedding"] = np.frombuffer(base64.b64decode(e["embedding"]), "<f4").tolist()
    _assert_close(_strip(got), _strip(want))
    if "response_format" in payload:
        ch = got["choices"][0]
        text = ch["text"] if "text" in ch else ch["message"]["content"]
        if ch["finish_reason"] == "stop":
            assert list(json.loads(text)) == ["ok", "tag"]


def test_models_streaming_and_audio(servers):
    jsrv, psrv = servers
    with urllib.request.urlopen(f"http://127.0.0.1:{psrv.port}/v1/models", timeout=TIMEOUT) as r:
        models = json.loads(r.read())
    assert [m["id"] for m in models["data"]] == ["mop-test"]
    payload = {"prompt": "the big", "max_tokens": 8, "stream": True}
    chunks = _post(psrv.port, "/v1/completions", payload)
    assert chunks[-1] == "[DONE]"
    text = "".join(json.loads(c)["choices"][0]["text"] for c in chunks[:-1])
    blocking = _post(psrv.port, "/v1/completions", dict(payload, stream=False))
    assert text == blocking["choices"][0]["text"]
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(3200) / 16000)).astype(np.float32)
    form = (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"file\"; "
            "filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    form += wav_bytes(tone, 16000) + f"\r\n--{BOUNDARY}--\r\n".encode()
    want = _post(jsrv.port, "/v1/audio/transcriptions", form, raw=True)
    got = _post(psrv.port, "/v1/audio/transcriptions", form, raw=True)
    assert got == want and len(got["text"]) > 0
