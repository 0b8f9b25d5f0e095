"""Serving demo: train a byte-BPE tokenizer and a tiny Quartet LM on a text
corpus, serve both behind the HTTP front-end, and run concurrent text
clients against it.

The port's counterpart of ``examples/serve_http.py``: tokenizer training,
LM training (4 layers, 128 wide, 4 heads, block 256, AdamW 3e-4 with
optax.adamw's weight decay 1e-4, 32 random 64-token windows a step), int8 /
int4 weights on request, the continuous-batching ``DecodeEngine`` with a
prefix cache (with ``--spec``: a ``SpecDecodeEngine`` whose draft, 2 layers,
64 wide, 2 heads, is trained like the target, gamma 4), and the server with
server-side encode / decode. The self-test sends ``--clients`` concurrent
``/generate`` text requests, one streamed request, an OpenAI
``/v1/completions`` and a ``/v1/embeddings`` request, reads ``/metrics`` and
drains the server. Runs on the GPU unless given ``--device cpu``; on the GPU
the engine's batched step (the speculative engine's round) is one CUDA
graph.

Usage:
  python -m mop_tpu_torch.cli.serve_http                 # train, serve, self-test
  python -m mop_tpu_torch.cli.serve_http --port 8000 --keep-serving
  python -m mop_tpu_torch.cli.serve_http --quant int4 --device cpu --steps 20
  python -m mop_tpu_torch.cli.serve_http --spec --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.request
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.audio import wav_bytes
from ..data.tokenizer import ByteBPETokenizer
from ..models import TransformerConfig, create_gpt_quartet
from ..models.generate import decode_params
from ..ops.quant import quantize_params, quantized_bytes
from ..serving import DecodeEngine, ServingServer, SpecDecodeEngine
from ..utils.device import resolve_device

CORPUS = ("the quick brown fox jumps over the lazy dog. "
          "pack my box with five dozen liquor jugs. ") * 64
PROMPTS = ["the quick ", "pack my ", "five dozen ", "the lazy ", "my box ", "brown fox ",
           "liquor ", "jumps over "]
BOUNDARY = "mopboundary31337"


def train_lm(n_layer: int, n_embd: int, n_head: int, steps: int, seed: int, vocab_size: int,
             data: np.ndarray, device) -> tuple:
    """A Quartet LM briefly trained on a tokenized corpus: (model, last loss)."""
    cfg = TransformerConfig(n_layer=n_layer, n_head=n_head, n_embd=n_embd, dropout=0.0,
                            block_size=256)
    model = create_gpt_quartet(vocab_size, cfg, device=device,
                               generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)  # optax.adamw
    rs = np.random.RandomState(seed)
    t = 64
    loss = torch.zeros(())
    for _ in range(steps):
        i0 = rs.randint(0, data.size - t - 1, size=(32,))
        batch = torch.from_numpy(np.stack([data[i:i + t + 1] for i in i0])).to(device)
        _, loss = model(batch[:, :-1], targets=batch[:, 1:])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return model.eval(), float(loss.detach())


def _request(port: int, path: str, body: bytes, ctype: str = "application/json",
             timeout: float = 300.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=timeout)


def _post(port: int, path: str, body: dict, timeout: float = 300.0) -> dict:
    with _request(port, path, json.dumps(body).encode(), timeout=timeout) as r:
        return json.loads(r.read())


def _wav_form(audio: np.ndarray, rate: int) -> tuple:
    """A multipart form holding ``audio`` as a PCM WAV file."""
    body = (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"file\"; "
            "filename=\"audio.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += wav_bytes(audio, rate) + f"\r\n--{BOUNDARY}--\r\n".encode()
    return body, f"multipart/form-data; boundary={BOUNDARY}"


def self_test(srv: ServingServer, n_clients: int, audio: Optional[np.ndarray] = None,
              audio_rate: int = 16000, timeout: float = 300.0) -> dict:
    """Drive the server over loopback; returns what each endpoint answered."""
    port = srv.port
    out: dict = {"texts": [None] * n_clients}
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(n_clients)]

    def client(i):
        out["texts"][i] = _post(port, "/generate", {"text": prompts[i], "max_new_tokens": 24},
                                timeout)["text"]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for p, text in zip(prompts, out["texts"]):
        print(f"  {p!r} -> {text!r}", flush=True)
    pieces = []
    with _request(port, "/generate", json.dumps({"text": "the quick ", "max_new_tokens": 24,
                                                 "stream": True}).encode(), timeout=timeout) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                ev = json.loads(line[len("data: "):])
                if "token" in ev:
                    pieces.append(ev["text"])
    out["streamed"] = "".join(pieces)
    print(f"  streamed: 'the quick ' -> {out['streamed']!r}", flush=True)
    choice = _post(port, "/v1/completions", {"model": "mop", "prompt": "the quick ",
                                             "max_tokens": 16, "stop": ["."]},
                   timeout)["choices"][0]
    out["completion"] = choice
    print(f"  /v1/completions: {choice['text']!r} (finish={choice['finish_reason']})",
          flush=True)
    emb = _post(port, "/v1/embeddings", {"input": ["the quick brown fox", "pack my box"]},
                timeout)
    out["embeddings"] = [d["embedding"] for d in emb["data"]]
    print(f"  /v1/embeddings: {len(out['embeddings'])} vectors of "
          f"{len(out['embeddings'][0])}", flush=True)
    if audio is not None:
        body, ctype = _wav_form(audio, audio_rate)
        with _request(port, "/v1/audio/transcriptions", body, ctype, timeout) as r:
            out["transcription"] = json.loads(r.read())["text"]
        print(f"  /v1/audio/transcriptions: {out['transcription'][:60]!r}", flush=True)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=timeout) as r:
        metrics = r.read().decode()
    out["metrics"] = dict(line.rsplit(" ", 1) for line in metrics.splitlines()
                          if line and not line.startswith("#"))
    m = out["metrics"]
    print(f"  /metrics: {m['mop_requests_completed_total']} requests, "
          f"{m['mop_tokens_generated_total']} tokens, {m['mop_engine_steps_total']} engine "
          f"steps, TTFT count {m.get('mop_ttft_seconds_count')}, TPOT count "
          f"{m.get('mop_tpot_seconds_count')}", flush=True)
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--quant", choices=["none", "int8", "int4"], default="none")
    ap.add_argument("--spec", action="store_true",
                    help="serve with speculative decoding (a 2-layer draft)")
    ap.add_argument("--prefix_cache", type=int, default=4,
                    help="prefix-cache LRU entries (0 disables)")
    ap.add_argument("--clients", type=int, default=3, help="concurrent text clients")
    ap.add_argument("--keep-serving", action="store_true",
                    help="stay up after the self-test (Ctrl-C or SIGTERM to stop)")
    ap.add_argument("--device", default=None, help="default: the GPU")
    return ap


def run(args, whisper_engine=None, whisper_tokenizer=None,
        audio: Optional[np.ndarray] = None) -> dict:
    """Train, serve and self-test by ``args`` (``_parser``'s); a Whisper
    engine, its tokenizer and a clip add ``/v1/audio/transcriptions`` to the
    test. Returns the self-test's answers, the loss, and whether the drain
    finished every request (``drained``)."""
    device = resolve_device(args.device)
    print("training byte-BPE tokenizer...", flush=True)
    tok = ByteBPETokenizer.train(CORPUS, vocab_size=320)
    data = np.asarray(tok.encode(CORPUS), np.int64)
    print(f"vocab {tok.vocab_size}, corpus {len(CORPUS)} chars -> {data.size} tokens",
          flush=True)
    print(f"training the target LM ({args.steps} steps)...", flush=True)
    model, loss = train_lm(4, 128, 4, args.steps, 0, tok.vocab_size, data, device)
    print(f"target loss {loss:.3f}", flush=True)
    params = decode_params(model)
    if args.quant != "none":
        params = quantize_params(params, bits=8 if args.quant == "int8" else 4)
        stored, fp32 = quantized_bytes(params)
        print(f"{args.quant} weights: {stored / 1e6:.2f} MB stored "
              f"(fp32 would be {fp32 / 1e6:.2f} MB)", flush=True)
    if args.spec:
        draft, dloss = train_lm(2, 64, 2, args.steps, 1, tok.vocab_size, data, device)
        print(f"draft loss {dloss:.3f}", flush=True)
        eng = SpecDecodeEngine(model, params, draft, decode_params(draft),
                               max_batch=args.max_batch, gamma=4,
                               prefix_cache_entries=args.prefix_cache,
                               cuda_graph=device.type == "cuda")
    else:
        eng = DecodeEngine(model, params, max_batch=args.max_batch,
                           prefix_cache_entries=args.prefix_cache,
                           cuda_graph=device.type == "cuda")
    srv = ServingServer(eng, port=args.port, tokenizer=tok, whisper_engine=whisper_engine,
                        whisper_tokenizer=whisper_tokenizer)
    srv.start()
    print(f"serving on http://127.0.0.1:{srv.port}  (POST /generate with 'text' or "
          "'prompt', GET /health)", flush=True)
    try:
        out = self_test(srv, args.clients, audio=audio)
        if args.keep_serving:
            srv.install_drain_handler(timeout=30.0)
            print("serving until Ctrl-C (SIGTERM drains gracefully)...", flush=True)
            try:
                srv.wait_drained()
            except KeyboardInterrupt:
                pass
        out["drained"] = srv.drain(timeout=30.0) if srv._running else True
    finally:
        if srv._running:
            srv.stop()
    out["loss"] = loss
    out["engine"] = eng
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
