"""The port's serving demo, ``python -m mop_tpu_torch.cli.serve_http``, on
the CPU at a few training steps: it trains the byte-BPE tokenizer and the
LM, serves them on loopback, answers concurrent text clients, a stream, an
OpenAI completion and an embeddings request, reports the TTFT / TPOT
histograms and drains; int8 weights serve the same way; without
``--device`` it asks for the GPU."""

import pytest
import torch

from mop_tpu_torch.cli import serve_http

from _torch_serving_common import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_demo_serves_and_drains(quant):
    out = serve_http.main(["--device", "cpu", "--steps", "3", "--clients", "4",
                           "--quant", quant])
    assert out["drained"] is True and not out["engine"].n_active
    assert len(out["texts"]) == 4 and all(isinstance(t, str) and t for t in out["texts"])
    assert out["completion"]["finish_reason"] in ("stop", "length")
    assert len(out["embeddings"]) == 2 and len(out["embeddings"][0]) == 128
    m = out["metrics"]
    assert int(m["mop_requests_completed_total"]) >= 6
    assert int(m["mop_ttft_seconds_count"]) >= 6 and "mop_tpot_seconds_sum" in m


def test_demo_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # speculative serving too
        serve_http.main(["--spec", "--steps", "1"])
