"""Teacher-forced prompt scoring (OpenAI ``echo`` + ``logprobs``), the port
of ``mop_tpu/serving/scoring.py``.

``prompt_logprobs`` gives each prompt token the log-probability the decoder
assigns it under incremental-decode semantics: one ``decode_chunk_rows``
pass from an empty one-row cache, which is the composition of per-token
``decode_step_rows`` calls (each position's score rows standardize over its
own live prefix). That is how the engine scores the tokens it generates, so
echoed-prompt and completion logprobs sit on one scale. The log-softmax,
the chosen token's logprob and the top-k are taken on the device; the host
copy is O(T k). The prompt is padded to a power of two (at least 8), as in
JAX; the pads come after every scored position and do not reach it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.beam import _top_k
from ..models.generate import decode_chunk_rows, decode_params, init_decode_cache, model_n_views
from .engine import _to_host


def prompt_logprobs(model, params: Optional[dict], prompt_ids,
                    n_top: int = 0) -> Tuple[List[Optional[float]], List[list]]:
    """Score ``prompt_ids`` under the model's decode (prefix) semantics.

    Returns ``(lps, tops)``, each of ``len(prompt_ids)``: ``lps[0] is None``
    and ``tops[0] == []`` (nothing conditions the first token); ``lps[j]`` is
    ``log P(prompt[j] | prompt[:j])`` and ``tops[j]`` the ``n_top`` most
    likely ``(token_id, logprob)`` at that position. ``params``:
    ``decode_params(model)`` or its quantized form (None: the model's own);
    the pass runs on their device."""
    t0 = len(prompt_ids)
    if t0 < 1:
        raise ValueError("empty prompt")
    block = model.config.block_size
    if t0 > block:
        raise ValueError(f"prompt length {t0} exceeds the context window ({block})")
    params = decode_params(model) if params is None else params
    dev = params["params"]["wte"]["embedding"].device
    t_pad = 8
    while t_pad < t0:
        t_pad *= 2
    t_pad = min(t_pad, block)
    tail = torch.zeros((1, t_pad), dtype=torch.long, device=dev)
    tail[0, :t0] = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=dev)
    with torch.no_grad():
        cache = init_decode_cache(model.config, 1, n_views=model_n_views(model), device=dev)
        logits, _ = decode_chunk_rows(model, params, cache, tail,
                                      torch.zeros((1,), dtype=torch.long, device=dev))
        logp = torch.log_softmax(logits[0].float(), -1)[:-1]  # position j-1 scores token j
        chosen = logp.gather(-1, tail[0, 1:, None])[:, 0]
        tv, ti = _top_k(logp, max(n_top, 1))
    chosen, tv, ti = _to_host(chosen, tv, ti)
    lps: List[Optional[float]] = [None]
    tops: List[list] = [[]]
    for j in range(1, t0):
        lps.append(float(chosen[j - 1]))
        tops.append([(int(t), float(v)) for t, v in zip(ti[j - 1], tv[j - 1])][:n_top])
    return lps, tops
