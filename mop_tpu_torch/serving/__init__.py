"""The serving layer of the port: continuous-batching decode over a slot
pool (``DecodeEngine``, with per-row LoRA, guided decoding, beams, logprobs,
the prefix cache and chunked prefill), over a paged pool with preemption
(``PagedDecodeEngine``) and with speculative decoding (``SpecDecodeEngine``),
prompt scoring, embeddings, Whisper transcription serving, the
OpenAI-compatible HTTP server and model export over ``torch.export``, the
counterpart of ``mop_tpu.serving``. A tensor-parallel model serves in the
dense, paged and speculative engines, each process holding its heads of the
pools (``cache_sharding``)."""

from .constrain import TokenDFA, choices, token_set
from .embeddings import EmbeddingModel, embeddings_body, parse_embedding_input
from .json_schema import json_schema_to_dfa, json_schema_to_regex
from .regex_dfa import regex_to_dfa
from .scoring import prompt_logprobs
from .engine import (DecodeEngine, SpecDecodeEngine, decode_chunk_rows, decode_step_rows,
                     lora_params_view)
from .export import export_apply, export_fn, load_exported, save_exported
from .http import ServingServer
from .paged import PagedDecodeEngine, init_paged_pool, paged_decode_step_rows
from .whisper import WhisperServingEngine, whisper_decode_step_rows

__all__ = ["DecodeEngine", "EmbeddingModel", "PagedDecodeEngine", "ServingServer",
           "SpecDecodeEngine", "TokenDFA", "WhisperServingEngine", "choices",
           "decode_chunk_rows", "decode_step_rows", "embeddings_body", "export_apply",
           "export_fn", "init_paged_pool", "json_schema_to_dfa", "json_schema_to_regex",
           "load_exported", "lora_params_view", "paged_decode_step_rows",
           "parse_embedding_input", "prompt_logprobs", "regex_to_dfa", "save_exported",
           "token_set", "whisper_decode_step_rows"]
