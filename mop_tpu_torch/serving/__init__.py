"""The serving layer of the port: continuous-batching decode over a slot
pool (``DecodeEngine``, with per-row LoRA, guided decoding, beams, logprobs,
the prefix cache and chunked prefill), prompt scoring, embeddings, Whisper
transcription serving and the OpenAI-compatible HTTP server, the
counterpart of ``mop_tpu.serving``. Not ported yet: the paged and
speculative engines, ``export`` and tensor-parallel serving."""

from .constrain import TokenDFA, choices, token_set
from .embeddings import EmbeddingModel, embeddings_body, parse_embedding_input
from .json_schema import json_schema_to_dfa, json_schema_to_regex
from .regex_dfa import regex_to_dfa
from .scoring import prompt_logprobs
from .engine import DecodeEngine, decode_chunk_rows, decode_step_rows, lora_params_view
from .http import ServingServer
from .whisper import WhisperServingEngine, whisper_decode_step_rows

__all__ = ["DecodeEngine", "EmbeddingModel", "ServingServer", "TokenDFA",
           "WhisperServingEngine", "choices", "decode_chunk_rows", "decode_step_rows",
           "embeddings_body", "json_schema_to_dfa", "json_schema_to_regex",
           "lora_params_view", "parse_embedding_input", "prompt_logprobs", "regex_to_dfa",
           "token_set", "whisper_decode_step_rows"]
