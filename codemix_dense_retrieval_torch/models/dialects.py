"""Encoder family dialects: per-model prompt prefixes and pooling.

The family is detected by name substring; queries and documents may get
family-specific prefixes before tokenization.
"""

from __future__ import annotations

E5_INSTRUCT_QUERY_PREFIX = "Instruct: Retrieve relevant passages.\nQuery: "
E5_QUERY_PREFIX = "query: "
E5_PASSAGE_PREFIX = "passage: "
QWEN3_QUERY_PREFIX = (
    "Instruct: Given a web search query, retrieve relevant passages that "
    "answer the query\nQuery: "
)


def detect_encoder_family(encoder: str) -> str:
    name = encoder.lower()
    if "jina-embeddings-v3" in name or "jina-embedding-v3" in name:
        return "jina-v3"
    if "qwen3-embedding" in name:
        return "qwen3"
    if "kimi-linear" in name:
        return "kimi-linear"
    if "moonlight" in name or "deepseek-v3" in name or "kimi-k2" in name:
        return "deepseek-v3"
    if "e5" in name and "instruct" in name:
        return "e5-instruct"
    if "e5" in name:
        return "e5"
    if "gte-" in name or "/gte" in name:
        return "gte"
    return "default"


def query_prefix(encoder: str) -> str:
    family = detect_encoder_family(encoder)
    if family == "e5-instruct":
        return E5_INSTRUCT_QUERY_PREFIX
    if family == "e5":
        return E5_QUERY_PREFIX
    if family == "qwen3":
        return QWEN3_QUERY_PREFIX
    return ""


def doc_prefix(encoder: str) -> str:
    family = detect_encoder_family(encoder)
    if family == "e5":
        return E5_PASSAGE_PREFIX
    return ""


def default_pooling(encoder: str) -> str:
    family = detect_encoder_family(encoder)
    if family in ("qwen3", "deepseek-v3", "kimi-linear"):
        return "last_token"
    if family in ("e5", "e5-instruct"):
        return "mean"
    return "cls"  # bge-m3, jina-v3
