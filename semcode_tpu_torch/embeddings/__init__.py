"""Embedding providers: on-device hashing plus optional remote HTTP providers.

Replaces the reference's LangChain provider factory
(reference src/semcode/embeddings/providers.py:21-104) with a plain
duck-typed protocol: every provider exposes ``embed_documents(texts)`` and
``embed_query(text)``, matching the call sites the reference uses
(indexer.py:150, rag/pipeline.py:171-175).
"""

from .providers import EmbeddingPayload, EmbeddingProviderFactory

__all__ = ["EmbeddingPayload", "EmbeddingProviderFactory"]
