"""Structural (duck) types for the orchestration seams.

The host layers are wired by composition — the API takes "an indexer", the
pipeline takes "a vector store" — and tests/extensions substitute stubs.
These Protocols document the minimum surface each seam actually requires
(and keep runtime type checking honest: the concrete classes satisfy them
structurally, so do stubs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class SearcherLike(Protocol):
    """Anything the RAG pipeline can retrieve from."""

    def search(
        self,
        vector: Any,
        *,
        top_k: Any = ...,
        filters: Optional[Dict[str, Any]] = ...,
    ) -> List[Any]:
        ...


@runtime_checkable
class UpsertStoreLike(Protocol):
    """Anything the indexer service can write embeddings into."""

    def connect(self) -> None:
        ...

    def upsert_embeddings(self, payloads: Any, **kwargs: Any) -> int:
        ...


@runtime_checkable
class IndexerLike(Protocol):
    """Anything the API can drive ingestion through."""

    registry: Any
    ingestion_manager: Any
    vector_store: Any

    def index_repository(self, *args: Any, **kwargs: Any) -> Any:
        ...


@runtime_checkable
class QueryPipelineLike(Protocol):
    """Anything the API can answer questions through."""

    def query(
        self,
        question: str,
        *,
        top_k: Any = ...,
        filters: Optional[Dict[str, Any]] = ...,
    ) -> Dict[str, Any]:
        ...
