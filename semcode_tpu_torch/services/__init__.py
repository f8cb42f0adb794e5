"""Pipeline orchestration services."""

from .indexer import IndexerService, IndexingCallbacks, IndexingResult

__all__ = ["IndexerService", "IndexingCallbacks", "IndexingResult"]
