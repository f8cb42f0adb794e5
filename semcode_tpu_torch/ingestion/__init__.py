"""Repository ingestion: workspace copies, ignore patterns, language detection."""

from .manager import (
    DEFAULT_IGNORE_PATTERNS,
    RepositoryIngestionManager,
    RepositoryMetadata,
)

__all__ = [
    "DEFAULT_IGNORE_PATTERNS",
    "RepositoryIngestionManager",
    "RepositoryMetadata",
]
