"""Host-side persistent state: repository registry (index snapshots live in
``semcode_tpu_torch.index.store``)."""

from .registry import RepositoryRecord, RepositoryRegistry

__all__ = ["RepositoryRecord", "RepositoryRegistry"]
