"""Device vector index: the flat exact-scan index and the store facade.

Counterpart of ``semcode_tpu/index`` without IVF (not ported yet):

- ``FlatIndex``: exact scan — int8/bf16/f32 storage, fused f32 rescore,
  routed through the fused top-2 kernel (``scan_impl="pallas"``) or the
  full-matrix route.
- ``VectorStore``: the host-side facade with connect/upsert_embeddings/
  search, the device BM25 rerank and snapshot persistence.
"""

from .flat import FlatIndex
from .store import SearchHit, VectorStore

__all__ = ["FlatIndex", "VectorStore", "SearchHit"]
