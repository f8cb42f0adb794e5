"""Device vector indexes and the store facade.

Counterpart of ``semcode_tpu/index``:

- ``FlatIndex``: exact scan — int8/bf16/f32 storage, fused f32 rescore,
  routed through the fused top-2 kernel (``scan_impl="pallas"``) or the
  full-matrix route.
- ``IVFIndex``: k-means coarse quantizer over capacity-padded cluster
  blocks, probed through the IVF kernel (``ops/ivf_scan.py``) or the
  gather-scan route, with an exact mode over its flat mirror.
- ``VectorStore``: the host-side facade with connect/upsert_embeddings/
  search, the device BM25 rerank and snapshot persistence.
"""

from .flat import FlatIndex
from .ivf import IVFIndex
from .store import SearchHit, VectorStore

__all__ = ["FlatIndex", "IVFIndex", "VectorStore", "SearchHit"]
