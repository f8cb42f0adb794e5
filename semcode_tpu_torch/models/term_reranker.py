"""Learned term-embedding table for the rerank's MaxSim channel.

Counterpart of ``load_table``/``default_asset_path`` in
``semcode_tpu/models/term_reranker.py`` (281-293). Training the table stays
in the JAX package; the shipped asset is read from its file, by path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def load_table(path) -> Optional[np.ndarray]:
    """-> (B, D) f32 unit-row table, or None when the file is absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        table = np.asarray(z["table"], dtype=np.float32)
    norm = np.linalg.norm(table, axis=1, keepdims=True)
    return table / np.maximum(norm, 1e-9)


def default_asset_path() -> Path:
    """The table shipped with the JAX package (a data file, read by path)."""
    root = Path(__file__).resolve().parents[2]
    return root / "semcode_tpu" / "assets" / "term-reranker.npz"
