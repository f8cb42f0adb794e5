"""Meshes, the sharded top-k merge, and multi-process init for the engine."""

from .distributed import maybe_init_distributed, multihost_mesh_shape
from .mesh import (
    Mesh,
    get_mesh,
    hierarchical_topk_merge,
    linear_rank,
    make_mesh,
    row_axes,
)

__all__ = [
    "Mesh",
    "get_mesh",
    "hierarchical_topk_merge",
    "linear_rank",
    "make_mesh",
    "maybe_init_distributed",
    "multihost_mesh_shape",
    "row_axes",
]
