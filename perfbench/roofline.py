"""The least device time an IVF_FLAT search needs, from shapes alone.

The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), copied here so that a change to the program cannot move
them (the bf16 peak is the model cells', ``model.mfu``). The work does not
depend on the route or kernel the program takes: a search of ``Q`` queries
that probes ``U`` distinct clusters needs

- bytes, each read or written once: the centroids (nlist x d x 4), the
  queries (Q x d x 4), the stored int8 rows of the ``U`` probed clusters
  (``U`` x rows / nlist x d), the rescore rows of the Q x k answers (f32:
  d x 4 bytes a row; the two-level int8 residual tier: d + 4), and the
  answers (Q x k x (4 + 8): f32 scores and int64 ids);
- int8 operations: 2 x Q x (nlist + nprobe x rows / nlist) x d.

The least time is the larger of bytes over the bandwidth and operations
over the int8 peak; at these shapes the bytes bound it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 989.4e12
PEAK_POWER_W = 700.0

# bytes a rescore row takes, by the index's rescore tier
RESCORE_ROW_BYTES = {"f32": lambda d: 4 * d, "residual": lambda d: d + 4,
                     "none": lambda d: 0}


def search_bytes(cfg: dict, q: int, k: int, probed: int) -> float:
    """Bytes a search of ``q`` queries probing ``probed`` distinct clusters
    needs (see the module's docstring)."""
    d, n, nlist = int(cfg["dim"]), int(cfg["rows"]), int(cfg["index"]["nlist"])
    rescore = RESCORE_ROW_BYTES[cfg["rescore_tier"]](d)
    return (nlist * d * 4 + q * d * 4 + probed * (n / nlist) * d
            + q * k * rescore + q * k * 12)


def search_ops(cfg: dict, q: int, nprobe: int) -> float:
    """int8 operations a search of ``q`` queries at ``nprobe`` needs."""
    d, n, nlist = int(cfg["dim"]), int(cfg["rows"]), int(cfg["index"]["nlist"])
    return 2.0 * q * (nlist + nprobe * n / nlist) * d


def search_seconds(cfg: dict, q: int, k: int, nprobe: int, probed: int) -> float:
    """The least device time of one such search, in seconds."""
    return max(search_bytes(cfg, q, k, probed) / HBM_BYTES_PER_S,
               search_ops(cfg, q, nprobe) / INT8_OPS_PER_S)
