"""Device selection and shape helpers for the PyTorch engine.

The JAX package shards the corpus over a device mesh
(``semcode_tpu/parallel/mesh.py``); this engine targets ONE CUDA device, so
there is no mesh and no shard_map: every per-shard merge of the reference
reduces to the identity. What remains is device choice (CUDA unless the
caller asks for the CPU, never a silent CPU fallback), ``round_up`` and the
storage dtype maps. The reference's ``pad_bucket`` bounded jit recompiles
by bucketing batch sizes; eager PyTorch has no compile per shape, so it is
not carried over.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DEVICE_ENV = "SEMCODE_TORCH_DEVICE"

DeviceLike = Union[str, torch.device, None]

STORAGE_DTYPES = {
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``device`` (or ``$SEMCODE_TORCH_DEVICE`` when it is None) names it;
    the default is ``cuda``. A CUDA request without a usable card raises:
    the engine never drops to the CPU unless asked to."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "semcode_tpu_torch runs on CUDA by default and no CUDA device is "
            f"available; pass device='cpu' (or set {DEVICE_ENV}=cpu) to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def storage_dtype(name: str) -> torch.dtype:
    """Index storage dtype by settings name (bfloat16 for unknown names,
    as ``semcode_tpu/index/flat.py::_storage_dtype``)."""
    return STORAGE_DTYPES.get(name, torch.bfloat16)


def storage_name(dtype: torch.dtype) -> str:
    return {torch.int8: "int8", torch.bfloat16: "bfloat16"}.get(dtype, "float32")


def round_up(value: int, multiple: int) -> int:
    if multiple <= 0:
        return value
    return ((value + multiple - 1) // multiple) * multiple

