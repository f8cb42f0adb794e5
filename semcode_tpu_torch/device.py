"""Device selection and shape helpers for the PyTorch engine.

Device choice: CUDA unless the caller asks for the CPU, never a silent CPU
fallback. The mesh the engine shards the corpus over, and the reference's
``pad_bucket``, live in ``parallel/mesh.py``; here are ``round_up``, the
storage dtype maps, the true-f32 matmul and the card's multiprocessor
count.
"""

from __future__ import annotations

import functools
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


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in true float32: TF32 is held off for the call, whatever
    the process-wide setting (a TF32 product keeps ~3 decimal digits, enough
    to flip a nearest-centroid argmin or a probe choice). The flag is
    process-wide: it is written only when a caller has turned TF32 on."""
    prev = torch.backends.cuda.matmul.allow_tf32
    if not prev or not a.is_cuda:
        return a @ b
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index``: the kernels' persistent
    grids."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def round_up(value: int, multiple: int) -> int:
    if multiple <= 0:
        return value
    return ((value + multiple - 1) // multiple) * multiple

