"""Multi-process runtime for the PyTorch engine.

Counterpart of ``semcode_tpu/parallel/distributed.py``: one process per
host (or per card), one ``torch.distributed`` process group, and a 2-level
``("dcn", "data")`` mesh over the processes' devices. Corpus rows shard over
both axes and the per-shard top-k results merge locally first
(``parallel/mesh.py::hierarchical_topk_merge``), so only ``(Q, k)``
candidate sets cross processes.

Configuration (settings or env), as the reference's:

    [mesh]
    coordinator = "10.0.0.1:8476"   # SEMCODE_MESH_COORDINATOR
    num_processes = 4                # SEMCODE_MESH_NUM_PROCESSES
    process_id = 0                   # SEMCODE_MESH_PROCESS_ID

The coordinator is the rank-0 process's ``host:port``; the group is
initialized at ``tcp://{coordinator}``. The reference can instead discover
all three on a TPU pod; nothing tells a process of a GPU cluster, so here
``num_processes > 1`` without a coordinator raises.

The backend follows the devices: NCCL when each process owns its own
card(s), Gloo on the CPU. A test rig whose processes share one card (NCCL
refuses two ranks on one device) passes ``backend="gloo"``; Gloo's
collectives then stage the small candidate sets through the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..logger import get_logger

log = get_logger("parallel.distributed")

_initialized = False


def pick_backend(device: DeviceLike = None, backend: Optional[str] = None
                 ) -> str:
    """``backend``, else NCCL for a CUDA device and Gloo for the CPU."""
    if backend:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown process-group backend: {backend}")
        return backend
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def maybe_init_distributed(config=None, *, device: DeviceLike = None,
                           backend: Optional[str] = None) -> bool:
    """Initialize the process group when multi-process settings are present.

    Idempotent; returns True if the group is (now) active. Does nothing in
    a single-process run (``mesh_num_processes <= 1``)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    if config is None:
        from ..settings import settings as config  # noqa: PLC0415

    num = int(getattr(config, "mesh_num_processes", 1) or 1)
    if num <= 1:
        return False
    coordinator = getattr(config, "mesh_coordinator", None)
    if not coordinator:
        raise ValueError(
            "mesh_num_processes > 1 needs mesh_coordinator (host:port of "
            "process 0): there is no cluster discovery on this platform"
        )
    rank = int(getattr(config, "mesh_process_id", 0) or 0)
    chosen = pick_backend(device, backend)
    dist.init_process_group(
        backend=chosen,
        init_method=f"tcp://{coordinator}",
        world_size=num,
        rank=rank,
    )
    _initialized = True
    log.info(
        "torch_distributed_initialized",
        backend=chosen,
        processes=dist.get_world_size(),
        process_index=dist.get_rank(),
    )
    return True


def shutdown() -> None:
    """Destroy the process group (tests and workers call it in finally)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def multihost_mesh_shape(config=None, device: DeviceLike = None
                         ) -> Optional[Tuple[Tuple[int, int], Tuple[str, str]]]:
    """The 2-level mesh for a multi-process run: processes x local devices.

    Returns ((n_processes, devices_per_process), ("dcn", "data")), or None
    when the run is single-process (callers then use the default 1-D data
    mesh)."""
    from .mesh import local_devices

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    return ((dist.get_world_size(), len(local_devices(device))),
            ("dcn", "data"))


def _staged(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``x``, in rank order, on ``x``'s device."""
    src = x.cpu() if _staged(x) else x.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(x.device) for o in out]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, on ``x``'s device."""
    buf = x.cpu() if _staged(x) else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(x.device)
