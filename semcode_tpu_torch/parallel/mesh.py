"""Device meshes and the sharded top-k merge for the PyTorch engine.

Counterpart of ``semcode_tpu/parallel/mesh.py``. A mesh is a small value:
an array of ``torch.device``s with a shape, plus ``axis_names``. The vector
corpus is row-sharded over every axis but ``"model"`` (``row_axes``):

- the inner axes (``"data"``) hold the shards of this process, each a row
  range read on its own device;
- an outer ``"dcn"`` axis spans processes joined by a ``torch.distributed``
  process group (``parallel/distributed.py``).

Shard ``s`` (``linear_rank``, row-major over the row axes) owns global rows
``[s * shard_rows, (s + 1) * shard_rows)``. A search runs its per-shard step
on each local shard in a Python loop and merges the shards' ``(Q, k)``
candidates innermost axis first (``hierarchical_topk_merge``): the local
shards on the first local device, then across processes.

A device may appear in a mesh more than once (``make_mesh(..., devices=
[cuda0] * 4)``): the counterpart of XLA's forced host device count, which
runs several shards on one card or on the CPU.

The trainers (``models/train.py``, ``train_lm.py``) read a ``("data",
"model")`` mesh as a grid: ``device_at(d, m)`` holds data replica ``d``'s
model shard ``m``; the batch splits over ``"data"`` and the weights over
``"model"``.

Each process keeps an index's tensors in their global row layout on its
first local device; a shard reads its own row range of them. On a mesh of
several cards a shard's range is copied to its card once per tensor
(``Mesh.place``), so the whole index lives on the first card and each shard's
rows on its own.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, round_up

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "all_reduce_sum", "get_mesh",
    "hierarchical_topk_merge", "linear_rank", "local_devices", "local_shards",
    "make_mesh", "n_shards", "pad_bucket", "parse_mesh_shape",
    "resolve_mesh", "round_up", "row_axes", "topk_merge",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Devices laid out in a named grid.

    ``devices`` has the whole mesh's shape; in a multi-process run the
    entries another process owns are None. ``process_index`` /
    ``process_count`` are this process's place in the process group."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_index: int = 0, process_count: int = 1):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of shape {devices.shape} needs {devices.ndim} axis "
                f"names, got {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        # id(source tensor) -> (weak reference to it, {(lo, hi, device): copy})
        self._placed: dict = {}
        # local_shards, computed once: every search reads it
        self._local = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_devices(self) -> List[torch.device]:
        return [d for d in self.devices.flat if d is not None]

    @property
    def home(self) -> torch.device:
        """The first local device: where the index tensors and the merged
        results live."""
        return self.local_devices()[0]

    def place(self, t: torch.Tensor, lo: int, hi: int, device: torch.device
              ) -> torch.Tensor:
        """Rows ``[lo, hi)`` of ``t`` on ``device``: a view where ``t``
        already lives there, else a copy made once per source tensor (the
        tensors an index hands to searches are never written in place) and
        dropped with it."""
        if t.device == device:
            return t[lo:hi]
        key = id(t)
        entry = self._placed.get(key)
        if entry is None or entry[0]() is not t:
            entry = (weakref.ref(t), {})
            self._placed[key] = entry
            weakref.finalize(t, self._placed.pop, key, None)
        copies = entry[1]
        got = copies.get((lo, hi, str(device)))
        if got is None:
            got = copies[(lo, hi, str(device))] = t[lo:hi].to(device)
        return got

    # -- a training mesh: ("data", "model") ---------------------------------------

    @property
    def replicas(self) -> int:
        """Data replicas of a training mesh: the size of its ``"data"`` axis
        (1 without one)."""
        return self.shape.get(DATA_AXIS, 1)

    @property
    def model_shards(self) -> int:
        """Model shards of a training mesh: the size of its ``"model"`` axis
        (1 without one)."""
        return self.shape.get(MODEL_AXIS, 1)

    def device_at(self, replica: int, shard: int) -> torch.device:
        """The device of data replica ``replica``'s model shard ``shard``:
        ``devices[replica, shard]`` on a ``("data", "model")`` mesh. A
        training mesh lives in one process and has no other axis longer
        than one (the trainers split the batch over ``"data"`` alone)."""
        if self.process_count > 1 or any(
                size > 1 for ax, size in self.shape.items()
                if ax not in (DATA_AXIS, MODEL_AXIS)):
            raise ValueError(f"{self} is not a one-process (data, model) mesh")
        where = {DATA_AXIS: replica, MODEL_AXIS: shard}
        return self.devices[tuple(where.get(ax, 0) for ax in self.axis_names)]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, process {self.process_index} of "
                f"{self.process_count}, home={self.home})")


def _process_group() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices(device: DeviceLike = None, count: Optional[int] = None
                  ) -> List[torch.device]:
    """This process's devices for a default mesh.

    ``device`` names them as ``resolve_device`` does (CUDA unless asked
    otherwise). A bare ``cuda`` means every local card; ``cuda:i`` that
    card alone. The CPU holds ``count`` shards (default one), as XLA's
    forced host device count lets one host hold several."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(int(count or 1), 1)
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = (DATA_AXIS,),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a mesh; defaults to a 1-D mesh over every local device.

    ``devices`` lists this process's devices (a device may repeat). In a
    multi-process run the mesh spans ``world_size * len(devices)`` entries
    and this process owns the contiguous row-major block at its rank, as
    JAX orders a multi-process device list."""
    rank, world = _process_group()
    if devices is None:
        devs = local_devices(
            None, int(np.prod(shape)) // world if shape else None
        )
    else:
        devs = [_indexed(torch.device(d)) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = (len(devs) * world,)
    shape = tuple(int(s) for s in shape)
    total = int(np.prod(shape))
    if total != len(devs) * world:
        raise ValueError(
            f"mesh shape {shape} does not match {len(devs)} devices"
            + (f" x {world} processes" if world > 1 else "")
        )
    flat = np.empty((total,), dtype=object)
    flat[rank * len(devs):(rank + 1) * len(devs)] = devs
    return Mesh(flat.reshape(shape), axis_names, rank, world)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: mesh devices compare by index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_mesh(mesh: Optional[Mesh] = None, device: DeviceLike = None
                 ) -> Mesh:
    """An index's mesh: ``mesh`` itself, else the default mesh over
    ``device`` (``get_mesh``: every local card for a bare ``cuda``, one
    shard on ``cuda:i`` or the CPU)."""
    if mesh is None:
        return get_mesh("", device=device)
    if device is not None and _indexed(resolve_device(device)) != mesh.home:
        raise ValueError(f"device {device} is not the home of {mesh}")
    return mesh


def parse_mesh_shape(spec: str) -> Optional[Tuple[int, ...]]:
    """Parse ``"8"`` / ``"4x2"`` style mesh shape strings ('' -> None)."""
    spec = spec.strip()
    if not spec:
        return None
    return tuple(int(part) for part in spec.replace("X", "x").split("x"))


def get_mesh(
    shape_spec: str = "",
    axis_names: Tuple[str, ...] = (DATA_AXIS,),
    device: DeviceLike = None,
) -> Mesh:
    """The mesh the engine uses, from ``settings.mesh_shape``.

    Empty means a 1-D mesh over every local device (``local_devices``):
    one shard on a one-card host. A shape whose product is not the device
    count raises, except on the CPU, which holds as many shards as the
    shape asks for."""
    shape = parse_mesh_shape(shape_spec)
    _, world = _process_group()
    n = int(np.prod(shape)) // world if shape is not None else None
    devs = local_devices(device, n)
    return make_mesh(shape, axis_names, devices=devs)


def pad_bucket(n: int, floor: int = 8) -> int:
    """Next power-of-two batch bucket (>= floor). The reference bounds its
    jit shapes with it; here it is the batch the IVF cost model sees."""
    b = floor
    while b < n:
        b *= 2
    return b


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the corpus rows shard over: every axis but ``"model"``
    (reserved for tensor parallelism in training), outermost first."""
    return tuple(ax for ax in mesh.axis_names if ax != MODEL_AXIS)


def n_shards(mesh: Mesh) -> int:
    sizes = mesh.shape
    return int(np.prod([sizes[a] for a in row_axes(mesh)]))


def linear_rank(mesh: Mesh, axes: Tuple[str, ...], position) -> int:
    """The global shard rank of the mesh entry at ``position`` (an index
    per mesh axis): row-major over ``axes``."""
    sizes = mesh.shape
    where = dict(zip(mesh.axis_names, position))
    rank = 0
    for ax in axes:
        rank = rank * sizes[ax] + int(where[ax])
    return rank


def local_shards(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """(rank, device) of every shard this process holds, in rank order.
    Along a ``"model"`` axis the shard is read on its first device."""
    if mesh._local is not None:
        return mesh._local
    axes = row_axes(mesh)
    out = []
    for position in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[position]
        where = dict(zip(mesh.axis_names, position))
        if dev is None or where.get(MODEL_AXIS, 0) != 0:
            continue
        out.append((linear_rank(mesh, axes, position), dev))
    out.sort(key=lambda rd: rd[0])
    mesh._local = out
    return out


def topk_merge(scores: List[torch.Tensor], ids: List[torch.Tensor], k: int):
    """Concatenate candidate sets in order and keep the top ``k``, ties to
    the lowest position (``jax.lax.top_k``'s order)."""
    from ..index.scan import stable_topk

    s = torch.cat(scores, dim=1)
    i = torch.cat(ids, dim=1)
    s, pos = stable_topk(s, min(k, s.shape[1]))
    return s, torch.gather(i, 1, pos)


def hierarchical_topk_merge(parts, k: int, mesh: Mesh):
    """Merge per-shard ``(Q, k')`` candidates across the mesh, this
    process's shards first.

    ``parts``: this process's shards' (scores, ids) in rank order, each
    sorted by score descending (as ``stable_topk`` returns them). The local
    parts are gathered onto the first local device and merged by one top
    ``k`` over their concatenation (one part keeps its first ``k``); then the
    process's result is all-gathered across the process group and merged
    once more. A process's shards are one contiguous run of ranks and ties
    go to the lowest position at every step, so the result equals the
    reference's all-gather + ``lax.top_k`` per row axis, innermost first,
    bit for bit. Returns replicated tensors on the first local device."""
    home = mesh.home
    if len(parts) == 1:
        s, i = parts[0]
        s, i = s[:, :k].to(home), i[:, :k].to(home)
    else:
        s, i = topk_merge([p[0].to(home) for p in parts],
                          [p[1].to(home) for p in parts], k)
    if mesh.process_count > 1:
        from .distributed import all_gather

        ss, ii = all_gather(s), all_gather(i)
        s, i = topk_merge(ss, ii, k)
    return s, i


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the process group (the reference's psum across the
    outer axis); the identity in a single-process run."""
    if mesh.process_count <= 1:
        return x
    from .distributed import all_reduce_sum as _sum

    return _sum(x)
