"""Device meshes and the sharded top-k merge for the PyTorch engine.

Counterpart of ``semcode_tpu/parallel/mesh.py``. A mesh is a small value:
an array of ``torch.device``s with a shape, plus ``axis_names``. The vector
corpus is row-sharded over every axis but ``"model"`` (``row_axes``):

- the inner axes (``"data"``) hold the shards of this process, each a row
  range held on its own device;
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

An index's row-indexed tensors are ``ShardedRows``: one tensor per shard,
holding that shard's rows (or clusters) on that shard's device, the
counterpart of an array under ``NamedSharding(mesh, P(row_axes, ...))``. A
process allocates its own shards' tensors and no others; what is
replicated (centroids, queries, merged results) stays on the first local
device. A write goes to the shards that own its rows. Where a writer needs
rows another shard holds (a re-pack, a growth that moves shard boundaries,
a snapshot), ``ShardedRows.take`` gathers them: each process gives the rows
it owns and zeros for the rest, and the parts are summed across processes
as raw bytes, so the owner's bits come through exactly.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, round_up

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "Route", "ShardedRows",
    "all_reduce_sum",
    "get_mesh",
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
        # local_shards, computed once: every search reads it
        self._local = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_devices(self) -> List[torch.device]:
        return [d for d in self.devices.flat if d is not None]

    @property
    def home(self) -> torch.device:
        """The first local device: where an index's replicated tensors and
        the merged results live."""
        return self.local_devices()[0]

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
    sizes = mesh.shape  # Python ints: math.prod keeps numpy off every search
    return math.prod(sizes[a] for a in row_axes(mesh))


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


# rows per step of a growth's gather across processes: bounds its
# transient memory
_TAKE_ROWS = 131072


def _sum_owned(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over processes of ``x``, where every entry is zero in every
    process but its owner's: summed as raw bytes (int32 words), so the
    owner's bits come through exactly whatever the dtype (-0.0, f16, bool).
    The identity in a single-process run."""
    if mesh.process_count <= 1:
        return x
    from .distributed import all_reduce_sum as _sum

    flat = x.contiguous().view(-1)
    raw = flat.view(torch.uint8)
    pad = -raw.numel() % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros((pad,))])
    raw = _sum(raw.view(torch.int32)).view(torch.uint8)
    return raw[: flat.numel() * flat.element_size()].view(x.dtype).view(x.shape)


class ShardedRows:
    """One row-indexed tensor of an index, split by shard.

    Shard ``r`` of ``mesh`` holds global rows ``[r * shard_rows, (r + 1) *
    shard_rows)`` in a tensor of its own on its own device (``local_shards``);
    a process holds its own shards' tensors and no others. Writers never
    edit a tensor a reader may hold unless asked to (``inplace``): the
    mutators return a new container that shares the untouched shards'
    tensors, so an index swaps whole versions. ``shape`` and ``dtype`` are
    the global array's."""

    __slots__ = ("mesh", "rows", "parts")

    def __init__(self, mesh: Mesh, rows: int, parts: Dict[int, torch.Tensor]):
        self.mesh = mesh
        self.rows = int(rows)
        self.parts = parts

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, mesh: Mesh, rows: int, make) -> "ShardedRows":
        """``make(lo, hi, device)`` gives each local shard's tensor of rows
        ``[lo, hi)``."""
        n = n_shards(mesh)
        if rows % n:
            raise ValueError(f"{rows} rows do not split over {n} shards")
        sr = rows // n
        return cls(mesh, rows, {r: make(r * sr, (r + 1) * sr, dev)
                                for r, dev in local_shards(mesh)})

    @classmethod
    def full(cls, mesh: Mesh, rows: int, tail: Tuple[int, ...], dtype,
             fill=0) -> "ShardedRows":
        return cls.build(mesh, rows, lambda lo, hi, dev: torch.full(
            (hi - lo,) + tuple(tail), fill, dtype=dtype, device=dev))

    @classmethod
    def from_host(cls, mesh: Mesh, arr) -> "ShardedRows":
        """Split an array in global row order (numpy or a tensor): each local
        shard copies its own range, and no other rows."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        return cls.build(mesh, arr.shape[0],
                         lambda lo, hi, dev: arr[lo:hi].to(dev, copy=True))

    @classmethod
    def of(cls, mesh: Mesh, t) -> "ShardedRows":
        """``t`` itself if it is split already; a tensor in global row order
        is split by views of each shard's range where it already lies on the
        shard's device, else by copies. The index's own callers pass
        ``ShardedRows``: a tensor comes only from callers that hold one
        table in global order, as the parity tests do, and one held off the
        shards' devices is copied on every call."""
        if isinstance(t, ShardedRows):
            return t
        return cls.build(mesh, t.shape[0], lambda lo, hi, dev: t[lo:hi].to(dev))

    # -- reading -----------------------------------------------------------

    @property
    def shard_rows(self) -> int:
        return self.rows // n_shards(self.mesh)

    def shard(self, rank: int) -> torch.Tensor:
        """Shard ``rank``'s tensor (a shard of this process)."""
        return self.parts[rank]

    def _any(self) -> torch.Tensor:
        return next(iter(self.parts.values()))

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.rows,) + tuple(self._any().shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._any().dtype

    def mine(self, rows: np.ndarray) -> np.ndarray:
        """Mask of the ``rows`` this process's shards own."""
        return np.isin(np.asarray(rows) // self.shard_rows, list(self.parts))

    def route(self, rows, cols=None) -> "Route":
        """``rows`` (global ids, int numpy; with ``cols``, one column each)
        split by owner shard, to pass to every read or write of a container
        of this row count that touches the same rows."""
        return Route(self.mesh, self.rows, rows, cols)

    def _route(self, rows, cols=None) -> "Route":
        if not isinstance(rows, Route):
            return self.route(rows, cols)
        if rows.rows != self.rows:
            raise ValueError(f"a route over {rows.rows} rows used on {self!r}")
        return rows

    def take(self, rows) -> torch.Tensor:
        """Rows by global id (int numpy, each in ``[0, rows)``, or their
        ``route``) in the given order, on the home device. Every process
        gets all of them (``_sum_owned``), so in a multi-process run every
        process calls it with the same ``rows``."""
        route = self._route(rows)
        home = self.mesh.home
        part0 = self._any()
        out = torch.zeros((route.n,) + tuple(part0.shape[1:]),
                          dtype=part0.dtype, device=home)
        for i, (r, _, at) in enumerate(route.parts):
            out.index_copy_(0, route.positions(i, home),
                            self.parts[r][at[0]].to(home))
        return _sum_owned(out, self.mesh)

    # -- writing -----------------------------------------------------------

    def set_rows(self, rows, vals: torch.Tensor, cols=None,
                 inplace: bool = False) -> "ShardedRows":
        """``self[rows] = vals`` (``self[rows, cols]`` with ``cols``; ``rows``
        may be their ``route``), each row written by the shard that owns
        it; rows another process owns are skipped. ``vals`` lies on any
        device (the home device saves an upload a shard)."""
        route = self._route(rows, cols)
        parts = dict(self.parts)
        for i, (r, _, at) in enumerate(route.parts):
            part = parts[r]
            v = route.pick(i, vals).to(part.device, part.dtype)
            if len(at) == 1:
                parts[r] = (part.index_copy_(0, at[0], v) if inplace
                            else part.index_copy(0, at[0], v))
            else:
                parts[r] = (part.index_put_(at, v) if inplace
                            else part.index_put(at, v))
        return ShardedRows(self.mesh, self.rows, parts)

    def fill_rows(self, rows, value, cols=None,
                  inplace: bool = False) -> "ShardedRows":
        """``self[rows] = value`` (``self[rows, cols]`` with ``cols``), by
        the owner shards."""
        route = self._route(rows, cols)
        parts = dict(self.parts)
        for r, _, at in route.parts:
            part = parts[r]
            if len(at) == 1:
                parts[r] = (part.index_fill_(0, at[0], value) if inplace
                            else part.index_fill(0, at[0], value))
            else:
                v = part.new_full((), value)
                parts[r] = (part.index_put_(at, v) if inplace
                            else part.index_put(at, v))
        return ShardedRows(self.mesh, self.rows, parts)

    def grow(self, rows: int) -> "ShardedRows":
        """The same rows under a larger row count, new rows zero. Shard
        boundaries move with the count, so rows pass between shards: one
        process copies each overlap of an old and a new shard's range (a
        copy a field on one shard); across processes they pass through
        ``take`` in steps of ``_TAKE_ROWS`` rows (every process calls it),
        which on one process would cost a mirror's growth tens of times
        more (PERF.md §6)."""
        new = ShardedRows.full(self.mesh, rows, self.shape[1:], self.dtype)
        sr, nsr = self.shard_rows, new.shard_rows
        if self.mesh.process_count == 1:
            for r, part in new.parts.items():
                lo, hi = r * nsr, min((r + 1) * nsr, self.rows)
                for o, old in self.parts.items():
                    a, b = max(lo, o * sr), min(hi, (o + 1) * sr)
                    if a < b:
                        part[a - lo:b - lo] = old[a - o * sr:b - o * sr].to(part.device)
            return new
        for lo in range(0, self.rows, _TAKE_ROWS):
            hi = min(lo + _TAKE_ROWS, self.rows)
            new = new.set_rows(np.arange(lo, hi), self.take(np.arange(lo, hi)),
                               inplace=True)
        return new

    def map(self, fn, *others: "ShardedRows"):
        """``fn`` applied shard by shard to this container's tensors and the
        same shards of ``others``; a tuple result gives a tuple of
        containers."""
        out = {r: fn(t, *(o.parts[r] for o in others))
               for r, t in self.parts.items()}
        first = next(iter(out.values()))
        if isinstance(first, tuple):
            return tuple(ShardedRows(self.mesh, self.rows,
                                     {r: v[i] for r, v in out.items()})
                         for i in range(len(first)))
        return ShardedRows(self.mesh, self.rows, out)

    def __repr__(self) -> str:
        return (f"ShardedRows(shape={self.shape}, dtype={self.dtype}, "
                f"shards={sorted(self.parts)} of {n_shards(self.mesh)})")


class Route:
    """Rows by global id, split once by owner shard for every read and
    write of one row count that a step makes (``ShardedRows.route``).

    ``parts`` holds, for each local shard that owns some of the rows, its
    rank, their positions in ``rows`` (numpy) and the shard-local index on
    the shard's device (with ``cols``, the pair of index tensors). Indices
    and positions reach the home device in one copy, so a step that touches
    several fields uploads them once, before its work on the device."""

    __slots__ = ("rows", "n", "parts", "_pos", "_home")

    def __init__(self, mesh: Mesh, rows: int, ids, cols=None):
        self.rows = int(rows)
        ids = np.asarray(ids, dtype=np.int64)
        self.n = ids.shape[0]
        sr = self.rows // n_shards(mesh)
        owner = ids // sr
        mine = [(r, dev, np.flatnonzero(owner == r))
                for r, dev in local_shards(mesh)]
        mine = [(r, dev, sel) for r, dev, sel in mine if sel.size]
        width = 2 if cols is None else 3
        pieces = [np.zeros((0,), np.int64)]
        for r, _, sel in mine:
            pieces += [ids[sel] - r * sr, sel]
            if cols is not None:
                pieces.append(np.asarray(cols, dtype=np.int64)[sel])
        self._home = mesh.home
        flat = torch.from_numpy(np.concatenate(pieces)).to(self._home)
        self.parts, self._pos, at = [], [], 0
        for r, dev, sel in mine:
            k = sel.size
            got = [flat[at + j * k:at + (j + 1) * k] for j in range(width)]
            at += width * k
            idx = (got[0].to(dev),) + ((got[2].to(dev),) if cols is not None else ())
            self.parts.append((r, sel, idx))
            self._pos.append(got[1])

    def positions(self, i: int, device: torch.device) -> torch.Tensor:
        """Part ``i``'s positions in ``rows``, on ``device``."""
        if device == self._home:
            return self._pos[i]
        return torch.from_numpy(self.parts[i][1]).to(device)

    def pick(self, i: int, vals: torch.Tensor) -> torch.Tensor:
        """The rows of ``vals`` that part ``i`` writes."""
        if self.parts[i][1].size == self.n:
            return vals
        return vals[self.positions(i, vals.device)]
