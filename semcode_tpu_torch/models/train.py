"""Contrastive training for the code encoder, and its checkpoints.

Counterpart of ``semcode_tpu/models/train.py``: InfoNCE over (anchor,
positive) text pairs (``data.PairBatcher``) with in-batch negatives, in both
directions, at temperature 0.05, under ``adamw`` (betas 0.9 / 0.999, eps
1e-8, weight decay 0.01 on every parameter, biases and layernorm scales
included, as optax's ``adamw`` without a mask does).

The weights are kept as float32 masters (``state_dict`` names, the values
of flax's tree) and every forward runs on their casts to the module's
dtypes, through ``torch.func.functional_call``: the cast is differentiable,
so the gradient reaches the masters in float32 as the reference's per-call
``astype`` does, and AdamW's small updates are not rounded away as they
would be on bf16 weights. ``torch.autocast`` is not used: it would change
the roundings the forward matches op by op.

Sharding: as in the reference, a trainer takes a ``(data, model)`` mesh
(``parallel.mesh``; one process, a device may repeat). The batch splits
over ``"data"``; ``param_spec`` / ``make_param_shardings`` split the
attention heads, the MLP columns and the token embedding's hidden dim over
``"model"`` (``Split``), and ``encoder.tp_forward`` runs a replica's
forward over its model shards. Each split master is a list of float32
pieces, one per model shard (``MasterTrainer``); autograd sums the
replicas' gradients into them (the reference's all-reduce over
``"data"``), and ``gather`` gives whole tensors back for the checkpoint.
Without a mesh the trainer runs on one device, as before.

A port-trained encoder starts from ``encoder.random_state`` (the port's
own draw, not flax's); its checkpoint goes through
``encoder.encoder_state_to_jax`` to ``save_params``, which writes the JAX
package's files:

- ``semcode_encoder.msgpack``: flax's msgpack serialization of the param
  tree ``{"params": {...}}``: nested maps with string keys whose leaves are
  msgpack ext type 1, each packing ``(shape, dtype name, raw C-order
  bytes)``;
- ``semcode_encoder.json``: the ``EncoderConfig`` fields, with ``dtype``
  named ``"bfloat16"`` or ``"float32"``.

The tree is held as nested dicts of numpy arrays in flax's layout (the
shape ``load_params`` of the JAX package returns); ``encoder.
encoder_state_from_jax`` turns it into the port's ``state_dict``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..device import DeviceLike, f32_matmul, resolve_device
from ..parallel.mesh import DATA_AXIS, Mesh, make_mesh
from .encoder import DTYPE_NAMES, CodeEncoder, EncoderConfig, random_state, tp_forward


# -- optimizer -------------------------------------------------------------------

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps`` updates, then a
    cosine decay to ``end_value`` at ``decay_steps`` (warmup included)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps "
                         f"({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class OptState(NamedTuple):
    """The optimizer of a set of masters, and its learning-rate schedule
    (None for a constant rate)."""

    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]

    def step(self) -> None:
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()


def adamw(params: Mapping[str, Any], learning_rate: Union[float, Schedule],
          weight_decay: float) -> OptState:
    """``optax.adamw(learning_rate, weight_decay=...)`` over ``params``
    (tensors, or a sharded master's pieces: each piece is updated on its
    own device, element by element as the whole tensor would be).

    A schedule is evaluated, as optax does, at the count of updates made
    BEFORE the update it scales (the first update uses ``schedule(0)``):
    ``LambdaLR`` at base rate 1 sets the rate to ``schedule(0)`` and, stepped
    after each update, to the next count's. Weight decay is scaled by the
    scheduled rate in both."""
    scheduled = callable(learning_rate)
    opt = torch.optim.AdamW(_leaves(params),
                            lr=1.0 if scheduled else float(learning_rate),
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, learning_rate) if scheduled else None
    return OptState(opt, sched)


def _leaves(params: Mapping[str, Any]) -> List[torch.Tensor]:
    return [p for v in params.values() for p in (v if isinstance(v, list) else [v])]


def master_params(state: Mapping[str, torch.Tensor], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """float32 leaf copies of ``state`` on ``device``, with gradients."""
    return {k: _master(v, device) for k, v in state.items()}


def _master(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.detach().to(device, torch.float32).clone().requires_grad_(True)


# -- tensor-parallel sharding rules --------------------------------------------------


class Split(NamedTuple):
    """A weight split over a mesh's ``"model"`` axis: along ``dim``, each of
    ``groups`` equal blocks of that dim cut into one contiguous piece per
    model shard (``groups`` 3: the fused q/k/v rows, split by heads within
    each of q, k and v)."""

    dim: int
    groups: int = 1


# CodeEncoder's state_dict names (nn.Linear weights are (out, in))
ENCODER_SPLITS = {
    "attn.qkv.weight": Split(0, 3),  # column-parallel, by heads
    "attn.qkv.bias": Split(0, 3),
    "attn.out.weight": Split(1),  # row-parallel: the heads' input dim
    "mlp_in.weight": Split(0),  # column-parallel
    "mlp_in.bias": Split(0),
    "mlp_out.weight": Split(1),  # row-parallel
    "tok_emb.weight": Split(1),  # (vocab, hidden): the hidden dim
}


def param_spec(name: str, rules: Mapping[str, Split] = ENCODER_SPLITS) -> Optional[Split]:
    """Tensor-parallel rule of a ``state_dict`` name: its ``Split``, or None
    for a replicated weight (layernorms, position and type embeddings, the
    row-parallel layers' biases). The counterpart of the reference's
    ``param_spec`` on flax's paths: ``query`` / ``key`` / ``value`` split on
    heads, ``out`` on its heads dim, ``mlp_in`` on its output dim,
    ``mlp_out`` on its input dim, ``tok_emb`` on hidden."""
    for suffix, split in rules.items():
        if name == suffix or name.endswith("." + suffix):
            return split
    return None


def make_param_shardings(mesh: Mesh, state: Mapping[str, Any],
                         rules: Mapping[str, Split] = ENCODER_SPLITS
                         ) -> Dict[str, Optional[Split]]:
    """``param_spec`` of every name of ``state`` on ``mesh``: as in the
    reference's ``_spec_for``, a mesh without a ``"model"`` axis (or with
    one model shard) replicates what tensor parallelism would split."""
    split = mesh.model_shards > 1
    return {name: param_spec(name, rules) if split else None for name in state}


def check_divisible(cfg, shards: int) -> None:
    """Heads, MLP columns and the hidden dim must divide by the model-shard
    count."""
    for field in ("heads", "mlp_dim", "hidden"):
        if getattr(cfg, field) % shards:
            raise ValueError(f"{field} = {getattr(cfg, field)} does not divide "
                             f"by the mesh's {shards} model shards")


def split_pieces(t: torch.Tensor, split: Split, shards: int) -> List[torch.Tensor]:
    """``t`` cut into its model shards' pieces by ``split``."""
    groups = [g.chunk(shards, dim=split.dim) for g in t.chunk(split.groups, dim=split.dim)]
    return [torch.cat([g[m] for g in groups], dim=split.dim) if split.groups > 1
            else groups[0][m] for m in range(len(groups[0]))]


def merge_pieces(pieces: Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The inverse of ``split_pieces``: the whole tensor on the first
    piece's device."""
    home = pieces[0].device
    parts = [p.to(home).chunk(split.groups, dim=split.dim) for p in pieces]
    return torch.cat([parts[m][g] for g in range(split.groups) for m in range(len(parts))],
                     dim=split.dim)


def device_batch(batch: Mapping[str, Any], mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """The batch's rows split over the mesh's data replicas, replica ``d``'s
    slice on its first device (``device_at(d, 0)``). A batch that does not
    divide by the replica count raises, as the reference's ``device_put``
    onto ``P("data", None)`` does."""
    n = mesh.replicas
    host = {k: torch.as_tensor(np.asarray(v), dtype=torch.long) for k, v in batch.items()}
    rows = next(iter(host.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{n} data replicas")
    if n == 1:
        return [{k: v.to(mesh.home) for k, v in host.items()}]
    per = rows // n
    return [{k: v[d * per:(d + 1) * per].to(mesh.device_at(d, 0)) for k, v in host.items()}
            for d in range(n)]


def sum_parts(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return xs[0] if len(xs) == 1 else torch.stack(xs).sum()


# -- the trainers ----------------------------------------------------------------


class MasterTrainer:
    """Steps of ``loss_fn``, shared by ``ContrastiveTrainer`` and
    ``train_lm.LMTrainer``: on one device (CUDA unless asked for the CPU)
    or on a ``(data, model)`` mesh (``parallel.mesh``, one process; a
    device may repeat). ``state_from`` gives ``(params, opt_state)``:
    float32 masters by ``state_dict`` name and their ``OptState``;
    ``train_step`` updates both in place and returns them with the step's
    metrics, so a loop reads as the JAX package's.

    On a mesh with several model shards a master that ``rules`` split is
    a list of pieces, piece ``m`` on ``device_at(0, m)``; the others live
    on ``mesh.home``. Data replica ``d`` reads every master through
    ``.to(device_at(d, m), dtype)`` (``replica_weights``): on a repeated
    device the copy is a no-op, and autograd sums the replicas' gradients
    into the masters either way, which is the reference's all-reduce over
    ``"data"``. ``gather`` turns masters (or their gradients) back into
    whole tensors on ``mesh.home``."""

    def __init__(self, model: nn.Module, learning_rate: Union[float, Schedule],
                 weight_decay: float, device: DeviceLike, mesh: Optional[Mesh] = None,
                 rules: Mapping[str, Split] = ENCODER_SPLITS):
        if mesh is None:
            mesh = make_mesh((1,), (DATA_AXIS,), devices=[resolve_device(device)])
        elif device is not None and resolve_device(device) not in (
                mesh.home, torch.device(mesh.home.type)):
            raise ValueError(f"device {device} is not the home of {mesh}")
        self.mesh = mesh
        self.device = mesh.home
        if mesh.model_shards > 1:
            check_divisible(model.cfg, mesh.model_shards)
        self.model = model.to(self.device).requires_grad_(False)
        self.held = {k: v.dtype for k, v in self.model.named_parameters()}
        self.splits = make_param_shardings(mesh, self.model.state_dict(), rules)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def state_from(self, state: Mapping[str, torch.Tensor]):
        """Masters and optimizer from a ``state_dict`` (a seeded init, or a
        checkpoint's tree through ``*_state_from_jax``)."""
        params = {}
        for name, value in state.items():
            split = self.splits[name]
            if split is None:
                params[name] = _master(value, self.device)
            else:
                pieces = split_pieces(value.detach(), split, self.mesh.model_shards)
                params[name] = [_master(p, self.mesh.device_at(0, m))
                                for m, p in enumerate(pieces)]
        return params, adamw(params, self.learning_rate, self.weight_decay)

    def gather(self, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Masters (or their gradients) as whole ``state_dict`` tensors on
        ``mesh.home``, detached: what ``*_state_to_jax`` writes."""
        return {name: (merge_pieces(v, self.splits[name]) if isinstance(v, list)
                       else v).detach().to(self.device)
                for name, v in tree.items()}

    def cast(self, value, replica: int, dtype: torch.dtype, cache: dict, key: str):
        """A master (or its pieces) on data replica ``replica``'s devices in
        ``dtype``; one copy per (master, piece, device) in ``cache``."""
        out = []
        for m, piece in enumerate(value if isinstance(value, list) else [value]):
            dev = self.mesh.device_at(replica, m)
            got = cache.get((key, m, dev))
            if got is None:
                got = cache[(key, m, dev)] = piece.to(device=dev, dtype=dtype)
            out.append(got)
        return out if isinstance(value, list) else out[0]

    def replica_weights(self, params, replica: int, cache: dict) -> Dict[str, Any]:
        """Replica ``replica``'s view of the masters in the dtypes the model
        holds them in (the compute dtype for products and embeddings,
        float32 for layernorms)."""
        return {k: self.cast(v, replica, self.held[k], cache, k) for k, v in params.items()}

    def replica_devices(self, replica: int) -> List[torch.device]:
        return [self.mesh.device_at(replica, m) for m in range(self.mesh.model_shards)]

    def loss_fn(self, params, batches: Sequence[Mapping[str, torch.Tensor]]):
        raise NotImplementedError

    def value_and_grad(self, params, batch: Mapping[str, Any]):
        """The step's metrics and the masters' gradients (``.grad``, pieces
        for a split master)."""
        for p in _leaves(params):
            p.grad = None
        loss, metrics = self.loss_fn(params, device_batch(batch, self.mesh))
        loss.backward()
        return metrics, {k: [p.grad for p in v] if isinstance(v, list) else v.grad
                         for k, v in params.items()}

    def train_step(self, params, opt_state: OptState, batch: Mapping[str, Any]):
        metrics, _ = self.value_and_grad(params, batch)
        opt_state.step()
        return params, opt_state, metrics


class ContrastiveTrainer(MasterTrainer):
    """InfoNCE steps of the encoder, both directions, on in-batch negatives.

    On a mesh each data replica embeds its slice of the anchors and the
    positives (``encoder.tp_forward`` over its model shards when there are
    several); the embeddings are concatenated on ``mesh.home`` in data
    order (the reference's in-batch-negatives all-gather), where the (B, B)
    logits and the loss are computed."""

    def __init__(
        self,
        cfg: EncoderConfig,
        mesh: Optional[Mesh] = None,
        *,
        learning_rate: Union[float, Schedule] = 1e-4,
        weight_decay: float = 0.01,
        temperature: float = 0.05,
        device: DeviceLike = None,
    ):
        super().__init__(CodeEncoder(cfg), learning_rate, weight_decay, device, mesh)
        self.cfg = cfg
        self.temperature = temperature

    def init_state(self, seed: int = 0):
        return self.state_from(random_state(self.cfg, seed))

    def embed(self, weights: Dict[str, Any], replica: int, ids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """Unit embeddings of one replica's rows from ``replica_weights``."""
        if self.mesh.model_shards == 1:
            return functional_call(self.model, weights, (ids, mask))
        return tp_forward(self.cfg, weights, self.replica_devices(replica), ids, mask)

    def loss_fn(self, params, batches: Sequence[Mapping[str, torch.Tensor]]):
        cache: dict = {}
        emb_a, emb_b = [], []
        for d, batch in enumerate(batches):
            weights = self.replica_weights(params, d, cache)
            emb_a.append(self.embed(weights, d, batch["anchor_ids"],
                                    batch["anchor_mask"]).to(self.device))
            emb_b.append(self.embed(weights, d, batch["pos_ids"],
                                    batch["pos_mask"]).to(self.device))
        emb_a = emb_a[0] if len(emb_a) == 1 else torch.cat(emb_a)
        emb_b = emb_b[0] if len(emb_b) == 1 else torch.cat(emb_b)
        logits = f32_matmul(emb_a, emb_b.t()) / self.temperature  # (B, B), f32
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss_ab = F.cross_entropy(logits, labels, reduction="none")
        loss_ba = F.cross_entropy(logits.t(), labels, reduction="none")
        loss = (loss_ab + loss_ba).mean() * 0.5
        acc = (logits.argmax(dim=1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "accuracy": acc}


# -- checkpointing ---------------------------------------------------------------

PARAMS_FILE = "semcode_encoder.msgpack"
CONFIG_FILE = "semcode_encoder.json"
_EXT_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


def _array_from_ext(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        # numpy has no bfloat16: widen it to float32, which is exact
        raw = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return raw.float().numpy().reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code} in a checkpoint")
    return msgpack.ExtType(code, data)


def _restore(tree):
    import msgpack

    if isinstance(tree, msgpack.ExtType):
        return _array_from_ext(tree.data)
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked (> 1 GiB) checkpoint arrays are not supported")
        return {k: _restore(v) for k, v in tree.items()}
    raise ValueError(f"unexpected checkpoint leaf {type(tree).__name__}")


def params_from_bytes(raw: bytes) -> Dict[str, Any]:
    """Flax msgpack bytes -> nested dicts of numpy arrays."""
    import msgpack

    return _restore(msgpack.unpackb(raw, ext_hook=_ext_hook, raw=False))


def params_to_bytes(params: Dict[str, Any]) -> bytes:
    """Nested dicts of arrays -> flax msgpack bytes."""
    import msgpack

    def pack(x):
        if isinstance(x, np.ndarray):
            arr = np.ascontiguousarray(x)
            return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
                (list(arr.shape), arr.dtype.name, arr.tobytes("C")),
                use_bin_type=True,
            ))
        raise TypeError(f"cannot serialize {type(x).__name__}")

    def walk(tree):
        if isinstance(tree, dict):
            return {str(k): walk(v) for k, v in tree.items()}
        return np.asarray(tree)

    return msgpack.packb(walk(params), default=pack, strict_types=True)


def save_params(params, cfg: EncoderConfig, path, *, half: bool = False) -> None:
    """Write ``params`` (flax layout, numpy leaves) and ``cfg``.

    ``half=True`` casts weights to float16 on disk (halves checkpoint size
    for shipping; ``load_params`` restores float32)."""
    import dataclasses

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        arr = np.asarray(tree)
        return arr.astype(np.float16) if half else arr

    (path / PARAMS_FILE).write_bytes(params_to_bytes(cast(params)))
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["dtype"] = DTYPE_NAMES[cfg.dtype]
    (path / CONFIG_FILE).write_text(json.dumps(cfg_dict))


def load_params(path) -> Tuple[Dict[str, Any], EncoderConfig]:
    """Load params + config saved by ``save_params`` (either package's).

    The config file decides the model and its compute dtype. float16 leaves
    restore to float32, as the JAX package's ``load_params`` does."""
    path = Path(path)
    cfg_dict = json.loads((path / CONFIG_FILE).read_text())
    names = {v: k for k, v in DTYPE_NAMES.items()}
    cfg_dict["dtype"] = names[cfg_dict.get("dtype", "bfloat16")]
    cfg = EncoderConfig(**cfg_dict)
    params = params_from_bytes((path / PARAMS_FILE).read_bytes())

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        return tree.astype(np.float32) if tree.dtype == np.float16 else tree

    return widen(params), cfg
