"""Contrastive training for the code encoder, and its checkpoints.

Counterpart of ``semcode_tpu/models/train.py``: InfoNCE over (anchor,
positive) text pairs (``data.PairBatcher``) with in-batch negatives, in both
directions, at temperature 0.05, under ``adamw`` (betas 0.9 / 0.999, eps
1e-8, weight decay 0.01 on every parameter, biases and layernorm scales
included, as optax's ``adamw`` without a mask does).

One device: the reference shards the step over a ``(data, model)`` mesh
(``param_spec`` / ``make_param_shardings``); those rules have no one-card
counterpart and are left out. The weights are kept as float32 masters
(``state_dict`` names, the values of flax's tree) and every forward runs on
their casts to the module's dtypes, through ``torch.func.functional_call``:
the cast is differentiable, so the gradient reaches the masters in float32
as the reference's per-call ``astype`` does, and AdamW's small updates are
not rounded away as they would be on bf16 weights. ``torch.autocast`` is not
used: it would change the roundings the forward matches op by op.

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
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..device import DeviceLike, f32_matmul, resolve_device
from .encoder import DTYPE_NAMES, CodeEncoder, EncoderConfig, random_state


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


def adamw(params: Mapping[str, torch.Tensor], learning_rate: Union[float, Schedule],
          weight_decay: float) -> OptState:
    """``optax.adamw(learning_rate, weight_decay=...)`` over ``params``.

    A schedule is evaluated, as optax does, at the count of updates made
    BEFORE the update it scales (the first update uses ``schedule(0)``):
    ``LambdaLR`` at base rate 1 sets the rate to ``schedule(0)`` and, stepped
    after each update, to the next count's. Weight decay is scaled by the
    scheduled rate in both."""
    scheduled = callable(learning_rate)
    opt = torch.optim.AdamW(list(params.values()),
                            lr=1.0 if scheduled else float(learning_rate),
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, learning_rate) if scheduled else None
    return OptState(opt, sched)


def master_params(state: Mapping[str, torch.Tensor], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """float32 leaf copies of ``state`` on ``device``, with gradients."""
    return {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
            for k, v in state.items()}


def compute_params(model: nn.Module, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Each master cast to the dtype ``model`` holds it in (the compute
    dtype for products and embeddings, float32 for layernorms)."""
    held = dict(model.named_parameters())
    return {k: v.to(held[k].dtype) for k, v in params.items()}


def device_batch(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long).to(device)
            for k, v in batch.items()}


# -- the trainers ----------------------------------------------------------------


class MasterTrainer:
    """Steps of ``loss_fn`` on one device (CUDA unless asked for the CPU),
    shared by ``ContrastiveTrainer`` and ``train_lm.LMTrainer``.
    ``state_from`` gives ``(params, opt_state)``: float32 masters by
    ``state_dict`` name and their ``OptState``; ``train_step`` updates both
    in place and returns them with the step's metrics, so a loop reads as
    the JAX package's."""

    def __init__(self, model: nn.Module, learning_rate: Union[float, Schedule],
                 weight_decay: float, device: DeviceLike):
        self.device = resolve_device(device)
        self.model = model.to(self.device).requires_grad_(False)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def state_from(self, state: Mapping[str, torch.Tensor]):
        """Masters and optimizer from a ``state_dict`` (a seeded init, or a
        checkpoint's tree through ``*_state_from_jax``)."""
        params = master_params(state, self.device)
        return params, adamw(params, self.learning_rate, self.weight_decay)

    def loss_fn(self, params, batch: Mapping[str, torch.Tensor]):
        raise NotImplementedError

    def value_and_grad(self, params, batch: Mapping[str, Any]):
        """The step's metrics and the masters' gradients (``.grad``)."""
        for p in params.values():
            p.grad = None
        loss, metrics = self.loss_fn(params, device_batch(batch, self.device))
        loss.backward()
        return metrics, {k: p.grad for k, p in params.items()}

    def train_step(self, params, opt_state: OptState, batch: Mapping[str, Any]):
        metrics, _ = self.value_and_grad(params, batch)
        opt_state.step()
        return params, opt_state, metrics


class ContrastiveTrainer(MasterTrainer):
    """InfoNCE steps of the encoder, both directions, on in-batch negatives."""

    def __init__(
        self,
        cfg: EncoderConfig,
        *,
        learning_rate: Union[float, Schedule] = 1e-4,
        weight_decay: float = 0.01,
        temperature: float = 0.05,
        device: DeviceLike = None,
    ):
        super().__init__(CodeEncoder(cfg), learning_rate, weight_decay, device)
        self.cfg = cfg
        self.temperature = temperature

    def init_state(self, seed: int = 0):
        return self.state_from(random_state(self.cfg, seed))

    def embed(self, params, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return functional_call(self.model, compute_params(self.model, params), (ids, mask))

    def loss_fn(self, params, batch: Mapping[str, torch.Tensor]):
        emb_a = self.embed(params, batch["anchor_ids"], batch["anchor_mask"])
        emb_b = self.embed(params, batch["pos_ids"], batch["pos_mask"])
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
