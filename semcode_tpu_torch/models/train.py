"""Encoder checkpoints: ``save_params`` / ``load_params``.

Counterpart of the checkpoint half of ``semcode_tpu/models/train.py``
(164-225). The contrastive trainer itself is not ported yet; a later slice
adds it here. Checkpoints are the JAX package's files, read and written
without flax:

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
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .encoder import DTYPE_NAMES, EncoderConfig

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
