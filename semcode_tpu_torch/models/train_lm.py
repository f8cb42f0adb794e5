"""Decoder checkpoints: ``save_lm_params`` / ``load_lm_params``.

Counterpart of the checkpoint half of ``semcode_tpu/models/train_lm.py``
(273-304). The next-token trainer itself (``LMTrainer``, ``WindowBatcher``,
``build_qa_texts``) is not ported yet; a later slice adds it here. The files
are the JAX package's, read and written without flax:

- ``semcode_lm.msgpack``: flax's msgpack serialization of the decoder's
  param tree (``decoder.init_params``' layout), through
  ``train.params_from_bytes`` / ``params_to_bytes``. flax stores the list
  ``blocks`` as a map keyed ``"0"``, ``"1"``, ...: it is restored in the
  keys' integer order (as strings ``"10"`` sorts before ``"2"``) and
  written back as that map, so the JAX ``load_lm_params`` reads this
  module's files;
- ``semcode_lm.json``: the ``DecoderConfig`` fields, ``dtype`` named
  ``"bfloat16"`` or ``"float32"``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .decoder import DTYPES, DecoderConfig
from .encoder import DTYPE_NAMES
from .train import params_from_bytes, params_to_bytes

PARAMS_FILE = "semcode_lm.msgpack"
CONFIG_FILE = "semcode_lm.json"


def save_lm_params(params: Dict[str, Any], cfg: DecoderConfig, path) -> None:
    """Write the decoder's param tree (numpy leaves) and config."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = dict(params)
    tree["blocks"] = {str(i): b for i, b in enumerate(params["blocks"])}
    (path / PARAMS_FILE).write_bytes(params_to_bytes(tree))
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["dtype"] = DTYPE_NAMES[cfg.dtype]
    (path / CONFIG_FILE).write_text(json.dumps(cfg_dict))


def load_lm_params(path, dtype: Optional[Any] = None) -> Tuple[Dict[str, Any], DecoderConfig]:
    """Load params + config saved by either package's ``save_lm_params``.
    ``dtype`` (a torch dtype), when given, overrides the file's compute
    dtype. Returns (param tree with numpy float32 leaves, cfg)."""
    path = Path(path)
    cfg_dict = json.loads((path / CONFIG_FILE).read_text())
    cfg_dict["dtype"] = dtype if dtype is not None else DTYPES[
        cfg_dict.get("dtype", "bfloat16")]
    cfg = DecoderConfig(**cfg_dict)
    params = params_from_bytes((path / PARAMS_FILE).read_bytes())
    blocks = params["blocks"]
    params["blocks"] = [blocks[k] for k in sorted(blocks, key=int)]
    if len(params["blocks"]) != cfg.layers:
        raise ValueError(f"{path / PARAMS_FILE} holds {len(params['blocks'])} "
                         f"blocks, its config {cfg.layers}")

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [widen(v) for v in tree]
        return np.asarray(tree, dtype=np.float32)

    return widen(params), cfg
