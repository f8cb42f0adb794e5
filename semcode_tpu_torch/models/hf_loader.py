"""Load pretrained HF BERT-family encoder weights for ``CodeEncoder``.

Counterpart of ``semcode_tpu/models/hf_loader.py``. Supports the
sentence-transformers MiniLM / BERT-base class of checkpoints (config.json
+ model.safetensors, or pytorch_model.bin, + tokenizer.json in a local
directory — no network). The HF names map onto the encoder's param tree in
flax's layout, with ``post_ln=True`` so the computation is BERT-faithful;
``encoder.encoder_state_from_jax`` then makes the ``state_dict``. The
layernorms keep the encoder's epsilon 1e-6, as the JAX package does (BERT
trains with 1e-12).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from .encoder import EncoderConfig


def _split_heads(w: np.ndarray, heads: int) -> np.ndarray:
    # HF: (hidden, hidden) with output rows = hidden; flax MHA kernel:
    # (in_hidden, heads, head_dim)
    hidden = w.shape[1]
    return w.T.reshape(hidden, heads, hidden // heads)


def _read_weights(path: Path) -> dict:
    weights_file = path / "model.safetensors"
    if weights_file.exists():
        from safetensors.numpy import load_file

        return load_file(str(weights_file))
    import torch  # pytorch_model.bin

    return {
        k: v.float().numpy()
        for k, v in torch.load(
            path / "pytorch_model.bin", map_location="cpu", weights_only=True
        ).items()
    }


def load_hf_encoder_params(
    path: Path, base_cfg: EncoderConfig
) -> Tuple[dict, EncoderConfig]:
    path = Path(path)
    hf = json.loads((path / "config.json").read_text(encoding="utf-8"))
    cfg = EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["hidden_size"],
        layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        max_len=hf.get("max_position_embeddings", base_cfg.max_len),
        dtype=base_cfg.dtype,
        post_ln=True,
        emb_ln=True,
        type_vocab=hf.get("type_vocab_size", 2),
    )
    raw = {k.removeprefix("bert."): v for k, v in _read_weights(path).items()}

    def g(name: str) -> np.ndarray:
        return np.asarray(raw[name])

    heads = cfg.heads
    hidden = cfg.hidden

    def qkv(p: str, name: str) -> dict:
        return {
            "kernel": _split_heads(g(p + f"attention.self.{name}.weight"), heads),
            "bias": g(p + f"attention.self.{name}.bias").reshape(
                heads, hidden // heads
            ),
        }

    def ln(prefix: str) -> dict:
        return {"scale": g(prefix + ".weight"), "bias": g(prefix + ".bias")}

    params: dict = {
        "tok_emb": {"embedding": g("embeddings.word_embeddings.weight")},
        "pos_emb": g("embeddings.position_embeddings.weight"),
        "type_emb": g("embeddings.token_type_embeddings.weight"),
        "emb_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(cfg.layers):
        p = f"encoder.layer.{i}."
        params[f"block_{i}"] = {
            "attn": {
                "query": qkv(p, "query"),
                "key": qkv(p, "key"),
                "value": qkv(p, "value"),
                "out": {
                    "kernel": g(p + "attention.output.dense.weight")
                    .T.reshape(heads, hidden // heads, hidden),
                    "bias": g(p + "attention.output.dense.bias"),
                },
            },
            "ln1": ln(p + "attention.output.LayerNorm"),
            "mlp_in": {
                "kernel": g(p + "intermediate.dense.weight").T,
                "bias": g(p + "intermediate.dense.bias"),
            },
            "mlp_out": {
                "kernel": g(p + "output.dense.weight").T,
                "bias": g(p + "output.dense.bias"),
            },
            "ln2": ln(p + "output.LayerNorm"),
        }
    return {"params": params}, cfg
