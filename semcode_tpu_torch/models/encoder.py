"""Transformer encoder for embedding inference (PyTorch).

Counterpart of ``semcode_tpu/models/encoder.py``: a BERT-style
bidirectional encoder with masked mean pooling and L2 normalization, run on
the card in bf16 with f32 layernorms. It computes what the flax module
computes, operation by operation:

- layernorms in float32 with flax's epsilon 1e-6 (torch's default is 1e-5),
  also on the BERT (post-LN) path;
- attention divides the query by ``sqrt(head_dim)`` rounded to the compute
  dtype (5.65625 in bf16 for head_dim 32), masks logits with the dtype's
  most negative finite value where ``mask_q & mask_k`` is false, and runs
  the softmax in the compute dtype;
- GELU is the tanh form in the pre-LN blocks and the exact erf form in the
  post-LN (BERT) blocks;
- token and position embeddings are added in the compute dtype; pre-LN's
  final layernorm output is pooled in float32 without rounding, post-LN's
  last block output is widened from the compute dtype.

``tp_forward`` is the same forward with the weights split over model
shards (the trainer's tensor parallelism, ``train.param_spec``).

Weights come from the JAX package's checkpoints (``train.load_params`` /
``hf_loader``) through ``encoder_state_from_jax``. Products stay
``nn.Linear`` / ``torch.matmul``: the reference runs them in plain XLA, not
in a Pallas kernel. The forward holds no mutable state, so the API's query
threads and its ingest worker may call it at once.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..logger import get_logger
from .tokenizer import CLS_ID, PAD_ID, load_tokenizer

log = get_logger("models.encoder")

LN_EPS = 1e-6  # flax.linen.LayerNorm's default
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    mlp_dim: int = 1536
    max_len: int = 512
    dtype: Any = torch.bfloat16
    # BERT-faithful mode for loading pretrained HF weights: post-layernorm
    # blocks, embedding layernorm, token-type embeddings.
    post_ln: bool = False
    emb_ln: bool = False
    type_vocab: int = 0

    @staticmethod
    def preset(name: str, *, vocab_size: int = 32768, max_len: int = 512,
               dtype: Any = torch.bfloat16) -> "EncoderConfig":
        table = {
            "mini": dict(hidden=384, layers=6, heads=12, mlp_dim=1536),
            "base": dict(hidden=768, layers=12, heads=12, mlp_dim=3072),
            "large": dict(hidden=1024, layers=24, heads=16, mlp_dim=4096),
        }
        if name not in table:
            raise ValueError(f"unknown encoder preset: {name}")
        return EncoderConfig(
            vocab_size=vocab_size, max_len=max_len, dtype=dtype, **table[name]
        )


def _layer_norm(hidden: int) -> nn.LayerNorm:
    return nn.LayerNorm(hidden, eps=LN_EPS, dtype=torch.float32)


def _query_scale(head_dim: int, dtype) -> float:
    """flax: ``query / jnp.sqrt(depth).astype(dtype)``."""
    return float(torch.tensor(math.sqrt(head_dim)).to(dtype).float())


def _split_qkv(qkv: torch.Tensor, heads: int, head_dim: int):
    """A fused (B, L, 3 * heads * head_dim) product -> q, k, v as
    (B, heads, L, head_dim)."""
    b, n, _ = qkv.shape
    return qkv.view(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4).unbind(0)


def _attend(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Masked softmax attention in the compute dtype -> (B, L, heads *
    head_dim)."""
    b, _, n, _ = q.shape
    logits = (q / scale) @ k.transpose(-1, -2)  # (B, H, L, L)
    # one pass over the logits (masked_fill would clone them first)
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    return (weights @ v).transpose(1, 2).reshape(b, n, -1)


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (q/k/v fused in one product)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.heads = cfg.heads
        self.head_dim = cfg.hidden // cfg.heads
        self.qkv = nn.Linear(cfg.hidden, 3 * cfg.hidden, dtype=cfg.dtype)
        self.out = nn.Linear(cfg.hidden, cfg.hidden, dtype=cfg.dtype)
        self.scale = _query_scale(self.head_dim, cfg.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = _split_qkv(self.qkv(x), self.heads, self.head_dim)
        return self.out(_attend(q, k, v, mask, self.scale))


class _Block(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.post_ln = cfg.post_ln
        self.dtype = cfg.dtype
        self.attn = _Attention(cfg)
        self.mlp_in = nn.Linear(cfg.hidden, cfg.mlp_dim, dtype=cfg.dtype)
        self.mlp_out = nn.Linear(cfg.mlp_dim, cfg.hidden, dtype=cfg.dtype)
        self.ln1 = _layer_norm(cfg.hidden)
        self.ln2 = _layer_norm(cfg.hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.post_ln:  # BERT layout (pretrained HF weights)
            x = self.ln1((x + self.attn(x, mask)).float()).to(dt)
            # HF BERT's "gelu" is the exact erf form, not the tanh approx
            h = self.mlp_out(F.gelu(self.mlp_in(x)))
            return self.ln2((x + h).float()).to(dt)
        # pre-LN layout (default: more stable to train from scratch)
        h = self.ln1(x.float()).to(dt)
        x = x + self.attn(h, mask)
        h = self.ln2(x.float()).to(dt)
        return x + self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))


class CodeEncoder(nn.Module):
    """Token ids (B, L) + mask (B, L) -> unit embeddings (B, hidden) f32."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden, dtype=cfg.dtype)
        self.pos_emb = nn.Parameter(
            torch.zeros(cfg.max_len, cfg.hidden, dtype=cfg.dtype)
        )
        self.type_emb = (
            nn.Parameter(torch.zeros(cfg.type_vocab, cfg.hidden, dtype=cfg.dtype))
            if cfg.type_vocab else None
        )
        self.emb_ln = _layer_norm(cfg.hidden) if cfg.emb_ln else None
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))
        self.ln_f = None if cfg.post_ln else _layer_norm(cfg.hidden)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = self.tok_emb(ids) + self.pos_emb[: ids.shape[1]]
        if self.type_emb is not None:
            x = x + self.type_emb[0]
        if self.emb_ln is not None:
            x = self.emb_ln(x.float()).to(dt)
        attn_mask = _attention_mask(mask)
        for block in self.blocks:
            x = block(x, attn_mask)
        x = self.ln_f(x.float()) if self.ln_f is not None else x.float()
        return _pool(x, mask)


def _attention_mask(mask: torch.Tensor) -> torch.Tensor:
    m = mask.bool()
    return (m[:, :, None] & m[:, None, :])[:, None]  # (B, 1, L, L)


def _pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling of float32 states, then L2 normalization."""
    mf = mask.to(torch.float32)[:, :, None]
    pooled = (x * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)
    norm = torch.linalg.vector_norm(pooled, dim=1, keepdim=True)
    return pooled / norm.clamp_min(1e-9)


# -- tensor parallelism ------------------------------------------------------------


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel shard's ``x @ w`` in float32: the compute-dtype
    operands widened (exactly), so the products and their sum are those of
    the compute-dtype GEMM's float32 accumulator, not yet rounded."""
    return x.float() @ w.float()


def row_parallel(parts: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The model shards' float32 partial products summed on ``home`` (the
    all-reduce): the one-device product's sum in another order, rounded
    once by the caller as the one-device GEMM rounds its output."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(home)
    return total


def gather_last(parts: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The shards' slices of the last dim concatenated on ``home`` (the
    all-gather); one slice is itself."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(home) for p in parts], dim=-1)


def _ln(weights: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], weights[name + ".weight"],
                        weights[name + ".bias"], LN_EPS)


def tp_forward(cfg: EncoderConfig, weights: Dict[str, Any],
               devices: Sequence[torch.device], ids: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``CodeEncoder``'s forward with its weights split over model shards
    (``train.param_spec``): ``weights`` holds each ``state_dict`` name in
    the module's dtype, a replicated one as a tensor on ``devices[0]`` and
    a split one as its pieces, piece ``m`` on ``devices[m]``; ``ids`` and
    ``mask`` live on ``devices[0]``.

    Megatron's layout, as GSPMD lays out the reference's shardings: the
    token embedding's hidden slices are looked up on their shards and
    concatenated (the all-gather); in each block the column-parallel q/k/v
    and ``mlp_in`` products run on every shard's device for its heads and
    MLP columns, attention runs over the shard's heads, and the
    row-parallel ``out`` and ``mlp_out`` partial products, in float32, are
    summed on ``devices[0]`` with the bias and rounded once
    (``row_parallel``: the all-reduce), as the one-device layer rounds its
    output once. Layernorms, the residual stream and the pooling run on
    ``devices[0]`` with flax's roundings, as in ``forward``. The result is
    the one-device forward's up to the order of the float sums."""
    home, dt = devices[0], cfg.dtype
    heads, hd = cfg.heads // len(devices), cfg.hidden // cfg.heads
    scale = _query_scale(hd, dt)
    tok = [F.embedding(ids.to(dev), piece)
           for piece, dev in zip(weights["tok_emb.weight"], devices)]
    x = gather_last(tok, home) + weights["pos_emb"][: ids.shape[1]]
    if cfg.type_vocab:
        x = x + weights["type_emb"][0]
    if cfg.emb_ln:
        x = _ln(weights, "emb_ln", x.float()).to(dt)
    attn_mask = _attention_mask(mask)
    masks = [attn_mask.to(dev) for dev in devices]

    def attention(pre: str, h: torch.Tensor) -> torch.Tensor:
        parts = []
        for s, dev in enumerate(devices):
            qkv = F.linear(h.to(dev), weights[pre + "attn.qkv.weight"][s],
                           weights[pre + "attn.qkv.bias"][s])
            q, k, v = _split_qkv(qkv, heads, hd)
            parts.append(partial_product(_attend(q, k, v, masks[s], scale),
                                         weights[pre + "attn.out.weight"][s].t()))
        return linear_out(parts, weights[pre + "attn.out.bias"])

    def mlp(pre: str, h: torch.Tensor, approximate: str) -> torch.Tensor:
        parts = [
            partial_product(
                F.gelu(F.linear(h.to(dev), weights[pre + "mlp_in.weight"][s],
                                weights[pre + "mlp_in.bias"][s]), approximate=approximate),
                weights[pre + "mlp_out.weight"][s].t())
            for s, dev in enumerate(devices)
        ]
        return linear_out(parts, weights[pre + "mlp_out.bias"])

    def linear_out(parts, bias: torch.Tensor) -> torch.Tensor:
        # nn.Linear's addmm: the bias joins the float32 sum, one rounding
        return (row_parallel(parts, home) + bias).to(dt)

    for i in range(cfg.layers):
        pre = f"blocks.{i}."
        if cfg.post_ln:
            x = _ln(weights, pre + "ln1", (x + attention(pre, x)).float()).to(dt)
            x = _ln(weights, pre + "ln2", (x + mlp(pre, x, "none")).float()).to(dt)
        else:
            x = x + attention(pre, _ln(weights, pre + "ln1", x.float()).to(dt))
            x = x + mlp(pre, _ln(weights, pre + "ln2", x.float()).to(dt), "tanh")
    x = _ln(weights, "ln_f", x.float()) if not cfg.post_ln else x.float()
    return _pool(x, mask)


def encoder_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax param tree (numpy leaves, ``{"params": ...}`` or its inside)
    -> ``CodeEncoder``'s ``state_dict`` (float32; ``load_state_dict`` rounds
    to the model's dtype as flax's per-call casts do).

    flax ``DenseGeneral`` keeps q/k/v kernels as ``(hidden, heads,
    head_dim)`` with ``(heads, head_dim)`` biases and the output kernel as
    ``(heads, head_dim, hidden)``; ``nn.Dense`` kernels are ``(in, out)``.
    ``nn.Linear`` weights are ``(out, in)``."""
    p = params.get("params", params)

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))

    def ln(tree) -> Dict[str, torch.Tensor]:
        return {"weight": t(tree["scale"]), "bias": t(tree["bias"])}

    state: Dict[str, torch.Tensor] = {
        "tok_emb.weight": t(p["tok_emb"]["embedding"]),
        "pos_emb": t(p["pos_emb"]),
    }
    if "type_emb" in p:
        state["type_emb"] = t(p["type_emb"])
    for name in ("emb_ln", "ln_f"):
        if name in p:
            state.update({f"{name}.{k}": v for k, v in ln(p[name]).items()})
    i = 0
    while f"block_{i}" in p:
        blk = p[f"block_{i}"]
        attn = blk["attn"]
        pre = f"blocks.{i}."
        hidden = attn["query"]["kernel"].shape[0]
        qkv_w = [np.asarray(attn[n]["kernel"]).reshape(hidden, -1).T
                 for n in ("query", "key", "value")]
        qkv_b = [np.asarray(attn[n]["bias"]).reshape(-1)
                 for n in ("query", "key", "value")]
        out_k = np.asarray(attn["out"]["kernel"])
        state.update({
            pre + "attn.qkv.weight": t(np.concatenate(qkv_w, axis=0)),
            pre + "attn.qkv.bias": t(np.concatenate(qkv_b)),
            pre + "attn.out.weight": t(out_k.reshape(-1, out_k.shape[-1]).T),
            pre + "attn.out.bias": t(attn["out"]["bias"]),
            pre + "mlp_in.weight": t(np.asarray(blk["mlp_in"]["kernel"]).T),
            pre + "mlp_in.bias": t(blk["mlp_in"]["bias"]),
            pre + "mlp_out.weight": t(np.asarray(blk["mlp_out"]["kernel"]).T),
            pre + "mlp_out.bias": t(blk["mlp_out"]["bias"]),
        })
        for name in ("ln1", "ln2"):
            state.update({f"{pre}{name}.{k}": v for k, v in ln(blk[name]).items()})
        i += 1
    return state


def encoder_state_to_jax(state: Dict[str, torch.Tensor], cfg: EncoderConfig
                         ) -> Dict[str, Any]:
    """The inverse of ``encoder_state_from_jax``: a ``CodeEncoder`` state
    (any device and float dtype) -> flax's tree ``{"params": {...}}`` with
    float32 numpy leaves, which ``train.save_params`` writes and the JAX
    package's ``load_params`` reads. ``cfg.heads`` splits the fused q/k/v
    rows back into ``(hidden, heads, head_dim)`` kernels."""
    heads, hd = cfg.heads, cfg.hidden // cfg.heads

    def n(name) -> np.ndarray:
        return state[name].detach().to("cpu", torch.float32).numpy().copy()

    def ln(pre: str) -> Dict[str, np.ndarray]:
        return {"scale": n(pre + ".weight"), "bias": n(pre + ".bias")}

    p: Dict[str, Any] = {"tok_emb": {"embedding": n("tok_emb.weight")},
                         "pos_emb": n("pos_emb")}
    if "type_emb" in state:
        p["type_emb"] = n("type_emb")
    for name in ("emb_ln", "ln_f"):
        if f"{name}.weight" in state:
            p[name] = ln(name)
    i = 0
    while f"blocks.{i}.attn.qkv.weight" in state:
        pre = f"blocks.{i}."
        qkv_w = n(pre + "attn.qkv.weight").reshape(3, cfg.hidden, cfg.hidden)
        qkv_b = n(pre + "attn.qkv.bias").reshape(3, heads, hd)
        attn = {
            name: {"kernel": np.ascontiguousarray(qkv_w[j].T).reshape(cfg.hidden, heads, hd),
                   "bias": qkv_b[j].copy()}
            for j, name in enumerate(("query", "key", "value"))
        }
        attn["out"] = {
            "kernel": np.ascontiguousarray(n(pre + "attn.out.weight").T).reshape(heads, hd, -1),
            "bias": n(pre + "attn.out.bias"),
        }
        p[f"block_{i}"] = {
            "attn": attn,
            "mlp_in": {"kernel": np.ascontiguousarray(n(pre + "mlp_in.weight").T),
                       "bias": n(pre + "mlp_in.bias")},
            "mlp_out": {"kernel": np.ascontiguousarray(n(pre + "mlp_out.weight").T),
                        "bias": n(pre + "mlp_out.bias")},
            "ln1": ln(pre + "ln1"),
            "ln2": ln(pre + "ln2"),
        }
        i += 1
    return {"params": p}


def random_state(cfg: EncoderConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded random init (float32, drawn on the CPU so every device gets
    the same weights): N(0, 0.02) embeddings, N(0, 1/fan_in) products,
    zero biases, unit layernorms. It is the port's own draw, not flax's."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, tensor in CodeEncoder(cfg).state_dict().items():
        shape = tuple(tensor.shape)
        if ".ln" in name or name.startswith(("ln_f", "emb_ln")):
            val = torch.ones(shape) if name.endswith("weight") else torch.zeros(shape)
        elif name.endswith("bias"):
            val = torch.zeros(shape)
        elif name.endswith(("emb.weight", "pos_emb", "type_emb")):
            val = 0.02 * torch.randn(shape, generator=gen)
        else:
            val = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
        state[name] = val
    return state


def _len_bucket(n: int, max_len: int) -> int:
    """Sequence-length buckets: a few fixed widths (bounded cuBLAS shape
    variety, as the reference bounds its jit recompiles)."""
    for b in (64, 128, 256, 512, 1024):
        if n <= b and b <= max_len:
            return b
    return max_len


def shipped_checkpoint() -> Path:
    """The pretrained encoder-mini checkpoint shipped with the JAX package
    (data files, read by path)."""
    root = Path(__file__).resolve().parents[2]
    return root / "semcode_tpu" / "assets" / "encoder-mini"


class EncoderEmbeddings:
    """embed_documents / embed_query provider backed by ``CodeEncoder``."""

    # windows per document: chunks run up to 200 lines (~1500 code tokens),
    # far beyond one max_len window — a prefix-truncated embedding simply
    # cannot see definitions in the back half of a chunk
    MAX_DOC_WINDOWS = 6
    # rows of every query forward (the reference pads small batches to 8)
    QUERY_ROWS = 8

    def __init__(
        self,
        preset: str = "mini",
        *,
        dim: Optional[int] = None,
        weights_path: Optional[Path] = None,
        batch_size: int = 64,
        max_tokens: int = 512,
        dtype: str = "bfloat16",
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        tdtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
            dtype, torch.bfloat16
        )
        if weights_path is None and preset == "mini":
            # shipped default, so provider=tpu-encoder and tpu-hybrid work
            # out of the box; an explicit weights_path or a non-default
            # preset overrides it
            if (shipped_checkpoint() / "semcode_encoder.msgpack").exists():
                weights_path = shipped_checkpoint()
        self.tokenizer = load_tokenizer(weights_path, 32768, max_tokens)
        self.cfg = EncoderConfig.preset(
            preset,
            vocab_size=self.tokenizer.vocab_size,
            max_len=max_tokens,
            dtype=tdtype,
        )
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.random_init = False
        if weights_path is not None and Path(weights_path).exists():
            wp = Path(weights_path)
            if (wp / "semcode_encoder.msgpack").exists():
                from .train import load_params

                # the checkpoint's config decides the model and its dtype
                params, self.cfg = load_params(wp)
                log.info("encoder_checkpoint_loaded", path=str(wp))
            else:
                from .hf_loader import load_hf_encoder_params

                params, self.cfg = load_hf_encoder_params(wp, self.cfg)
                log.info("encoder_weights_loaded", path=str(wp))
            state = encoder_state_from_jax(params)
        else:
            state = random_state(self.cfg, self.seed)
            self.random_init = True
            log.warning(
                "encoder_running_with_RANDOM_weights",
                preset=preset,
                detail=(
                    "provider=tpu-encoder has no checkpoint: embeddings are "
                    "random-init and retrieval quality will be poor. Set "
                    "encoder.weights_path to an HF checkpoint dir or a "
                    "trained checkpoint; or use provider=tpu-hash."
                ),
            )
        self.model = CodeEncoder(self.cfg)
        self.model.load_state_dict(state)
        self.model.to(self.device).eval().requires_grad_(False)
        self.dim = self.cfg.hidden
        if dim is not None and dim != self.dim:
            raise ValueError(
                f"embedding_dimension={dim} but the encoder produces "
                f"{self.dim}; set embedding.dimension = {self.dim}"
            )
        self._ckpt_dir = None if self.random_init else Path(weights_path)

    @property
    def signature(self) -> str:
        """Vector-definition identity: checkpoint fingerprint + output dim,
        byte-identical to the JAX package's for the same files. The port's
        random init is its own draw, so it does not share the reference's
        ``encoder:random`` signature."""
        if self._ckpt_dir is None:
            return f"encoder:torch-random:s{self.seed}:d{self.dim}"
        h = hashlib.sha1()
        for f in sorted(self._ckpt_dir.glob("*")):
            if f.is_file():
                h.update(f.name.encode())
                h.update(str(f.stat().st_size).encode())
                with open(f, "rb") as fh:  # first 4 MB: retrained params
                    h.update(fh.read(4 << 20))  # differ from byte ~0
        return f"encoder:{h.hexdigest()[:12]}:d{self.dim}"

    def forward_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(B, L) ids and mask -> (B, hidden) float32 unit rows, computed on
        the encoder's device."""
        with torch.inference_mode():
            out = self.model(
                torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(self.device),
                torch.from_numpy(np.asarray(mask, dtype=np.int64)).to(self.device),
            )
            return out.cpu().numpy()

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        """Single-window rows, each computed in a forward of a fixed shape:
        ``QUERY_ROWS`` rows at the bucket of its OWN length. A query's
        vector then does not depend on what it was batched with (the
        micro-batched API and an in-process batch give the same bits; a
        GEMM's rounding may change with its row count). The reference
        crops a batch to its longest row's bucket; the padding is masked,
        so the vectors are the same up to rounding."""
        # tokenize at FULL max_len first, then crop to the row's bucket: a
        # char-count estimate under-counts dense code (~1 token/char),
        # silently truncating queries the window could hold
        ids, mask = self.tokenizer.encode_batch(texts, max_len=self.cfg.max_len)
        buckets = np.asarray([
            _len_bucket(max(int(n), 1), self.cfg.max_len) for n in mask.sum(axis=1)
        ], dtype=np.int64)
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for bucket in sorted(set(buckets.tolist())):
            rows = np.flatnonzero(buckets == bucket)
            for lo in range(0, len(rows), self.QUERY_ROWS):
                sel = rows[lo : lo + self.QUERY_ROWS]
                g_ids = np.full((self.QUERY_ROWS, bucket), PAD_ID, dtype=np.int32)
                g_mask = np.zeros((self.QUERY_ROWS, bucket), dtype=np.int32)
                g_ids[: len(sel)] = ids[sel, :bucket]
                g_mask[: len(sel)] = mask[sel, :bucket]
                out[sel] = self.forward_ids(g_ids, g_mask)[: len(sel)]
        return out

    def _encode_rows(self, rows: Sequence[np.ndarray]) -> np.ndarray:
        """Encode pre-tokenized id rows (no CLS/padding) in one forward."""
        longest = max((len(r) + 1 for r in rows), default=1)
        bucket = _len_bucket(min(longest, self.cfg.max_len), self.cfg.max_len)
        n = len(rows)
        ids = np.full((n, bucket), PAD_ID, dtype=np.int32)
        mask = np.zeros((n, bucket), dtype=np.int32)
        ids[:, 0] = CLS_ID
        mask[:, 0] = 1
        for i, r in enumerate(rows):
            r = r[: bucket - 1]
            ids[i, 1 : 1 + len(r)] = r
            mask[i, 1 : 1 + len(r)] = 1
        return self.forward_ids(ids, mask)

    def embed_documents(self, texts: Sequence[str]) -> List[List[float]]:
        """Windowed document embedding: long chunks are split into
        ``max_len - 1``-token windows, each encoded separately, and the
        document vector is the length-weighted mean of its window embeddings
        (re-normalized)."""
        window = self.cfg.max_len - 1
        rows: List[np.ndarray] = []
        owners: List[int] = []
        weights: List[float] = []
        for di, t in enumerate(texts):
            tids = self.tokenizer.encode_ids(t, cap=window * self.MAX_DOC_WINDOWS)
            n_win = max(1, -(-len(tids) // window))
            for w in range(n_win):
                seg = tids[w * window : (w + 1) * window]
                rows.append(seg)
                owners.append(di)
                weights.append(float(max(len(seg), 1)))
        acc = np.zeros((len(texts), self.dim), dtype=np.float32)
        wsum = np.zeros((len(texts),), dtype=np.float32)
        for i in range(0, len(rows), self.batch_size):
            vecs = self._encode_rows(rows[i : i + self.batch_size])
            for v, o, w in zip(
                vecs,
                owners[i : i + self.batch_size],
                weights[i : i + self.batch_size],
            ):
                acc[o] += w * v
                wsum[o] += w
        acc /= np.maximum(wsum[:, None], 1e-9)
        acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-9)
        return [v.tolist() for v in acc]

    def embed_query(self, text: str) -> List[float]:
        return self._encode([text])[0].tolist()

    def embed_queries(self, texts: Sequence[str]) -> List[List[float]]:
        """Batched query embedding: single-window like embed_query (queries
        are short; the windowed length-weighted mean is a DOC-side scheme)."""
        out: List[List[float]] = []
        for i in range(0, len(texts), self.batch_size):
            vecs = self._encode(list(texts[i : i + self.batch_size]))
            out.extend(v.tolist() for v in vecs)
        return out
