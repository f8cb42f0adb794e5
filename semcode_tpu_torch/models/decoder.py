"""Causal transformer LM for in-process answer synthesis (PyTorch).

Counterpart of ``semcode_tpu/models/decoder.py``: a GPT-2-family decoder
(pre-LN blocks, learned positions, final layernorm, tied LM head, tanh
GELU) that the ``tpu-lm`` provider runs on the card. It computes what the
JAX functions compute, operation by operation:

- layernorms in float32 with GPT-2's epsilon 1e-5, their output rounded to
  the compute dtype before each product;
- products ``x @ kernel`` in the compute dtype, THEN the bias added in the
  compute dtype (two roundings, as XLA's ``x @ W + b``; ``addmm`` would
  round once); the residual stream stays in the compute dtype;
- attention scores from a compute-dtype product, rounded, widened to
  float32 and scaled by ``1/sqrt(head_dim)``; masked slots get -1e30, the
  softmax runs in float32 and its result is rounded to the compute dtype
  before the product with V;
- the tied head in true float32 (``device.f32_matmul``): these logits
  decide the argmax.

Generation (``generate_tokens``) keeps the reference's semantics: the
prompt is right-padded to a bucket, the prefill fills cache slots
``[0, P)``, generated token *t* lands in slot ``P + t`` with position
``len + t``, there are ``max_new - 1`` decode steps and no early stop.
Where the JAX package compiles prefill + ``lax.scan`` into one program per
(bucket, max_new), this module runs the prefill eagerly and the decode
step over static buffers: the KV cache, slot mask, positions, write index
and token live on the device and the step updates them in place, so on the
card it is captured once per (B, bucket, max_new) in a CUDA graph and
replayed ``max_new - 1`` times with one host sync at the end. On the CPU
the same step runs eagerly. Sampled decoding (temperature > 0) runs the
step eagerly on every device: its generator is not registered with a
graph.

``TPDecoder`` is the same model with its weights split over model shards
(the LM trainer's tensor parallelism): its forward, and ``generate_tokens``
from it, run eagerly over the shards.

Weights come from the JAX package's files (``train_lm.load_lm_params``, a
local HF GPT-2 checkpoint) or from the seeded init, whose numpy draws are
the JAX package's, so the parameters are bit-identical; ``decoder_state_
from_jax`` turns a param tree into the module's ``state_dict``. The
products are cuBLAS GEMMs: the reference runs them in plain XLA, not in a
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, f32_matmul, resolve_device
from ..logger import get_logger
from ..ops.build import KernelError
from .encoder import DTYPE_NAMES, gather_last, partial_product, row_parallel

log = get_logger("models.decoder")

# The QA prompt grammar shared by training (train_lm.build_qa_texts) and
# inference (rag/llm.TPULocalChat.chat_structured). A corpus-fitted byte LM
# answers reliably ONLY in the exact format it was trained on — raw
# code-continuation training produces noise under chat prompts (measured:
# 3000 steps, next-token acc 0.96, chat output gibberish). Keep all three
# markers in sync; "###" doubles as the generation stop.
QA_CONTEXT = "### Context\n"
QA_QUESTION = "\n\n### Question\n"
QA_ANSWER = "\n\n### Answer\n"
QA_STOP = "\n###"
# context snippet budget (chars ~ byte tokens), SHARED by training and
# inference: a context longer than what training windows covered leaves
# the answer region untrained (measured: ctx 400 @ seq_len 384 -> the
# answer tail never fit a window -> chat noise at next-token acc 0.97).
# 200 ctx + ~40 question + ~220 answer + markers fits seq_len >= 512.
QA_CTX_CHARS = 200

LN_EPS = 1e-5  # GPT-2's (the encoder's flax layernorms use 1e-6)
MASKED = -1e30
DTYPES = {name: dtype for dtype, name in DTYPE_NAMES.items()}
PROMPT_BUCKETS = (128, 256, 512, 1024, 2048)


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 258  # byte tokenizer default (256 bytes + pad + eos)
    hidden: int = 384
    layers: int = 6
    heads: int = 6  # head_dim 64, GPT-2 convention
    mlp_dim: int = 1536
    max_len: int = 1024
    dtype: Any = torch.bfloat16

    @staticmethod
    def preset(name: str, *, vocab_size: int = 258, max_len: int = 1024,
               dtype: Any = torch.bfloat16) -> "DecoderConfig":
        table = {
            "mini": dict(hidden=384, layers=6, heads=6, mlp_dim=1536),
            "base": dict(hidden=768, layers=12, heads=12, mlp_dim=3072),
            "large": dict(hidden=1280, layers=36, heads=20, mlp_dim=5120),
        }
        if name not in table:
            raise ValueError(f"unknown decoder preset: {name}")
        return DecoderConfig(
            vocab_size=vocab_size, max_len=max_len, dtype=dtype, **table[name]
        )


# ---------------------------------------------------------------------------
# params (the JAX package's tree, numpy leaves)


def init_params(cfg: DecoderConfig, seed: int = 0) -> dict:
    """Seeded GPT-2-shaped init (normal 0.02, zero biases, unit LN scales):
    the JAX package's numpy draws in its order, so the values are its own."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0.0, 0.02, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    h, m = cfg.hidden, cfg.mlp_dim
    params: dict = {
        "wte": w(cfg.vocab_size, h),
        "wpe": w(cfg.max_len, h),
        "ln_f": {"scale": ones(h), "bias": zeros(h)},
        "blocks": [],
    }
    for _ in range(cfg.layers):
        params["blocks"].append(
            {
                "ln_1": {"scale": ones(h), "bias": zeros(h)},
                "attn": {
                    "c_attn": {"kernel": w(h, 3 * h), "bias": zeros(3 * h)},
                    "c_proj": {"kernel": w(h, h), "bias": zeros(h)},
                },
                "ln_2": {"scale": ones(h), "bias": zeros(h)},
                "mlp": {
                    "c_fc": {"kernel": w(h, m), "bias": zeros(m)},
                    "c_proj": {"kernel": w(m, h), "bias": zeros(h)},
                },
            }
        )
    return params


def load_hf_decoder_params(
    path: Path, dtype: Any = torch.bfloat16
) -> Tuple[dict, DecoderConfig]:
    """Load a local HF GPT-2-family checkpoint (config.json + safetensors,
    or pytorch_model.bin). GPT-2's Conv1D stores kernels as (in, out),
    applied as ``x @ W + b``: the orientation of this module's tree."""
    from .hf_loader import _read_weights

    path = Path(path)
    hf = json.loads((path / "config.json").read_text(encoding="utf-8"))
    cfg = DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden=hf["n_embd"],
        layers=hf["n_layer"],
        heads=hf["n_head"],
        mlp_dim=hf.get("n_inner") or 4 * hf["n_embd"],
        max_len=hf.get("n_positions", 1024),
        dtype=dtype,
    )
    raw = {k.removeprefix("transformer."): v for k, v in _read_weights(path).items()}

    def g(name: str) -> np.ndarray:
        return np.asarray(raw[name])

    def dense(name: str) -> dict:
        return {"kernel": g(name + ".weight"), "bias": g(name + ".bias")}

    def ln(name: str) -> dict:
        return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}

    params: dict = {"wte": g("wte.weight"), "wpe": g("wpe.weight"),
                    "ln_f": ln("ln_f"), "blocks": []}
    for i in range(cfg.layers):
        p = f"h.{i}."
        params["blocks"].append({
            "ln_1": ln(p + "ln_1"),
            "attn": {"c_attn": dense(p + "attn.c_attn"),
                     "c_proj": dense(p + "attn.c_proj")},
            "ln_2": ln(p + "ln_2"),
            "mlp": {"c_fc": dense(p + "mlp.c_fc"), "c_proj": dense(p + "mlp.c_proj")},
        })
    log.info("decoder_weights_loaded", path=str(path), layers=cfg.layers,
             hidden=cfg.hidden, vocab=cfg.vocab_size)
    return params, cfg


def decoder_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The decoder's param tree (``init_params``, ``load_hf_decoder_params``
    or ``train_lm.load_lm_params``; numpy or JAX leaves) -> ``CodeDecoder``'s
    ``state_dict`` (float32; ``load_state_dict`` rounds the products'
    kernels and biases to the model's dtype once, the rounding the
    reference's per-call ``astype`` makes)."""

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x), dtype=np.float32))

    state = {"wte": t(params["wte"]), "wpe": t(params["wpe"]),
             "ln_f.weight": t(params["ln_f"]["scale"]),
             "ln_f.bias": t(params["ln_f"]["bias"])}
    for i, bp in enumerate(params["blocks"]):
        p = f"blocks.{i}."
        for name, tree in (("ln_1", bp["ln_1"]), ("ln_2", bp["ln_2"])):
            state[p + name + ".weight"] = t(tree["scale"])
            state[p + name + ".bias"] = t(tree["bias"])
        for name, tree in (("c_attn", bp["attn"]["c_attn"]),
                           ("c_proj", bp["attn"]["c_proj"]),
                           ("c_fc", bp["mlp"]["c_fc"]),
                           ("mlp_proj", bp["mlp"]["c_proj"])):
            state[p + name + ".kernel"] = t(tree["kernel"])
            state[p + name + ".bias"] = t(tree["bias"])
    return state


def decoder_state_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``decoder_state_from_jax``: a ``CodeDecoder`` state
    (any device and float dtype; the ``wte_c`` / ``wpe_c`` casts are not
    part of it) -> the param tree with float32 numpy leaves, which
    ``train_lm.save_lm_params`` writes."""

    def n(name) -> np.ndarray:
        return state[name].detach().to("cpu", torch.float32).numpy().copy()

    def ln(pre: str) -> dict:
        return {"scale": n(pre + ".weight"), "bias": n(pre + ".bias")}

    def dense(pre: str) -> dict:
        return {"kernel": n(pre + ".kernel"), "bias": n(pre + ".bias")}

    params: dict = {"wte": n("wte"), "wpe": n("wpe"), "ln_f": ln("ln_f"), "blocks": []}
    i = 0
    while f"blocks.{i}.c_attn.kernel" in state:
        p = f"blocks.{i}."
        params["blocks"].append({
            "ln_1": ln(p + "ln_1"),
            "attn": {"c_attn": dense(p + "c_attn"), "c_proj": dense(p + "c_proj")},
            "ln_2": ln(p + "ln_2"),
            "mlp": {"c_fc": dense(p + "c_fc"), "c_proj": dense(p + "mlp_proj")},
        })
        i += 1
    return params


# ---------------------------------------------------------------------------
# the module


class _Dense(nn.Module):
    """``x @ kernel + bias``: kernel (in, out) and bias kept in the compute
    dtype; product and sum are rounded apart, as in the reference."""

    def __init__(self, n_in: int, n_out: int, dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.kernel) + self.bias


def _layer_norm(hidden: int) -> nn.LayerNorm:
    return nn.LayerNorm(hidden, eps=LN_EPS, dtype=torch.float32)


class _Block(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.heads = cfg.heads
        self.head_dim = cfg.hidden // cfg.heads
        self.scale = 1.0 / math.sqrt(self.head_dim)
        self.ln_1 = _layer_norm(cfg.hidden)
        self.c_attn = _Dense(cfg.hidden, 3 * cfg.hidden, cfg.dtype)
        self.c_proj = _Dense(cfg.hidden, cfg.hidden, cfg.dtype)
        self.ln_2 = _layer_norm(cfg.hidden)
        self.c_fc = _Dense(cfg.hidden, cfg.mlp_dim, cfg.dtype)
        self.mlp_proj = _Dense(cfg.mlp_dim, cfg.hidden, cfg.dtype)

    def qkv(self, x: torch.Tensor):
        """(B, T, hidden) -> q, k, v as (B, heads, T, head_dim)."""
        b, t, _ = x.shape
        h = self.ln_1(x.float()).to(self.dtype)
        qkv = self.c_attn(h).view(b, t, 3, self.heads, self.head_dim)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def attend(self, x, q, k, v, keep):
        """Attention of q over (k, v) where ``keep`` (broadcast to the
        scores' (B, heads, Tq, Tk)) is true, then the block's tail."""
        x = x + self.c_proj(_attention(q, k, v, keep, self.scale, self.dtype))
        h = self.ln_2(x.float()).to(self.dtype)
        return x + self.mlp_proj(F.gelu(self.c_fc(h), approximate="tanh"))


def _attention(q, k, v, keep, scale: float, dtype) -> torch.Tensor:
    """float32 scores of compute-dtype products, masked with -1e30, a
    float32 softmax rounded to ``dtype``, its product with v -> (B, Tq,
    heads * head_dim)."""
    b, _, t, _ = q.shape
    scores = (q @ k.transpose(-1, -2)).float() * scale
    scores = torch.where(keep, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return (probs @ v).transpose(1, 2).reshape(b, t, -1)


class CodeDecoder(nn.Module):
    """GPT-2 decoder. ``forward(ids, mask)`` gives teacher-forced logits;
    ``generate_tokens`` drives the prefill and the KV-cached decode step.

    ``wte`` stays float32 for the tied head; ``wte_c`` / ``wpe_c`` are its
    and the positions' compute-dtype copies for the embeddings, made once
    at load. ``decode_lock`` guards the captured graphs' static buffers:
    one generation at a time per model, as one card runs one program at a
    time. ``counts`` tallies prefills, decode steps, graph captures and
    replays."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden))
        self.wpe = nn.Parameter(torch.zeros(cfg.max_len, cfg.hidden))
        self.ln_f = _layer_norm(cfg.hidden)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))
        self.register_buffer("wte_c", self.wte.detach().to(cfg.dtype), persistent=False)
        self.register_buffer("wpe_c", self.wpe.detach().to(cfg.dtype), persistent=False)
        self.register_load_state_dict_post_hook(_refresh_casts)
        self.decode_lock = threading.Lock()
        self.graphs: Dict[tuple, "_GraphedStep"] = {}
        self.counts = dict.fromkeys(
            ("prefills", "decode_steps", "graph_captures", "graph_replays"), 0)

    def embed(self, ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return self.wte_c[ids] + self.wpe_c[pos]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head in true float32 (the logits decide the argmax)."""
        h = self.ln_f(x.float())
        return f32_matmul(h, self.wte.t())

    def prefill(self, ids: torch.Tensor, mask: torch.Tensor):
        """Causal forward over the right-padded prompt: the last hidden
        states (B, T, hidden) and each layer's k, v (B, heads, T, hd)."""
        t = ids.shape[1]
        x = self.embed(ids, torch.arange(t, device=ids.device))
        causal = torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()
        keep = (causal[None] & (mask[:, None, :] > 0))[:, None]
        kv = []
        for block in self.blocks:
            q, k, v = block.qkv(x)
            x = block.attend(x, q, k, v, keep)
            kv.append((k, v))
        return x, kv

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.logits(self.prefill(ids, mask)[0])


def _refresh_casts(module: CodeDecoder, _incompatible) -> None:
    module.wte_c = module.wte.detach().to(module.cfg.dtype)
    module.wpe_c = module.wpe.detach().to(module.cfg.dtype)
    module.graphs.clear()  # captured against the old weights


def build_decoder(params: Dict[str, Any], cfg: DecoderConfig,
                  device: DeviceLike = None) -> CodeDecoder:
    """A ``CodeDecoder`` holding ``params`` (the JAX tree) on ``device``
    (CUDA unless asked for the CPU), in inference mode."""
    dev = resolve_device(device)
    model = CodeDecoder(cfg)
    model.load_state_dict(decoder_state_from_jax(params))
    return model.to(dev).eval().requires_grad_(False)


class TPDecoder:
    """``CodeDecoder``'s function with its blocks split over model shards
    (``train_lm.param_spec_lm``), run eagerly: the LM trainer's forward on
    a mesh with a ``"model"`` axis, and ``generate_tokens`` from its
    sharded state (``LMTrainer.decoder``).

    ``weights`` holds each ``state_dict`` name in the module's dtype, and
    ``wte_c`` / ``wpe_c`` (the embeddings' compute-dtype casts): a
    replicated one as a tensor on ``devices[0]``, a split one as its
    pieces, piece ``m`` on ``devices[m]``. Megatron's layout: ``c_attn``
    and ``c_fc`` are column-parallel (``c_attn`` by heads, its q, k and v
    columns of each shard's heads side by side), both ``c_proj`` are
    row-parallel, their float32 partial products summed on ``devices[0]``
    (``encoder.row_parallel``: the all-reduce), rounded and then given the
    bias, the two roundings of the one-device ``_Dense``; the token
    embedding's hidden slices are concatenated (the all-gather) and the
    tied float32 head sums the partial products of ``wte``'s hidden slices.
    The reference shards ``c_attn`` by contiguous output columns
    (``P(None, "model")``); GSPMD computes the same function from either
    layout, so the logits are the one-device forward's up to the order of
    the float sums. Layernorms and the residual stream run on
    ``devices[0]`` with the one-device roundings."""

    def __init__(self, cfg: DecoderConfig, devices, weights: Dict[str, Any]):
        self.cfg = cfg
        self.devices = list(devices)
        self.home = self.devices[0]
        self.w = weights
        self.heads = cfg.heads // len(self.devices)
        self.head_dim = cfg.hidden // cfg.heads
        self.scale = 1.0 / math.sqrt(self.head_dim)

    def _ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], LN_EPS)

    def embed(self, ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        parts = [wte[ids.to(dev)] for wte, dev in zip(self.w["wte_c"], self.devices)]
        return gather_last(parts, self.home) + self.w["wpe_c"][pos]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        h = self._ln("ln_f", x).chunk(len(self.devices), dim=-1)
        return row_parallel([f32_matmul(hs.to(dev), wte.t())
                             for hs, wte, dev in zip(h, self.w["wte"], self.devices)],
                            self.home)

    def qkv(self, i: int, x: torch.Tensor):
        """Block ``i``'s q, k, v of every shard's heads, each (B, heads /
        shards, T, head_dim) on the shard's device."""
        b, t, _ = x.shape
        pre, w = f"blocks.{i}.", self.w
        h = self._ln(pre + "ln_1", x).to(self.cfg.dtype)
        out = []
        for s, dev in enumerate(self.devices):
            qkv = (h.to(dev) @ w[pre + "c_attn.kernel"][s]) + w[pre + "c_attn.bias"][s]
            out.append(qkv.view(b, t, 3, self.heads, self.head_dim)
                       .permute(2, 0, 3, 1, 4).unbind(0))
        return out

    def attend(self, i: int, x: torch.Tensor, qkv, keeps) -> torch.Tensor:
        """Block ``i`` after its q/k/v: each shard's heads attend over its
        (k, v) where its ``keeps`` entry is true, then the block's tail."""
        pre, w, dt = f"blocks.{i}.", self.w, self.cfg.dtype
        parts = [partial_product(_attention(q, k, v, keep, self.scale, dt),
                                 w[pre + "c_proj.kernel"][s])
                 for s, ((q, k, v), keep) in enumerate(zip(qkv, keeps))]
        x = x + (row_parallel(parts, self.home).to(dt) + w[pre + "c_proj.bias"])
        h = self._ln(pre + "ln_2", x).to(dt)
        parts = [
            partial_product(F.gelu((h.to(dev) @ w[pre + "c_fc.kernel"][s])
                                   + w[pre + "c_fc.bias"][s], approximate="tanh"),
                            w[pre + "mlp_proj.kernel"][s])
            for s, dev in enumerate(self.devices)
        ]
        return x + (row_parallel(parts, self.home).to(dt) + w[pre + "mlp_proj.bias"])

    def prefill(self, ids: torch.Tensor, mask: torch.Tensor):
        """``CodeDecoder.prefill``: the last hidden states and, per layer,
        each shard's (k, v) of its heads."""
        t = ids.shape[1]
        x = self.embed(ids, torch.arange(t, device=ids.device))
        causal = torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()
        keep = (causal[None] & (mask[:, None, :] > 0))[:, None]
        keeps = [keep.to(dev) for dev in self.devices]
        kv = []
        for i in range(self.cfg.layers):
            qkv = self.qkv(i, x)
            x = self.attend(i, x, qkv, keeps)
            kv.append([(k, v) for _, k, v in qkv])
        return x, kv

    def __call__(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced float32 logits (B, T, vocab) on ``devices[0]``."""
        return self.logits(self.prefill(ids, mask)[0])


@torch.inference_mode()
def forward_logits(model: CodeDecoder, ids, mask) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab), float32."""
    dev = model.wte.device
    return model(torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))


# ---------------------------------------------------------------------------
# generation


class _DecodeState:
    """The decode step's buffers, all on the device and updated in place:
    KV caches (layers, B, heads, P + max_new, head_dim) in the compute
    dtype (head-major, so the products read each head's slots without a
    copy), the slot mask, the current token, positions, the cache slot and
    output column to write, and the output (B, max_new)."""

    def __init__(self, cfg: DecoderConfig, b: int, p_len: int, max_new: int, dev):
        hd = cfg.hidden // cfg.heads
        total = p_len + max_new
        self.p_len = p_len
        self.k = torch.zeros(cfg.layers, b, cfg.heads, total, hd, dtype=cfg.dtype, device=dev)
        self.v = torch.zeros_like(self.k)
        self.slot_mask = torch.zeros(b, total, dtype=torch.bool, device=dev)
        self.tok = torch.zeros(b, dtype=torch.long, device=dev)
        self.pos = torch.zeros(b, dtype=torch.long, device=dev)
        self.write = torch.zeros(1, dtype=torch.long, device=dev)
        self.col = torch.zeros(1, dtype=torch.long, device=dev)
        self.out = torch.zeros(b, max_new, dtype=torch.long, device=dev)

    def reset(self, mask: Optional[torch.Tensor] = None) -> None:
        """Back to the state after a prefill of ``mask`` (decode steps
        only: the caches keep what they hold)."""
        self.write.fill_(self.p_len)
        self.col.fill_(1)
        if mask is not None:
            self.slot_mask.zero_()
            self.slot_mask[:, : self.p_len] = mask > 0
            self.pos.copy_(mask.sum(1))


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)  # the first index wins a tie


class _Sampler:
    """Temperature sampling from an explicit generator (eager steps only)."""

    def __init__(self, temperature: float, generator: torch.Generator):
        self.temperature = max(float(temperature), 1e-4)
        self.generator = generator

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]


def decode_step(model: CodeDecoder, st: _DecodeState, sample=_greedy) -> None:
    """One token for every row: embed ``st.tok`` at ``st.pos``, write each
    layer's k/v at cache slot ``st.write``, attend over the set slots, and
    write the next token into ``st.tok`` and ``st.out[:, st.col]``. No
    host sync: every index is a device tensor."""
    st.slot_mask.index_fill_(1, st.write, True)
    x = model.embed(st.tok, st.pos)[:, None]  # (B, 1, hidden)
    keep = st.slot_mask[:, None, None, :]
    for li, block in enumerate(model.blocks):
        q, k, v = block.qkv(x)
        kc, vc = st.k[li], st.v[li]
        kc.index_copy_(2, st.write, k)
        vc.index_copy_(2, st.write, v)
        x = block.attend(x, q, kc, vc, keep)
    nxt = sample(model.logits(x)[:, 0])
    st.out.index_copy_(1, st.col, nxt[:, None])
    st.tok.copy_(nxt)
    st.pos.add_(1)
    st.write.add_(1)
    st.col.add_(1)


def _generate_sharded(model: TPDecoder, ids, mask, max_new: int, sample) -> torch.Tensor:
    """``generate_tokens`` over model shards, eagerly: the prefill and
    decode steps of ``_prefill_into`` / ``decode_step``, each shard's KV
    cache holding its own heads on its device (a ``_DecodeState`` of its
    width, with its own slot mask and write index there); shard 0's state
    keeps the tokens, positions and output."""
    cfg, n = model.cfg, len(model.devices)
    b, p_len = ids.shape
    part = dataclasses.replace(cfg, heads=cfg.heads // n, hidden=cfg.hidden // n)
    states = [_DecodeState(part, b, p_len, max_new, dev) for dev in model.devices]
    x, kv = model.prefill(ids, mask)
    for s, st in enumerate(states):
        for li, layer in enumerate(kv):
            st.k[li, :, :, :p_len] = layer[s][0]
            st.v[li, :, :, :p_len] = layer[s][1]
        st.reset(mask.to(st.k.device))
    main = states[0]
    rows = torch.arange(b, device=ids.device)
    tok0 = sample(model.logits(x[rows, main.pos - 1]))
    main.tok.copy_(tok0)
    main.out[:, 0] = tok0
    for _ in range(max_new - 1):
        for st in states:
            st.slot_mask.index_fill_(1, st.write, True)
        x = model.embed(main.tok, main.pos)[:, None]
        keeps = [st.slot_mask[:, None, None, :] for st in states]
        for li in range(cfg.layers):
            cached = []
            for st, (q, k, v) in zip(states, model.qkv(li, x)):
                st.k[li].index_copy_(2, st.write, k)
                st.v[li].index_copy_(2, st.write, v)
                cached.append((q, st.k[li], st.v[li]))
            x = model.attend(li, x, cached, keeps)
        nxt = sample(model.logits(x)[:, 0])
        main.out.index_copy_(1, main.col, nxt[:, None])
        main.tok.copy_(nxt)
        main.pos.add_(1)
        main.col.add_(1)
        for st in states:
            st.write.add_(1)
    return main.out.clone()


class _GraphedStep:
    """``decode_step`` captured once in a CUDA graph over its own static
    buffers (warm-up runs on a side stream first, a private memory pool).
    The capture is thread-local: the API's other threads (retrieval,
    ingest) keep launching on the card meanwhile."""

    def __init__(self, model: CodeDecoder, cfg, b: int, p_len: int, max_new: int, dev):
        self.state = _DecodeState(cfg, b, p_len, max_new, dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(2):
                self.state.reset()
                decode_step(model, self.state)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.state.reset()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            decode_step(model, self.state)
        model.counts["graph_captures"] += 1


def _prefill_into(model: CodeDecoder, st: _DecodeState, ids, mask, sample) -> None:
    """Prompt forward; caches, state and ``st.out[:, 0]`` set for step 0."""
    x, kv = model.prefill(ids, mask)
    st.k.zero_()
    st.v.zero_()
    for li, (k, v) in enumerate(kv):
        st.k[li, :, :, : st.p_len] = k
        st.v[li, :, :, : st.p_len] = v
    st.reset(mask)
    rows = torch.arange(ids.shape[0], device=ids.device)
    last = x[rows, st.pos - 1]  # the hidden state at the last real token
    tok0 = sample(model.logits(last))
    st.tok.copy_(tok0)
    st.out[:, 0] = tok0
    model.counts["prefills"] += 1


@torch.inference_mode()
def generate_tokens(
    model: CodeDecoder,
    ids,
    mask,
    *,
    max_new: int,
    greedy: bool = True,
    temperature: float = 1.0,
    seed: int = 0,
    graph: Optional[bool] = None,
) -> torch.Tensor:
    """Generate ``max_new`` tokens after each right-padded prompt row.
    Returns (B, max_new) int64 on the model's device.

    ``graph`` (default: on CUDA when greedy) replays the captured decode
    step; ``graph=False`` runs the same step eagerly (the plain version,
    and the CPU's path). Sampling draws from a ``torch.Generator`` seeded
    with ``seed`` on every call, eagerly. On the card any failure of the
    prefill, the capture or a replay is a ``KernelError``: there is no
    retry on another path.

    ``model`` may also be a ``TPDecoder`` (the LM trainer's sharded state,
    ``LMTrainer.decoder``): its steps run eagerly over the model shards,
    every row's tokens those of the one-device path up to the order of the
    float sums; the CUDA graph stays the one-device serving path."""
    sharded = isinstance(model, TPDecoder)
    dev = model.home if sharded else model.wte.device
    ids = torch.as_tensor(ids, device=dev).long()
    mask = torch.as_tensor(mask, device=dev)
    b, p_len = ids.shape
    if graph is None:
        graph = dev.type == "cuda" and greedy and not sharded
    if graph and (dev.type != "cuda" or not greedy or sharded):
        raise ValueError("a graphed decode needs a one-device CUDA model and "
                         "greedy decoding")
    if greedy:
        sample = _greedy
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        sample = _Sampler(temperature, gen)
    if sharded:
        return _generate_sharded(model, ids, mask, max_new, sample)
    with model.decode_lock:
        try:
            if graph:
                key = (b, p_len, max_new)
                step = model.graphs.get(key)
                if step is None and max_new > 1:
                    step = model.graphs[key] = _GraphedStep(
                        model, model.cfg, b, p_len, max_new, dev)
                st = step.state if step else _DecodeState(model.cfg, b, p_len, max_new, dev)
                _prefill_into(model, st, ids, mask, sample)
                for _ in range(max_new - 1):
                    step.graph.replay()
                model.counts["graph_replays"] += max_new - 1
            else:
                st = _DecodeState(model.cfg, b, p_len, max_new, dev)
                _prefill_into(model, st, ids, mask, sample)
                for _ in range(max_new - 1):
                    decode_step(model, st, sample)
            model.counts["decode_steps"] += max_new - 1
            out = st.out.clone()
            if dev.type == "cuda":  # the one host sync: a fault surfaces here
                torch.cuda.current_stream(dev).synchronize()
            return out
        except KernelError:
            raise
        except RuntimeError as exc:
            if dev.type != "cuda":
                raise
            raise KernelError(f"decoder generation failed on {dev}: {exc}") from exc


def prompt_bucket(n: int, max_len: int) -> int:
    """Static prompt-length buckets (one captured graph each)."""
    for b in PROMPT_BUCKETS:
        if n <= b and b <= max_len:
            return b
    return max_len


class CodeDecoderLM:
    """Host-side wrapper: text in, text out, static shapes inside.

    ``device`` (CUDA unless ``"cpu"`` or ``$SEMCODE_TORCH_DEVICE``) holds
    the weights. A directory with ``semcode_lm.msgpack`` is a checkpoint
    written by either package's ``save_lm_params`` (byte tokenizer); any
    other existing directory is a local HF GPT-2 checkpoint; without one the
    decoder runs the seeded init and warns."""

    def __init__(
        self,
        preset: str = "mini",
        *,
        weights_path: Optional[Path] = None,
        max_len: int = 1024,
        dtype: str = "bfloat16",
        seed: int = 0,
        device: DeviceLike = None,
    ):
        from .tokenizer import load_lm_tokenizer

        tdtype = DTYPES.get(dtype, torch.bfloat16)
        self.tokenizer = load_lm_tokenizer(weights_path, max_len)
        self.random_init = False
        if weights_path is not None and Path(weights_path).exists():
            wp = Path(weights_path)
            if (wp / "semcode_lm.msgpack").exists():
                from .train_lm import load_lm_params

                params, cfg = load_lm_params(wp, dtype=tdtype)
                log.info("decoder_checkpoint_loaded", path=str(wp))
            else:
                params, cfg = load_hf_decoder_params(wp, dtype=tdtype)
        else:
            cfg = DecoderConfig.preset(
                preset, vocab_size=self.tokenizer.vocab_size, max_len=max_len,
                dtype=tdtype,
            )
            params = init_params(cfg, seed=seed)
            self.random_init = True
            log.warning(
                "decoder_running_with_RANDOM_weights",
                preset=preset,
                detail=(
                    "provider=tpu-lm has no checkpoint: generated answers "
                    "will be noise. Set rag.weights_path to a local HF "
                    "GPT-2-family checkpoint dir, or use the extractive "
                    "fallback (provider=fallback)."
                ),
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        try:
            self.model = build_decoder(params, cfg, self.device)
        except RuntimeError as exc:
            if self.device.type != "cuda":
                raise
            raise KernelError(f"decoder weights failed to load on {self.device}: {exc}") from exc

    def _budget(self, max_new_tokens: int) -> Tuple[int, int]:
        # clamp: max_new_tokens >= max_len (a raw settings knob) would make
        # the prompt budget zero/negative — zero-width prompt arrays and a
        # wrong-end slice. Always leave at least 16 prompt tokens.
        max_new = max(1, min(int(max_new_tokens), self.cfg.max_len - 16))
        return max_new, self.cfg.max_len - max_new

    def prompt_arrays(self, prompt: str, max_new_tokens: int):
        """(ids, mask, max_new): the prompt's tail within the budget,
        right-padded to its bucket, and the clamped token count."""
        ids = self.tokenizer.encode(prompt)
        max_new, budget = self._budget(max_new_tokens)
        if len(ids) > budget:
            ids = ids[-budget:]  # keep the tail: question + nearest context
        bucket = prompt_bucket(len(ids), budget)
        arr = np.zeros((1, bucket), dtype=np.int64)
        msk = np.zeros((1, bucket), dtype=np.int64)
        arr[0, : len(ids)] = ids
        msk[0, : len(ids)] = 1
        return arr, msk, max_new

    def generate_ids(self, prompt: str, *, max_new_tokens: int = 128,
                     temperature: float = 0.0, seed: int = 0) -> list:
        arr, msk, max_new = self.prompt_arrays(prompt, max_new_tokens)
        toks = generate_tokens(
            self.model, arr, msk, max_new=max_new, greedy=temperature <= 0.0,
            temperature=max(temperature, 1e-4), seed=seed,
        )
        return toks[0].tolist()

    def generate(self, prompt: str, *, max_new_tokens: int = 128,
                 temperature: float = 0.0, seed: int = 0) -> str:
        return self.tokenizer.decode(self.generate_ids(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature, seed=seed))

    def warm(self, max_new_tokens: int) -> list:
        """Run one greedy generation at every bucket a prompt can take under
        ``max_new_tokens`` (on the card: load and capture each bucket's
        decode graph). Returns the buckets."""
        max_new, budget = self._budget(max_new_tokens)
        buckets = sorted({prompt_bucket(n, budget) for n in (*PROMPT_BUCKETS, budget)
                          if n <= budget})
        for bucket in buckets:
            ids = np.full((1, bucket), 2, dtype=np.int64)
            generate_tokens(self.model, ids, np.ones_like(ids), max_new=max_new)
        return buckets
