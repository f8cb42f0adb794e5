"""GPT-2's forward in float32 plain ``torch``: the reference of the
``lm-gpt2-*`` configurations, and the operations and bytes their calls need.

The architecture as openai-community/gpt2's model card and ``config.json``
describe it (``GPT2LMHeadModel``): learned token and position embeddings,
``n_layer`` pre-LN blocks (LayerNorm with ``layer_norm_epsilon``; causal
multi-head attention of ``n_head`` heads with a joint ``c_attn`` projection
and ``c_proj``; an MLP of width ``n_inner`` (4 x ``n_embd`` where unset)
with GELU's tanh form, ``gelu_new``), a final LayerNorm and the head tied to
the token embedding. Kernels are Conv1D's (in, out), applied as
``x @ W + b``.

Departures from the published description: no dropout (inference); the
weights are the benchmark's, drawn from the seed (``weight_specs``), not the
trained ones; the padding mask is applied to keys as well as the causal one
(a right-padded row's real positions never see it). Everything runs in
float32 with TF32 held off, whatever dtype the weights are given in; no
cache, no batching trick: each row's full sequence is run from its first
token. It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

# (name, shape, dtype key, mean, std): the dtype key names the configuration's
# entry that gives the type the weights are served in
Spec = Tuple[str, Tuple[int, ...], str, float, float]
# rounds both operands of a product before it: (kind, a, b) -> (a, b); kinds
# "linear" (a block's activations and kernel), "attention", "head"
Operands = Callable[[str, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

WEIGHT_STD = 0.02  # GPT-2's initializer_range


def sizes(cfg: dict) -> dict:
    h = int(cfg["n_embd"])
    return {"h": h, "layers": int(cfg["n_layer"]), "heads": int(cfg["n_head"]),
            "m": int(cfg.get("n_inner") or 4 * h), "vocab": int(cfg["vocab_size"]),
            "positions": int(cfg["n_positions"]), "eps": float(cfg["layer_norm_epsilon"])}


def weight_specs(cfg: dict) -> List[Spec]:
    """Every weight, in order: embeddings and LayerNorms in ``head_dtype``
    (the tied head reads ``wte``), block kernels and biases in ``dtype``.
    Each is drawn as ``mean + std * N(0, 1)``: kernels, embeddings and
    biases at GPT-2's 0.02, LayerNorm scales around 1."""
    s = sizes(cfg)
    h, m = s["h"], s["m"]
    out: List[Spec] = [("wte", (s["vocab"], h), "head_dtype", 0.0, WEIGHT_STD),
                       ("wpe", (s["positions"], h), "head_dtype", 0.0, WEIGHT_STD)]
    for i in range(s["layers"]):
        p = f"h.{i}."
        out += [(p + "ln_1.weight", (h,), "head_dtype", 1.0, WEIGHT_STD),
                (p + "ln_1.bias", (h,), "head_dtype", 0.0, WEIGHT_STD)]
        for name, shape in (("attn.c_attn", (h, 3 * h)), ("attn.c_proj", (h, h))):
            out += [(p + name + ".weight", shape, "dtype", 0.0, WEIGHT_STD),
                    (p + name + ".bias", shape[1:], "dtype", 0.0, WEIGHT_STD)]
        out += [(p + "ln_2.weight", (h,), "head_dtype", 1.0, WEIGHT_STD),
                (p + "ln_2.bias", (h,), "head_dtype", 0.0, WEIGHT_STD)]
        for name, shape in (("mlp.c_fc", (h, m)), ("mlp.c_proj", (m, h))):
            out += [(p + name + ".weight", shape, "dtype", 0.0, WEIGHT_STD),
                    (p + name + ".bias", shape[1:], "dtype", 0.0, WEIGHT_STD)]
    out += [("ln_f.weight", (h,), "head_dtype", 1.0, WEIGHT_STD),
            ("ln_f.bias", (h,), "head_dtype", 0.0, WEIGHT_STD)]
    return out


def _plain(kind: str, a: torch.Tensor, b: torch.Tensor):
    return a, b


def _product(kind: str, a: torch.Tensor, b: torch.Tensor, operands: Operands) -> torch.Tensor:
    a, b = operands(kind, a, b)
    return a @ b


def _layer_norm(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"].float(),
                        w[name + ".bias"].float(), eps)


def _linear(x, w, name, operands):
    return _product("linear", x, w[name + ".weight"].float(), operands) + w[name + ".bias"].float()


def hidden(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
           operands: Operands = _plain) -> torch.Tensor:
    """The final LayerNorm's output (B, T, n_embd) over right-padded rows
    ``ids`` (B, T) with ``mask`` (B, T) marking the real tokens."""
    s = sizes(cfg)
    b, t = ids.shape
    nh, hd = s["heads"], s["h"] // s["heads"]
    dev = ids.device
    x = w["wte"].float()[ids] + w["wpe"].float()[torch.arange(t, device=dev)]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    keep = (causal[None] & (mask[:, None, :] > 0))[:, None]  # (B, 1, T, T)
    for i in range(s["layers"]):
        p = f"h.{i}."
        a = _linear(_layer_norm(x, w, p + "ln_1", s["eps"]), w, p + "attn.c_attn", operands)
        q, k, v = a.view(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4).unbind(0)
        scores = _product("attention", q, k.transpose(-1, -2), operands) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        o = _product("attention", probs, v, operands).transpose(1, 2).reshape(b, t, s["h"])
        x = x + _linear(o, w, p + "attn.c_proj", operands)
        f = _linear(_layer_norm(x, w, p + "ln_2", s["eps"]), w, p + "mlp.c_fc", operands)
        x = x + _linear(F.gelu(f, approximate="tanh"), w, p + "mlp.c_proj", operands)
    return _layer_norm(x, w, "ln_f", s["eps"])


def logits_at(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
              at: torch.Tensor, operands: Operands = _plain,
              rows: int = 8) -> torch.Tensor:
    """float32 logits (B, n, vocab) at positions ``at`` (B, n) of each row,
    computed ``rows`` rows at a time with TF32 held off (a control passes
    ``operands`` to round what it computes in)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        head = w["wte"].float().t()
        with torch.no_grad():
            for lo in range(0, ids.shape[0], rows):
                hi = min(lo + rows, ids.shape[0])
                x = hidden(w, cfg, ids[lo:hi], mask[lo:hi], operands)
                x = torch.gather(x, 1, at[lo:hi, :, None].expand(-1, -1, x.shape[-1]))
                out.append(_product("head", x, head, operands))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# -- the work a call needs, from the configuration and the mix alone ---------


def matrix_params(cfg: dict) -> Tuple[int, int]:
    """(the blocks' kernel parameters, the head's)."""
    s = sizes(cfg)
    h, m = s["h"], s["m"]
    return s["layers"] * (3 * h * h + h * h + 2 * h * m), s["vocab"] * h


def call_flops(cfg: dict, lens, max_new: int) -> float:
    """Model operations of one greedy call: rows of ``lens`` real prompt
    tokens (padding left out), ``max_new`` tokens each. Every processed
    token (the prompt's, then each generated token but the last) costs 2 x
    the blocks' kernel parameters and, in each layer, QK^T and PV over its
    real context (2 x 2 x n_embd x context); the head runs once for each
    generated token (2 x vocab x n_embd)."""
    s = sizes(cfg)
    blocks, head = matrix_params(cfg)
    total = 0.0
    for n in lens:
        tokens = int(n) + max_new - 1
        total += 2.0 * blocks * tokens + 2.0 * head * max_new
        total += s["layers"] * 4.0 * s["h"] * tokens * (tokens + 1) / 2
    return total


DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def weight_bytes(cfg: dict) -> float:
    """Bytes of every weight as served (``weight_specs``' dtypes), but the
    position embedding, of which a step reads one row a token."""
    total = 0
    for name, shape, key, _, _ in weight_specs(cfg):
        if name != "wpe":
            total += math.prod(shape) * DTYPE_BYTES[cfg[key]]
    return float(total)


def decode_step_bytes(cfg: dict, lens, step: int) -> float:
    """Bytes decode step ``step`` (1 .. max_new - 1) of a call must read: the
    weights as served, the tied head included, one row of each embedding a
    token in the compute dtype, and the K and V of each row's live cache
    slots (its real prompt and the ``step`` tokens generated before)."""
    s = sizes(cfg)
    dt = DTYPE_BYTES[cfg["dtype"]]
    live = sum(int(n) + step for n in lens)
    return (weight_bytes(cfg) + 2 * len(lens) * s["h"] * dt
            + 2.0 * s["layers"] * s["h"] * dt * live)
