"""The port's GPT-2, ``semcode_tpu_torch.models.decoder.CodeDecoder``, built
from the benchmark's weights: the system under test of the ``lm-gpt2-*``
configurations.

``build`` makes the module on the meta device and assigns it the weights
(``gpt2_reference.weight_specs``' names, in the dtypes the port holds:
float32 embeddings, LayerNorms and tied head, block kernels and biases in
the compute dtype), so nothing is drawn or copied on the host; the module's
own load hook then makes its compute-dtype embedding copies, as
``build_decoder`` does. ``generate`` is the timed call, the ``tpu-lm``
provider's engine call (``CodeDecoderLM.generate_ids``): greedy, the decode
step replayed as a CUDA graph on the card. ``eager`` is the same path
untimed, the prefill and the eager ``decode_step``, with a sampler that
keeps each step's logits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from semcode_tpu_torch.models import decoder as dec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# the reference's names -> the module's, in each block
BLOCK_NAMES = {"ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
               "attn.c_attn.weight": "c_attn.kernel", "attn.c_attn.bias": "c_attn.bias",
               "attn.c_proj.weight": "c_proj.kernel", "attn.c_proj.bias": "c_proj.bias",
               "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
               "mlp.c_fc.weight": "c_fc.kernel", "mlp.c_fc.bias": "c_fc.bias",
               "mlp.c_proj.weight": "mlp_proj.kernel", "mlp.c_proj.bias": "mlp_proj.bias"}


def decoder_config(cfg: dict) -> dec.DecoderConfig:
    h = int(cfg["n_embd"])
    return dec.DecoderConfig(vocab_size=int(cfg["vocab_size"]), hidden=h,
                             layers=int(cfg["n_layer"]), heads=int(cfg["n_head"]),
                             mlp_dim=int(cfg.get("n_inner") or 4 * h),
                             max_len=int(cfg["n_positions"]), dtype=DTYPES[cfg["dtype"]])


def state_of(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The module's ``state_dict`` names for the reference's."""
    out = {}
    for name, t in weights.items():
        if name.startswith("h."):
            _, i, rest = name.split(".", 2)
            out[f"blocks.{i}.{BLOCK_NAMES[rest]}"] = t
        else:
            out[name] = t
    return out


def build(cfg: dict, weights: Dict[str, torch.Tensor], device: torch.device):
    """A ``CodeDecoder`` holding ``weights`` (on ``device`` already), in
    inference mode."""
    dcfg = decoder_config(cfg)
    with torch.device("meta"):
        model = dec.CodeDecoder(dcfg)
    state = state_of(weights)
    held = dict(model.state_dict())
    for name, t in state.items():
        if name not in held or held[name].dtype != t.dtype or held[name].shape != t.shape:
            raise ValueError(f"{name}: the port holds {held.get(name)!r}, given "
                             f"{t.dtype} {tuple(t.shape)}")
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def bucket(cfg: dict, longest: int, max_new: int) -> int:
    """The prompt bucket the provider pads a prompt of ``longest`` tokens to
    (``CodeDecoderLM.prompt_arrays``)."""
    budget = int(cfg["n_positions"]) - max_new
    return dec.prompt_bucket(longest, budget)


def generate(model, ids: torch.Tensor, mask: torch.Tensor, max_new: int) -> torch.Tensor:
    """The timed call: (B, max_new) greedy tokens on the model's device."""
    return dec.generate_tokens(model, ids, mask, max_new=max_new)


def eager(model, ids: torch.Tensor, mask: torch.Tensor,
          max_new: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The timed path's prefill and decode step run eagerly: (B, max_new)
    greedy tokens, and the float32 logits (B, steps, vocab) each token was
    chosen from (steps is max_new unless a step failed to sample)."""
    dev = model.wte.device
    ids, mask = ids.to(dev).long(), mask.to(dev)
    kept = []

    def sample(logits):
        kept.append(logits.float().clone())
        return torch.argmax(logits, dim=-1)

    with torch.inference_mode(), model.decode_lock:
        st = dec._DecodeState(model.cfg, ids.shape[0], ids.shape[1], max_new, dev)
        dec._prefill_into(model, st, ids, mask, sample)
        for _ in range(max_new - 1):
            dec.decode_step(model, st, sample)
        return st.out.clone(), torch.stack(kept, 1)
