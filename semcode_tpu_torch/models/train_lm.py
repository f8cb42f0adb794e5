"""Next-token training of the answer decoder, and its checkpoints.

Counterpart of ``semcode_tpu/models/train_lm.py``: ``LMTrainer`` (masked
next-token cross entropy under ``adamw(3e-4, weight_decay=0.01)``),
``build_qa_texts`` (the QA-grammar examples, equal strings) and
``WindowBatcher`` (random fixed-length windows; the same seed gives the
same batches, bit for bit, the anchored QA mix included). As the
reference, ``LMTrainer`` takes a ``(data, model)`` mesh: the batch splits
over ``"data"``, and ``param_spec_lm`` splits ``c_attn`` / ``c_fc`` (output
dim), both ``c_proj`` (input dim) and ``wte`` (hidden) over ``"model"``,
run by ``decoder.TPDecoder``; ``LMTrainer.decoder`` hands the sharded state
to ``decoder.generate_tokens``. As in ``train.ContrastiveTrainer``, the
weights are float32 masters and the forward runs ``CodeDecoder`` on their
casts (``functional_call``); the embeddings' compute-dtype buffers
``wte_c`` / ``wpe_c`` are fed casts of the masters, so ``wte`` gets its
gradient from both the embedding and the tied head and ``wpe`` gets one at
all, as in the reference's ``forward_logits``. ``init_state`` starts from
``decoder.init_params``, whose values are the JAX package's.

The files are the JAX package's, read and written without flax:

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
import re
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..device import DeviceLike
from ..parallel.mesh import Mesh
from .decoder import (
    DTYPES,
    QA_ANSWER,
    QA_CONTEXT,
    QA_CTX_CHARS,
    QA_QUESTION,
    CodeDecoder,
    DecoderConfig,
    TPDecoder,
    build_decoder,
    decoder_state_from_jax,
    decoder_state_to_jax,
    init_params,
)
from .encoder import DTYPE_NAMES
from .train import (
    MasterTrainer,
    Schedule,
    Split,
    sum_parts,
    param_spec,
    params_from_bytes,
    params_to_bytes,
)

PARAMS_FILE = "semcode_lm.msgpack"
CONFIG_FILE = "semcode_lm.json"


# CodeDecoder's state_dict names (``_Dense`` kernels are (in, out))
DECODER_SPLITS = {
    "c_attn.kernel": Split(1, 3),  # column-parallel, by heads
    "c_attn.bias": Split(0, 3),
    "c_proj.kernel": Split(0),  # row-parallel: the input dim
    "c_fc.kernel": Split(1),  # column-parallel
    "c_fc.bias": Split(0),
    "mlp_proj.kernel": Split(0),  # row-parallel
    "wte": Split(1),  # (vocab, hidden): the hidden dim; the head sums
}


def param_spec_lm(name: str) -> Optional[Split]:
    """Tensor-parallel rule of a decoder ``state_dict`` name: the
    counterpart of the reference's ``param_spec_lm`` (``c_attn`` / ``c_fc``
    on the output dim, both ``c_proj`` on the input dim, ``wte`` on hidden;
    ``wpe``, layernorms and the row-parallel biases replicated). The
    reference splits the fused ``c_attn`` into contiguous output columns;
    here it is split by heads within each of q, k and v (Megatron's
    layout), so every shard's attention reads its own heads. GSPMD computes
    the same function from either layout."""
    return param_spec(name, DECODER_SPLITS)


class LMTrainer(MasterTrainer):
    """Masked next-token steps of the decoder; ``init_state`` starts from
    ``decoder.init_params``. ``decoder.decoder_state_to_jax(trainer.gather(
    params))`` is the JAX tree of the masters.

    On a mesh each data replica computes its rows' logits (through
    ``decoder.TPDecoder`` over its model shards when there are several) and
    the sums of its masked cross entropy, hits and valid targets; the sums
    meet on ``mesh.home``, so the loss is the whole batch's masked mean, as
    in the reference."""

    def __init__(
        self,
        cfg: DecoderConfig,
        mesh: Optional[Mesh] = None,
        *,
        learning_rate: Union[float, Schedule] = 3e-4,
        weight_decay: float = 0.01,
        device: DeviceLike = None,
    ):
        super().__init__(CodeDecoder(cfg), learning_rate, weight_decay, device, mesh,
                         DECODER_SPLITS)
        self.cfg = cfg

    def init_state(self, seed: int = 0):
        return self.state_from(decoder_state_from_jax(init_params(self.cfg, seed=seed)))

    def replica_weights(self, params, replica: int, cache: dict) -> Dict[str, Any]:
        """``MasterTrainer.replica_weights`` and the embeddings' compute-dtype
        casts ``wte_c`` / ``wpe_c``, so ``wte`` gets its gradient from both
        the embedding and the tied head."""
        weights = super().replica_weights(params, replica, cache)
        for name in ("wte", "wpe"):
            weights[name + "_c"] = self.cast(params[name], replica, self.cfg.dtype,
                                             cache, name + "_c")
        return weights

    def forward_logits(self, weights: Dict[str, Any], replica: int, ids: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced float32 logits (B, T, vocab) of one replica's rows
        from ``replica_weights``."""
        if self.mesh.model_shards == 1:
            return functional_call(self.model, weights, (ids, mask))
        return TPDecoder(self.cfg, self.replica_devices(replica), weights)(ids, mask)

    def loss_fn(self, params, batches: Sequence[Mapping[str, torch.Tensor]]):
        cache: dict = {}
        ce_sums, hits, counts = [], [], []
        for d, batch in enumerate(batches):
            ids, mask = batch["ids"], batch["mask"]
            weights = self.replica_weights(params, d, cache)
            logits = self.forward_logits(weights, d, ids, mask)[:, :-1]
            targets = ids[:, 1:]
            valid = mask[:, 1:].float()
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                                 reduction="none").view(targets.shape)
            ce_sums.append((ce * valid).sum().to(self.device))
            hits.append(((logits.argmax(dim=-1) == targets).float() * valid).sum()
                        .to(self.device))
            counts.append(valid.sum().to(self.device))
        denom = sum_parts(counts).clamp_min(1.0)
        loss = sum_parts(ce_sums) / denom
        acc = sum_parts(hits) / denom
        return loss, {"loss": loss.detach(), "accuracy": acc}

    @torch.no_grad()
    def decoder(self, params) -> Union[TPDecoder, CodeDecoder]:
        """The masters in the compute dtype, for ``decoder.generate_tokens``:
        on several model shards, data replica 0's shards (``TPDecoder``:
        the prefill and the KV-cached decode run over them, eagerly); on
        one, the one-device model of the gathered masters (``build_decoder``,
        whose decode step is graphed on the card)."""
        if self.mesh.model_shards == 1:
            return build_decoder(decoder_state_to_jax(self.gather(params)), self.cfg,
                                 self.device)
        weights = {k: [p.detach() for p in v] if isinstance(v, list) else v.detach()
                   for k, v in self.replica_weights(params, 0, {}).items()}
        return TPDecoder(self.cfg, self.replica_devices(0), weights)


def build_qa_texts(chunks, *, ctx_chars: Optional[int] = None) -> list:
    """Question-answer training texts derived from the corpus itself.

    The ``tpu-lm`` provider serves RAG answers in the QA_* prompt grammar
    (models/decoder.py): ``### Context <snippet> ### Question <q>
    ### Answer <a>###``. A corpus-fitted model must SEE that grammar in
    training or chat decoding emits noise regardless of next-token
    accuracy. For every chunk with a defining symbol this builds
    question variants ("what does X do?", "where is X defined?", the
    docstring as a natural-language question) whose answer cites the
    symbol, its file/lines, and its leading docstring — the synthesis a
    code-search answer actually needs. ``chunks``: CodeChunk-likes with
    .content/.symbol/.path/.start_line/.end_line.
    """
    if ctx_chars is None:
        ctx_chars = QA_CTX_CHARS
    doc_re = re.compile(r'(?s)(?:"""|\'\'\')(.+?)(?:"""|\'\'\')')
    out = []
    for c in chunks:
        symbol = getattr(c, "symbol", None)
        if not symbol:
            continue
        path = str(getattr(c, "path", "") or "")
        ctx = (c.content or "")[:ctx_chars]
        m = doc_re.search(c.content or "")
        doc = ""
        if m:
            doc = re.sub(r"\s+", " ", m.group(1)).strip()
            doc = doc.split(". ")[0][:140]
        lines = (
            f" (lines {c.start_line}-{c.end_line})"
            if getattr(c, "start_line", None)
            else ""
        )
        answer = f"`{symbol}` is defined in {path}{lines}."
        if doc:
            answer += f" {doc}."
        for q in (
            f"what does {symbol} do?",
            f"where is {symbol} defined?",
        ):
            out.append(
                f"{QA_CONTEXT}{ctx}{QA_QUESTION}{q}{QA_ANSWER}{answer}\n###"
            )
        if doc and len(doc.split()) >= 4:
            out.append(
                f"{QA_CONTEXT}{ctx}{QA_QUESTION}{doc[:160]}"
                f"{QA_ANSWER}{answer}\n###"
            )
    return out


class WindowBatcher:
    """Random fixed-length token windows over the corpus chunks.

    Each sample is a window from one chunk's byte tokens, EOS-terminated when
    the window reaches the chunk's end; every batch has the shape
    (batch_size, seq_len).

    ``anchored_texts`` (the QA mix) sample differently: always from position
    0, so the model learns the prompt grammar from its start marker —
    a random mid-window crop of a QA example teaches the wrong conditional.
    ``anchored_frac`` of each batch comes from the anchored pool.
    """

    def __init__(
        self,
        texts: Sequence[str],
        tokenizer,
        *,
        seq_len: int = 256,
        batch_size: int = 32,
        seed: int = 0,
        anchored_texts: Sequence[str] = (),
        anchored_frac: float = 0.0,
    ):
        self.docs = [
            tokenizer.encode(t) + [getattr(tokenizer, "EOS_ID", 1)]
            for t in texts
            if t.strip()
        ]
        self.anchored = [
            tokenizer.encode(t) + [getattr(tokenizer, "EOS_ID", 1)]
            for t in anchored_texts
            if t.strip()
        ]
        if not self.docs and not self.anchored:
            raise ValueError("no non-empty chunks to train on")
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.anchored_frac = float(anchored_frac) if self.anchored else 0.0
        self.rng = np.random.default_rng(seed)
        # sample documents proportionally to their length
        docs = self.docs or self.anchored
        if not self.docs:
            self.docs = self.anchored
        lens = np.array([len(d) for d in docs], dtype=np.float64)
        self.doc_p = lens / lens.sum()

    def _sample(self) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros(self.seq_len, dtype=np.int32)
        mask = np.zeros(self.seq_len, dtype=np.int32)
        if self.anchored and self.rng.random() < self.anchored_frac:
            doc = self.anchored[int(self.rng.integers(len(self.anchored)))]
            doc = doc[: self.seq_len]  # anchored: always from position 0
            ids[: len(doc)] = doc
            mask[: len(doc)] = 1
            return ids, mask
        doc = self.docs[int(self.rng.choice(len(self.docs), p=self.doc_p))]
        if len(doc) <= self.seq_len:
            ids[: len(doc)] = doc
            mask[: len(doc)] = 1
        else:
            start = int(self.rng.integers(0, len(doc) - self.seq_len + 1))
            ids[:] = doc[start : start + self.seq_len]
            mask[:] = 1
        return ids, mask

    def batches(self, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(steps):
            rows = [self._sample() for _ in range(self.batch_size)]
            yield {
                "ids": np.stack([r[0] for r in rows]),
                "mask": np.stack([r[1] for r in rows]),
            }


# -- checkpointing ---------------------------------------------------------------


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
