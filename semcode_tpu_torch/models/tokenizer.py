"""Tokenization for the transformer encoder.

Counterpart of ``semcode_tpu/models/tokenizer.py``; ids and masks are
identical to it. Two encoder backends:

- ``HashingTokenizer`` (default, zero-asset): code-aware word splitting
  (shared with the hash embedder) with tokens mapped into a fixed vocab by a
  stable hash. Deterministic across processes, no files, no network.
- ``HFTokenizer``: wraps a local ``tokenizer.json`` through the
  ``tokenizers`` wheel when real pretrained encoder weights are used.

Both return fixed-shape ``(ids, mask)`` numpy batches. ``ByteTokenizer`` is
the reversible fallback of the causal LM (``load_lm_tokenizer``).
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..embeddings.hash_embedder import code_tokens

PAD_ID = 0
CLS_ID = 1
RESERVED = 2


class HashingTokenizer:
    def __init__(self, vocab_size: int = 32768, max_len: int = 512):
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)

    def _tok_id(self, tok: str) -> int:
        return RESERVED + zlib.crc32(tok.encode("utf-8")) % (
            self.vocab_size - RESERVED
        )

    def encode_ids(self, text: str, cap: Optional[int] = None) -> np.ndarray:
        """Raw token ids (no CLS/padding): documents are tokenized once and
        cut into windows afterwards."""
        toks = code_tokens(text)
        if cap is not None:
            toks = toks[:cap]
        return np.asarray([self._tok_id(t) for t in toks], dtype=np.int32)

    def encode_batch(
        self, texts: Sequence[str], max_len: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        max_len = int(max_len or self.max_len)
        n = len(texts)
        ids = np.full((n, max_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((n, max_len), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = code_tokens(text)[: max_len - 1]
            row = [CLS_ID] + [self._tok_id(t) for t in toks]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


class HFTokenizer:
    """Local tokenizer.json wrapper (for pretrained weights)."""

    def __init__(self, path: Path, max_len: int = 512):
        try:
            from tokenizers import Tokenizer
        except ImportError as exc:
            raise ImportError(
                f"{path} needs the 'tokenizers' package, which is not "
                "installed; install it or use a checkpoint without a "
                "tokenizer.json (the hashing tokenizer)"
            ) from exc

        self._tok = Tokenizer.from_file(str(path))
        self.max_len = int(max_len)
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str) -> list:
        return list(self._tok.encode(text).ids)

    def encode_ids(self, text: str, cap: Optional[int] = None) -> np.ndarray:
        ids = self._tok.encode(text).ids
        if cap is not None:
            ids = ids[:cap]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))

    def encode_batch(
        self, texts: Sequence[str], max_len: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        max_len = int(max_len or self.max_len)
        encs = self._tok.encode_batch(list(texts))
        n = len(texts)
        ids = np.zeros((n, max_len), dtype=np.int32)
        mask = np.zeros((n, max_len), dtype=np.int32)
        for i, e in enumerate(encs):
            row = e.ids[:max_len]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


class ByteTokenizer:
    """Reversible zero-asset tokenizer for the causal LM.

    The hashing tokenizer is one-way (generation needs id -> text), so the
    decoder's no-checkpoint fallback tokenizes raw UTF-8 bytes:
    id 0 = pad, id 1 = eos, byte b -> 2 + b.
    """

    PAD_ID = 0
    EOS_ID = 1

    def __init__(self, max_len: int = 1024):
        self.max_len = int(max_len)
        self.vocab_size = 258

    def encode(self, text: str) -> list:
        return [2 + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for i in ids:
            if i == self.EOS_ID:
                break
            if i >= 2:
                out.append(i - 2)
        return out.decode("utf-8", errors="replace")


def load_tokenizer(
    weights_path: Optional[Path], vocab_size: int, max_len: int
):
    if weights_path is not None:
        tok_file = Path(weights_path) / "tokenizer.json"
        if tok_file.exists():
            return HFTokenizer(tok_file, max_len=max_len)
    return HashingTokenizer(vocab_size=vocab_size, max_len=max_len)


def load_lm_tokenizer(weights_path: Optional[Path], max_len: int):
    """Tokenizer for the causal LM: must be reversible (decode needed)."""
    if weights_path is not None:
        tok_file = Path(weights_path) / "tokenizer.json"
        if tok_file.exists():
            return HFTokenizer(tok_file, max_len=max_len)
    return ByteTokenizer(max_len=max_len)
