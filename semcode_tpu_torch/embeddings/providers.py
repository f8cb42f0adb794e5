"""Embedding provider factory.

Config-driven factory returning a duck-typed provider exposing
``embed_documents(texts) -> List[List[float]]`` and
``embed_query(text) -> List[float]`` — the same protocol the reference relies
on from LangChain (reference src/semcode/embeddings/providers.py:31-104, used
at services/indexer.py:150 and rag/pipeline.py:171-175).

Counterpart of ``semcode_tpu/embeddings/providers.py``. Providers:
- ``tpu-hash``     deterministic hashed n-gram + device random projection
                   (default; the names are kept so one settings file drives
                   both packages)
- ``tpu-encoder``  the transformer encoder (``models/encoder.py``; the
                   shipped encoder-mini checkpoint by default)
- ``tpu-hybrid``   hash and encoder vectors concatenated (the recommended
                   provider)
- ``openai`` / ``lmstudio``  OpenAI-compatible /v1/embeddings over HTTP
- ``jina``         Jina embeddings API over HTTP
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..device import DeviceLike
from ..settings import AppSettings, settings as default_settings


@dataclass
class EmbeddingPayload:
    """One chunk ready for upsert (reference providers.py:21-28)."""

    id: str
    text: str
    vector: Sequence[float]
    metadata: Dict[str, Any] = field(default_factory=dict)


class _OpenAICompatibleEmbeddings:
    """Minimal OpenAI-compatible /v1/embeddings client (httpx, no LangChain)."""

    def __init__(
        self,
        model: str,
        api_base: Optional[str],
        api_key: Optional[str],
        batch_size: int = 64,
        timeout: float = 60.0,
    ):
        self.model = model
        self.api_base = (api_base or "https://api.openai.com/v1").rstrip("/")
        self.api_key = api_key or os.getenv("OPENAI_API_KEY")
        self.batch_size = batch_size
        self.timeout = timeout

    def _post(self, texts: Sequence[str]) -> List[List[float]]:
        import httpx

        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        resp = httpx.post(
            f"{self.api_base}/embeddings",
            json={"model": self.model, "input": list(texts)},
            headers=headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        data = resp.json()["data"]
        return [d["embedding"] for d in sorted(data, key=lambda d: d["index"])]

    def embed_documents(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[List[float]] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(self._post(texts[i : i + self.batch_size]))
        return out

    def embed_query(self, text: str) -> List[float]:
        return self._post([text])[0]


class _JinaEmbeddings(_OpenAICompatibleEmbeddings):
    def __init__(self, model: str, api_key: Optional[str], batch_size: int = 64):
        super().__init__(
            model,
            api_base="https://api.jina.ai/v1",
            api_key=api_key or os.getenv("JINA_API_KEY"),
            batch_size=batch_size,
        )


def provider_signature(emb) -> str:
    """Stable identity of the vector definition a provider emits.

    Stored per chunk (``embed_sig`` metadata) and compared on incremental
    re-ingest: any change to the featurizer, checkpoint, hybrid weight or
    doc-side expansion makes every stored chunk stale, forcing a clean
    re-embed instead of silently mixing incompatible vector generations in
    one index (scores across generations are not comparable)."""
    sig = getattr(emb, "signature", None)
    if sig is not None:
        return f"{sig}|t{EMBED_TEXT_VERSION}"
    model = getattr(emb, "model", type(emb).__name__)
    dim = getattr(emb, "dim", "?")
    return f"{model}:d{dim}|t{EMBED_TEXT_VERSION}"


# version of the embedding_text() doc-side expansion below — part of every
# provider signature, so changing the expansion invalidates stored vectors
EMBED_TEXT_VERSION = 1


def embedding_text(text: str, *, symbol=None, path=None) -> str:
    """Document-side expansion: the text EMBEDDED for a chunk prepends its
    defining symbol (twice — log-TF means a usage-heavy sibling chunk that
    mentions the name many times otherwise outweighs the definition) and
    the file stem. Standard title/anchor expansion from text IR, applied
    to code: 'where is X defined' queries should land on X's definition,
    and window-0 of the encoder always sees the identity of the chunk.
    The STORED text is untouched — this only shapes the vector."""
    parts = []
    if symbol:
        parts.append(f"{symbol} {symbol}")
    if path:
        from pathlib import Path as _P

        parts.append(_P(str(path)).stem)
    if not parts:
        return text
    return " ".join(parts) + "\n" + text


# code-identifier shapes in a query
_IDENTIFIER_RE = re.compile(
    r"\b[A-Za-z][A-Za-z0-9]*_[A-Za-z0-9_]+\b"   # snake_case
    r"|\b[a-z]+[A-Z][A-Za-z0-9]*\b"              # camelCase
    r"|\b[A-Z][a-z0-9]+[A-Z][A-Za-z0-9]*\b"      # PascalCase
    r"|\b\w+\.\w+\("                             # obj.method(
)


def _query_has_identifier(text: str) -> bool:
    """Does the query contain code-identifier shapes (snake_case,
    camelCase, dotted paths)? Such queries are literal lookups where the
    lexical signal is near-authoritative; pure natural-language queries
    lean on the semantic encoder instead."""
    return _IDENTIFIER_RE.search(text) is not None


class HybridEmbeddings:
    """Lexical + semantic ensemble: concatenation of the hash embedder's and
    the trained encoder's unit vectors, each scaled so inner products add as
    a fixed-weight score mix (``w*enc_sim + (1-w)*hash_sim``).

    Both parts are unit vectors, so the concat's norm is constant
    (sqrt(a^2+b^2) = 1) and the weighting survives normalization.
    """

    def __init__(
        self,
        hash_emb,
        encoder_emb,
        *,
        w_encoder: float = 0.5,
        adaptive: bool = True,
        adaptive_shift: float = 0.15,
    ):
        self.w = min(max(float(w_encoder), 0.0), 1.0)
        self.adaptive = bool(adaptive)
        self.adaptive_shift = float(adaptive_shift)
        self.hash = hash_emb
        self.encoder = encoder_emb
        self.dim = int(hash_emb.dim) + int(encoder_emb.dim)

    @property
    def signature(self) -> str:
        # w is baked into DOC vectors (sqrt scaling), so it is part of the
        # stored-vector definition; `adaptive` shapes only the query side
        h = getattr(self.hash, "signature", type(self.hash).__name__)
        e = getattr(self.encoder, "signature", type(self.encoder).__name__)
        return f"hybrid:w{self.w:g}:[{h}]+[{e}]"

    def _concat(self, h, e, w: float):
        import numpy as np

        h = np.asarray(h, dtype=np.float32) * float(np.sqrt(1.0 - w))
        e = np.asarray(e, dtype=np.float32) * float(np.sqrt(w))
        return np.concatenate([h, e], axis=-1)

    def embed_documents(self, texts):
        h = self.hash.embed_documents(texts)
        e = self.encoder.embed_documents(texts)
        return [v.tolist() for v in self._concat(h, e, self.w)]

    def _query_weight(self, text: str) -> float:
        """Per-query score mix. Documents are indexed with the static
        weight, but the concat leaves the QUERY side free: scoring is
        sqrt(1-w_d)*sqrt(1-w_q)*hash_sim + sqrt(w_d)*sqrt(w_q)*enc_sim, so
        shifting w_q re-balances the mix per query without re-indexing.
        Queries carrying literal identifiers shift toward the lexical
        signal; prose queries shift toward the encoder."""
        if not self.adaptive:
            return self.w
        if _query_has_identifier(text):
            return max(0.0, self.w - self.adaptive_shift)
        return min(1.0, self.w + self.adaptive_shift)

    def embed_query(self, text: str):
        return self._concat(
            self.hash.embed_query(text),
            self.encoder.embed_query(text),
            self._query_weight(text),
        ).tolist()

    def embed_queries(self, texts):
        """Batched query embedding: both parts embed as ONE batch each,
        then every query gets its own adaptive weight — exactly matching a
        loop over embed_query, at batch cost."""
        import numpy as np

        h = np.asarray(self.hash.embed_queries(texts), dtype=np.float32)
        e = np.asarray(self.encoder.embed_queries(texts), dtype=np.float32)
        return [
            self._concat(h[i], e[i], self._query_weight(t)).tolist()
            for i, t in enumerate(texts)
        ]


ENCODER_PROVIDERS = ("tpu-encoder", "encoder", "tpu-hybrid", "hybrid")


class EmbeddingProviderFactory:
    """Create an embeddings provider from settings
    (reference providers.py:31-104 keeps the same shape)."""

    @staticmethod
    def create(config: Optional[AppSettings] = None, device: DeviceLike = None):
        config = config or default_settings
        provider = config.embedding_provider.lower()
        if provider in ("tpu-hash", "hash", "local"):
            from .hash_embedder import HashEmbeddings

            return HashEmbeddings(
                dim=config.embedding_dimension,
                batch_size=config.embedding_batch_size,
                device=device,
            )
        if provider in ENCODER_PROVIDERS:
            from ..models.encoder import EncoderEmbeddings

            encoder = EncoderEmbeddings(
                preset=config.encoder_preset,
                dim=(config.embedding_dimension
                     if provider in ("tpu-encoder", "encoder") else None),
                weights_path=config.encoder_weights_path,
                batch_size=config.embedding_batch_size,
                max_tokens=config.embedding_max_tokens,
                dtype=config.encoder_dtype,
                device=device,
            )
            if provider in ("tpu-encoder", "encoder"):
                return encoder
            from .hash_embedder import HashEmbeddings

            return HybridEmbeddings(
                HashEmbeddings(
                    dim=config.embedding_dimension,
                    batch_size=config.embedding_batch_size,
                    device=device,
                ),
                encoder,
                w_encoder=config.embedding_hybrid_weight,
                adaptive=config.embedding_hybrid_adaptive,
            )
        if provider in ("openai", "lmstudio"):
            return _OpenAICompatibleEmbeddings(
                model=config.embedding_model,
                api_base=config.embedding_api_base,
                api_key=config.embedding_api_key,
                batch_size=config.embedding_batch_size,
            )
        if provider == "jina":
            return _JinaEmbeddings(
                model=config.embedding_model,
                api_key=config.embedding_api_key,
                batch_size=config.embedding_batch_size,
            )
        raise NotImplementedError(
            f"Embedding provider '{config.embedding_provider}' is not supported"
        )
