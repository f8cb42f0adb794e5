"""Embedding provider factory.

Config-driven factory returning a duck-typed provider exposing
``embed_documents(texts) -> List[List[float]]`` and
``embed_query(text) -> List[float]`` — the same protocol the reference relies
on from LangChain (reference src/semcode/embeddings/providers.py:31-104, used
at services/indexer.py:150 and rag/pipeline.py:171-175).

Counterpart of ``semcode_tpu/embeddings/providers.py``. Providers:
- ``tpu-hash``     deterministic hashed n-gram + device random projection
                   (default; the name is kept so one settings file drives
                   both packages)
- ``openai`` / ``lmstudio``  OpenAI-compatible /v1/embeddings over HTTP
- ``jina``         Jina embeddings API over HTTP
``tpu-encoder`` and ``tpu-hybrid`` need the transformer encoder, which is
not ported yet: asking for them raises.
"""

from __future__ import annotations

import os
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
        if provider in ("tpu-encoder", "encoder", "tpu-hybrid", "hybrid"):
            raise NotImplementedError(
                f"Embedding provider '{config.embedding_provider}' needs the "
                "transformer encoder, which is not ported yet"
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
