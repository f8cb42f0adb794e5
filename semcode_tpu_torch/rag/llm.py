"""LLM chat providers for answer synthesis.

The reference wraps ChatOpenAI / LlamaCpp behind LangChain
(reference src/semcode/rag/pipeline.py:254-296); here a provider is any
callable ``chat(system, user) -> str``. The built-in provider speaks the
OpenAI-compatible /v1/chat/completions protocol over httpx, which covers
OpenAI, LM Studio, vLLM, llama.cpp-server, and friends.

Counterpart of ``semcode_tpu/rag/llm.py``; the in-process ``tpu-lm``
provider needs the causal decoder, which is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional


class OpenAICompatibleChat:
    def __init__(
        self,
        model: str,
        api_base: Optional[str] = None,
        api_key: Optional[str] = None,
        temperature: float = 0.0,
        timeout: float = 120.0,
    ):
        self.model = model
        self.api_base = (api_base or "https://api.openai.com/v1").rstrip("/")
        self.api_key = api_key or os.getenv("OPENAI_API_KEY")
        self.temperature = temperature
        self.timeout = timeout

    def chat(self, system: str, user: str) -> str:
        import httpx

        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        resp = httpx.post(
            f"{self.api_base}/chat/completions",
            json={
                "model": self.model,
                "temperature": self.temperature,
                "messages": [
                    {"role": "system", "content": system},
                    {"role": "user", "content": user},
                ],
            },
            headers=headers,
            timeout=self.timeout,
        )
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"]


def create_llm(config):
    """Build the configured chat provider, or None for pure-fallback mode."""
    provider = (config.rag_provider or "fallback").lower()
    if provider in ("fallback", "none", ""):
        return None
    if provider in ("openai", "openai-compatible", "lmstudio"):
        return OpenAICompatibleChat(
            model=config.rag_model,
            api_base=config.rag_api_base,
            api_key=config.rag_api_key,
            temperature=config.rag_temperature,
        )
    if provider in ("tpu-lm", "tpu", "local"):
        raise NotImplementedError(
            f"RAG provider '{config.rag_provider}' needs the causal decoder, "
            "which is not ported yet"
        )
    raise NotImplementedError(f"RAG provider '{config.rag_provider}' not supported")
