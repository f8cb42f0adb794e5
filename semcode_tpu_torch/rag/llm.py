"""LLM chat providers for answer synthesis.

The reference wraps ChatOpenAI / LlamaCpp behind LangChain
(reference src/semcode/rag/pipeline.py:254-296); here a provider is any
callable ``chat(system, user) -> str``. The built-in provider speaks the
OpenAI-compatible /v1/chat/completions protocol over httpx, which covers
OpenAI, LM Studio, vLLM, llama.cpp-server, and friends.

Counterpart of ``semcode_tpu/rag/llm.py``. The in-process ``tpu-lm``
provider (``TPULocalChat``) runs the causal decoder
(``models/decoder.py``) on the engine's device: CUDA unless the caller
asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

from ..device import DeviceLike

LOCAL_LLM_PROVIDERS = ("tpu-lm", "tpu", "local")


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


class TPULocalChat:
    """In-process answer synthesis on the card (no network, no native wheel).

    Replaces the reference's llama.cpp chat path (reference
    src/semcode/rag/pipeline.py:270-296) with the causal LM
    (models/decoder.py) on ``device`` (CUDA unless ``"cpu"``). Weights come
    from a ``train-lm`` checkpoint or a local HF GPT-2-family checkpoint
    dir (``rag.weights_path``); without one the decoder warns and produces
    noise — keep provider=fallback until a checkpoint is supplied.
    """

    STOPS = ("###", "\n\n\n")

    def __init__(
        self,
        weights_path=None,
        preset: str = "mini",
        max_new_tokens: int = 192,
        temperature: float = 0.0,
        max_len: int = 1024,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        from ..models.decoder import CodeDecoderLM

        self.lm = CodeDecoderLM(
            preset, weights_path=weights_path, max_len=max_len, seed=seed,
            device=device,
        )
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)

    def warm(self) -> list:
        """Ready every prompt bucket a query can take (on the card: the
        decode graphs). Returns the buckets."""
        return self.lm.warm(self.max_new_tokens)

    def chat(self, system: str, user: str) -> str:
        prompt = f"{system}\n\n### Question\n{user}\n\n### Answer\n"
        text = self.lm.generate(
            prompt,
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature,
        )
        for stop in self.STOPS:
            cut = text.find(stop)
            if cut != -1:
                text = text[:cut]
        return text.strip()

    def qa_prompt(self, question: str, snippets) -> str:
        """The QA-grammar prompt of ``chat_structured``: the top snippet
        cut to the trained context budget, then the question."""
        from ..models.decoder import (
            QA_ANSWER,
            QA_CONTEXT,
            QA_CTX_CHARS,
            QA_QUESTION,
        )

        # byte tokenizer: chars ~ tokens; the ctx budget must match the
        # TRAINED budget (QA_CTX_CHARS) — longer contexts than training
        # windows covered push the answer region out of distribution —
        # and still leave room for the completion
        budget = self.lm.cfg.max_len - self.max_new_tokens - len(question) - 32
        ctx = (snippets[0] if snippets else "")[
            : max(min(budget, QA_CTX_CHARS), 0)
        ]
        return f"{QA_CONTEXT}{ctx}{QA_QUESTION}{question}{QA_ANSWER}"

    def chat_structured(
        self, question: str, snippets, system: Optional[str] = None
    ) -> str:
        """RAG-shaped generation in the EXACT grammar the corpus-fitted LM
        was trained on (models/decoder.QA_* and the JAX package's
        train_lm.build_qa_texts): ``### Context <top snippet> ### Question
        <q> ### Answer``. The pipeline prefers this over chat() when present
        — a byte-level model prompted outside its training grammar emits
        noise no matter how low its training loss. The ``system`` text is
        ignored: a corpus-fitted byte LM doesn't follow instructions, it
        completes its grammar."""
        text = self.lm.generate(
            self.qa_prompt(question, snippets),
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature,
        )
        for stop in ("\n###",) + self.STOPS:
            cut = text.find(stop)
            if cut != -1:
                text = text[:cut]
        return text.strip()


def create_llm(config, device: DeviceLike = None):
    """Build the configured chat provider, or None for pure-fallback mode.
    ``device`` is where ``tpu-lm`` runs (CUDA unless ``"cpu"``)."""
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
    if provider in LOCAL_LLM_PROVIDERS:
        return TPULocalChat(
            weights_path=config.rag_weights_path,
            preset=config.rag_preset,
            max_new_tokens=config.rag_max_new_tokens,
            temperature=config.rag_temperature,
            device=device,
        )
    raise NotImplementedError(f"RAG provider '{config.rag_provider}' not supported")
