"""Semantic search / RAG query pipeline.

Parity with the reference pipeline (reference src/semcode/rag/
pipeline.py:25-301): embed the question, retrieve top-k context from the
vector store, assemble the prompt (template override + ``{system_prompt}``
substitution, snippet truncation), call the LLM, and on any retrieval/LLM
failure fall back to an extractive summary of the best sources (except a
kernel that fails to build or launch, ``ops.build.KernelError``, which
propagates). Response
shape: ``{"answer", "sources", "meta": {"fallback_used", "reason"?}}``.

Counterpart of ``semcode_tpu/rag/pipeline.py``: query embedding and
retrieval run on the engine's device (``device=``, CUDA by default) — the
query path never leaves the process unless an external LLM provider is
configured.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np

from ..device import DeviceLike
from ..embeddings import EmbeddingProviderFactory
from ..index.store import SearchHit, VectorStore
from ..protocols import SearcherLike
from ..logger import get_logger
from ..ops.build import KernelError
from ..settings import AppSettings, settings as default_settings
from ..utils.tracing import StageTimer
from .llm import create_llm

log = get_logger("rag.pipeline")

_DEFAULT_TEMPLATE = """{system_prompt}

Use the context snippets below to answer the question. Cite the file paths
that support your answer. If the context is insufficient, say so.

Context:
{context}

Question: {question}

Answer:"""

_SNIPPET_CHARS = 1000  # reference pipeline.py:196-197

_LLM_UNSET = object()  # sentinel: LLM not constructed yet (None = no provider)

# definition claims in the trained answer grammar (models/train_lm.
# build_qa_texts: "`{symbol}` is defined in {path}[ (lines A-B)].") — and
# any hosted-LLM answer that happens to use the same phrasing
_DEF_CLAIM_RE = re.compile(
    r"`([A-Za-z_][\w.]*)`\s+is defined in\s+([^\s()`,]+?)"
    r"(?:\s*\(lines\s+(\d+)\s*-\s*(\d+)\))?(?:\.(?=\s|$)|,|(?=\s)|$)"
)


class SemanticSearchPipeline:
    def __init__(
        self,
        *,
        config: Optional[AppSettings] = None,
        vector_store: Optional[SearcherLike] = None,
        embeddings=None,
        device: DeviceLike = None,
    ) -> None:
        self.config = config or default_settings
        self.device = device
        self._vector_store = vector_store
        self._embeddings = embeddings
        self._connected = False
        self._cache: "OrderedDict" = OrderedDict()  # (q, k, filters) -> result
        # query() runs on the API's executor threads: guard cache mutations
        self._cache_lock = threading.Lock()
        # the LLM is built ONCE and reused: provider tpu-lm loads a full
        # decoder checkpoint in its constructor, so per-query create_llm()
        # would reload weights for every answer (and N times per batch)
        self._llm = _LLM_UNSET
        self._llm_lock = threading.Lock()

    # lazy collaborators (reference connects lazily too, pipeline.py:94-101)
    @property
    def vector_store(self) -> SearcherLike:
        if self._vector_store is None:
            self._vector_store = VectorStore(self.config, device=self.device)
        return self._vector_store

    @property
    def embeddings(self):
        if self._embeddings is None:
            self._embeddings = EmbeddingProviderFactory.create(
                self.config, device=self.device
            )
        return self._embeddings

    # -- public API -----------------------------------------------------------

    def query(
        self,
        question: str,
        *,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        question = (question or "").strip()
        if not question:
            raise ValueError("Question cannot be empty.")
        cache_key = None
        if self.config.rag_query_cache_size > 0:
            cache_key = (
                question,
                top_k,
                # filter values may be lists (multi-select); canonicalize to
                # hashable tuples
                tuple(
                    sorted(
                        (k, tuple(v) if isinstance(v, list) else v)
                        for k, v in (filters or {}).items()
                    )
                ),
                getattr(self._vector_store, "version", None),
            )
            with self._cache_lock:
                hit = self._cache.get(cache_key)
                if hit is not None:
                    self._cache.move_to_end(cache_key)
            if hit is not None:
                result = dict(hit)
                result["meta"] = dict(hit.get("meta") or {}, cached=True)
                return result
        result = self._execute_query(question, top_k=top_k, filters=filters)
        if cache_key is not None and self._cacheable(result):
            with self._cache_lock:
                self._cache[cache_key] = result
                while len(self._cache) > self.config.rag_query_cache_size:
                    self._cache.popitem(last=False)
        return result

    @staticmethod
    def _cacheable(result: Dict[str, Any]) -> bool:
        """Never cache fallbacks caused by transient failures — a retrieval
        or LLM hiccup would otherwise poison that question until the next
        store mutation bumps the version. ``no_llm_configured`` IS cacheable
        (deterministic given the config)."""
        meta = result.get("meta") or {}
        if not meta.get("fallback_used"):
            return True
        reason = str(meta.get("reason") or "")
        # grounding_failed is deterministic given (question, store version,
        # greedy decode) — same cacheability as no_llm_configured
        return reason in ("no_llm_configured", "grounding_failed")

    def _execute_query(
        self,
        question: str,
        *,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        timer = StageTimer()
        documents = self._retrieve_documents(
            question, top_k=top_k, filters=filters, timer=timer
        )
        return self._answer_from_documents(question, documents, timer=timer)

    def query_batch(
        self,
        questions: List[str],
        *,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
    ) -> List[Dict[str, Any]]:
        """Answer several questions with ONE embed step and ONE index scan.

        The engine's throughput comes from batching; this is the primitive
        the API's dynamic micro-batcher uses to turn concurrent requests
        into a single device batch. LLM synthesis (when
        configured) still runs per question.
        """
        questions = [q.strip() for q in questions]
        if not questions or any(not q for q in questions):
            raise ValueError("Questions cannot be empty.")
        k = top_k or self.config.rag_max_context_sources
        timer = StageTimer()  # BATCH-level stage attribution
        # per-question cache reuse (same key as query()): duplicate questions
        # inside one micro-batch window — common under concurrent load — and
        # repeats across windows skip the embed+scan entirely
        keys: List[Any] = [None] * len(questions)
        results: List[Optional[Dict[str, Any]]] = [None] * len(questions)
        if self.config.rag_query_cache_size > 0:
            frozen = tuple(
                sorted(
                    (fk, tuple(fv) if isinstance(fv, list) else fv)
                    for fk, fv in (filters or {}).items()
                )
            )
            version = getattr(self._vector_store, "version", None)
            with self._cache_lock:
                for i, q in enumerate(questions):
                    keys[i] = (q, top_k, frozen, version)
                    hit = self._cache.get(keys[i])
                    if hit is not None:
                        self._cache.move_to_end(keys[i])
                        results[i] = dict(
                            hit, meta=dict(hit.get("meta") or {}, cached=True)
                        )
        todo = [i for i, r in enumerate(results) if r is None]
        if not todo:
            return results  # whole window served from cache
        live_qs = [questions[i] for i in todo]
        try:
            # fast path: keep the batch embedding on device between embed and
            # search — ONE device round trip per micro-batch instead of two
            if hasattr(self.embeddings, "embed_queries_device") and hasattr(
                self.vector_store, "search_batch_device"
            ):
                with timer.stage("embed"):
                    q_dev = self.embeddings.embed_queries_device(live_qs)
                with timer.stage("search"):
                    hits_batch = self.vector_store.search_batch_device(
                        q_dev, top_k=k, filters=filters,
                        query_texts=live_qs, timer=timer,
                    )[: len(live_qs)]
            else:
                with timer.stage("embed"):
                    vectors = np.asarray(
                        self._embed_queries(live_qs), dtype=np.float32
                    )
                with timer.stage("search"):
                    hits_batch = self.vector_store.search_batch(
                        vectors, top_k=k, filters=filters,
                        query_texts=live_qs, timer=timer,
                    )
        except KernelError:
            raise  # a kernel that cannot build or launch fails the request
        except Exception as exc:
            log.warning("batch_retrieval_failed", error=str(exc))
            hits_batch = [[] for _ in live_qs]
        with timer.stage("answer"):
            answered = [
                self._answer_from_documents(q, docs, timer=StageTimer())
                for q, docs in zip(live_qs, hits_batch)
            ]
        # batch-level timings on every freshly-computed result: the per-query
        # share is timings/batch_size (sub-stages search_device/assemble/
        # rerank decompose "search"). Telemetry aggregates these per stage.
        batch_timings = timer.as_dict()
        for i, r in zip(todo, answered):
            meta = r.setdefault("meta", {})
            meta["batch_timings_ms"] = batch_timings
            meta["batch_size"] = len(todo)
            results[i] = r
            if keys[i] is not None and self._cacheable(r):
                with self._cache_lock:
                    self._cache[keys[i]] = r
                    while len(self._cache) > self.config.rag_query_cache_size:
                        self._cache.popitem(last=False)
        return results

    def _embed_queries(self, questions: List[str]) -> List[List[float]]:
        """QUERY-side embeddings for a batch: providers may weight queries
        differently than documents (tpu-hybrid's adaptive identifier/prose
        mix), so batched requests must never silently get document vectors
        — that made the same question rank differently under concurrent
        load than alone."""
        emb = self.embeddings
        if hasattr(emb, "embed_queries"):
            return emb.embed_queries(questions)
        if hasattr(emb, "embed_query"):
            return [emb.embed_query(q) for q in questions]
        return emb.embed_documents(questions)

    def _get_llm(self):
        """Construct the LLM once and reuse it (tpu-lm loads a checkpoint).
        A constructor EXCEPTION is not cached — transient failures retry on
        the next query; a None result (no provider configured) is."""
        with self._llm_lock:
            if self._llm is _LLM_UNSET:
                try:
                    self._llm = create_llm(self.config)
                except Exception as exc:
                    log.warning("llm_create_failed", error=str(exc))
                    return None
            return self._llm

    def _answer_from_documents(
        self,
        question: str,
        documents: List[SearchHit],
        *,
        timer: Optional[StageTimer] = None,
    ) -> Dict[str, Any]:
        """Prompt/LLM/fallback stage shared by query() and query_batch()."""
        timer = timer or StageTimer()
        if not documents:
            if self.config.rag_fallback_enabled:
                return {
                    "answer": (
                        "I could not find any indexed context matching the "
                        "question. Try ingesting the relevant repository first."
                    ),
                    "sources": [],
                    "meta": {"fallback_used": True, "reason": "no_results"},
                }
            return {"answer": "", "sources": [], "meta": {"fallback_used": False}}
        sources = [self._hit_to_source(h) for h in documents]
        llm = self._get_llm()
        if llm is None:
            return {
                "answer": self._summarize_documents(question, documents),
                "sources": sources,
                "meta": {
                    "fallback_used": True,
                    "reason": "no_llm_configured",
                    "timings_ms": timer.as_dict(),
                },
            }
        try:
            with timer.stage("llm"):
                structured = getattr(llm, "chat_structured", None)
                if structured is not None:
                    # providers that own their prompt grammar (tpu-lm's
                    # corpus-fitted QA format) get the raw parts
                    answer = structured(
                        question,
                        [d.text or "" for d in documents],
                        self.config.rag_system_prompt,
                    )
                else:
                    prompt = self._render_prompt(question, documents)
                    answer = llm.chat(self.config.rag_system_prompt, prompt)
            if not answer.strip():
                # an empty completion is a failure, not an answer
                raise ValueError("llm returned an empty answer")
            if self.config.rag_grounding_guard:
                miss = self._ungrounded_claim(answer, documents)
                if miss is not None:
                    sym, why = miss
                    log.warning(
                        "answer_grounding_failed", symbol=sym, reason=why
                    )
                    note = (
                        f"The generated answer referenced `{sym}`, which is "
                        "not supported by the retrieved context "
                        f"({why.replace('_', ' ')}); showing the retrieved "
                        "snippets instead."
                    )
                    return {
                        "answer": note + "\n" + self._summarize_documents(
                            question, documents
                        ),
                        "sources": sources,
                        "meta": {
                            "fallback_used": True,
                            "reason": "grounding_failed",
                            "ungrounded_symbol": sym,
                            "timings_ms": timer.as_dict(),
                        },
                    }
            return {
                "answer": answer,
                "sources": sources,
                "meta": {"fallback_used": False, "timings_ms": timer.as_dict()},
            }
        except Exception as exc:
            log.warning("llm_invoke_failed", error=str(exc))
            if not self.config.rag_fallback_enabled:
                raise
            return {
                "answer": self._summarize_documents(question, documents),
                "sources": sources,
                "meta": {
                    "fallback_used": True,
                    "reason": f"llm_error: {exc}",
                    "timings_ms": timer.as_dict(),
                },
            }

    @staticmethod
    def _ungrounded_claim(answer, documents):
        """First definition claim in ``answer`` the retrieved context does
        not support, as (symbol, why) — or None when every claim (or no
        claim) is grounded. A claim is grounded when the symbol appears in
        a retrieved snippet (or IS a hit's tagged symbol), the cited path
        matches a retrieved hit's path (suffix match: the LM cites
        repo-relative paths, hits may carry fuller ones), and any claimed
        line span overlaps a line-annotated hit at that path (a decoder
        that invents "lines 195-3045" is fabricating precision)."""
        for symbol, path, lo, hi in _DEF_CLAIM_RE.findall(answer or ""):
            base = symbol.split(".")[-1]
            sym_ok = any(
                base in (d.text or "")
                or base == str((d.metadata or {}).get("symbol") or "")
                for d in documents
            )
            if not sym_ok:
                return symbol, "symbol_not_in_context"
            norm = path.replace("\\", "/").lstrip("./")
            at_path = [
                d
                for d in documents
                if (p := str(d.path or "").replace("\\", "/"))
                and (p.endswith(norm) or norm.endswith(p))
            ]
            if not at_path:
                return symbol, "path_not_in_context"
            if lo and hi:
                spans = [
                    (m.get("start_line"), m.get("end_line"))
                    for d in at_path
                    for m in [d.metadata or {}]
                    if m.get("start_line") and m.get("end_line")
                ]
                if spans:
                    overlaps = any(
                        int(lo) <= int(e) and int(hi) >= int(s)
                        for s, e in spans
                    )
                    # overlap alone lets a true START line launder a wild
                    # END ("lines 195-3045" against a [195, 260] chunk):
                    # the span must also stay near the retrieved bounds
                    within = (
                        int(lo) >= min(int(s) for s, _ in spans) - 200
                        and int(hi) <= max(int(e) for _, e in spans) + 200
                    )
                    if not (overlaps and within):
                        return symbol, "lines_not_in_context"
        return None

    # -- retrieval ----------------------------------------------------------------

    def _retrieve_documents(
        self,
        question: str,
        *,
        top_k: Optional[int] = None,
        filters: Optional[Dict[str, Any]] = None,
        timer: Optional[StageTimer] = None,
    ) -> List[SearchHit]:
        k = top_k or self.config.rag_max_context_sources
        timer = timer or StageTimer()
        try:
            # fast path: keep the query vector on device between embed and
            # search (one host<->device round trip per query)
            if hasattr(self.embeddings, "embed_query_device") and hasattr(
                self.vector_store, "search_batch_device"
            ):
                with timer.stage("embed"):
                    q_dev = self.embeddings.embed_query_device(question)
                with timer.stage("search"):
                    hits = self.vector_store.search_batch_device(
                        q_dev, top_k=k, filters=filters,
                        query_texts=[question], timer=timer,
                    )
                return hits[0] if hits else []
            with timer.stage("embed"):
                vector = self.embeddings.embed_query(question)
            with timer.stage("search"):
                return self.vector_store.search(
                    vector, top_k=k, filters=filters, query_text=question
                )
        except KernelError:
            raise  # a kernel that cannot build or launch fails the request
        except Exception as exc:
            log.warning("retrieval_failed", error=str(exc))
            return []

    @staticmethod
    def _hit_to_source(hit: SearchHit) -> Dict[str, Any]:
        return {
            "path": hit.path,
            "repo": hit.repo,
            "language": hit.language,
            "score": hit.score,
            "snippet": (hit.text or "")[:_SNIPPET_CHARS],
        }

    # -- prompting -------------------------------------------------------------------

    def _render_prompt(self, question: str, documents: List[SearchHit]) -> str:
        template = self.config.rag_prompt_template or _DEFAULT_TEMPLATE
        context = self._format_context(documents)
        return template.format(
            system_prompt=self.config.rag_system_prompt,
            context=context,
            question=question,
        )

    @staticmethod
    def _format_context(documents: List[SearchHit]) -> str:
        parts = []
        for i, doc in enumerate(documents, 1):
            snippet = (doc.text or "")[:_SNIPPET_CHARS]
            parts.append(f"[{i}] {doc.repo}/{doc.path} ({doc.language})\n{snippet}")
        return "\n\n".join(parts)

    # -- extractive fallback (reference pipeline.py:219-249) --------------------------

    def _summarize_documents(
        self, question: str, documents: List[SearchHit]
    ) -> str:
        max_sources = self.config.rag_fallback_max_sources
        max_lines = self.config.rag_fallback_summary_sentences
        picked = documents[:max_sources]
        lines = [
            "No LLM answer available; here are the most relevant snippets:"
        ]
        for i, doc in enumerate(picked[:max_lines], 1):
            # normalize a bounded PREFIX, not the whole chunk: this runs per
            # request on the no-LLM serving path, and a regex over full 2 KB
            # bodies was 8% of the measured host-only API ceiling (str.split
            # is the C fast path for whitespace collapse)
            snippet = " ".join((doc.text or "")[:640].split())[:300]
            lines.append(f"{i}. {doc.repo}/{doc.path}: {snippet}")
        return "\n".join(lines)
