"""Centralized application settings.

Layered configuration shared by the CLI and background jobs:

1. built-in defaults (the ``AppSettings`` dataclass below),
2. a TOML file (``$SEMCODE_CONFIG_PATH`` or ``./semcode_settings.toml``),
   whose grouped sections are flattened into fields,
3. ``SEMCODE_``-prefixed environment variable overrides.

Same fields, defaults, TOML sections and environment layering as
``semcode_tpu/settings.py``, so one settings file drives both packages.
This copy is built on ``dataclasses`` instead of pydantic, which the GPU
hosts need not carry; ``model_copy`` keeps the one pydantic call the
copied modules make.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class LLMProviderSettings:
    """One configured LLM endpoint (reference settings.py:22-27)."""

    provider: str
    model: str
    api_base: Optional[str] = None


@dataclass
class AppSettings:
    """Project-wide settings; every field can be overridden via SEMCODE_* env."""

    # -- workspace / registry -------------------------------------------------
    workspace_root: Optional[Path] = Path("./workspace")  # None = no workspace (ephemeral in-memory store)

    # -- API service ----------------------------------------------------------
    api_key: Optional[str] = None
    api_host: str = "0.0.0.0"
    api_port: int = 8000
    telemetry_enabled: bool = True
    # dynamic micro-batching of concurrent /query requests (0 disables)
    api_batch_window_ms: float = 3.0
    api_batch_max: int = 64
    # concurrent sub-groups per full batch window (1 disables): overlaps one
    # sub-group's host assembly/JSON with another's device scan
    api_batch_split: int = 2
    # pre-compile the serving path at startup (background; no-op when empty)
    api_warmup: bool = True
    # overload handling: pending-query bound (enqueue beyond it -> 503) and
    # per-query wall-clock timeout (exceeded -> 504); 0 disables either
    api_queue_max: int = 1024
    api_query_timeout_s: float = 120.0
    # worker threads for blocking pipeline work behind the async handlers
    api_max_workers: int = 4

    # -- embedding (on the device by default; remote providers optional) ------
    embedding_provider: str = "tpu-hash"  # tpu-hash | tpu-encoder | tpu-hybrid | openai | jina
    embedding_model: str = "code-hash-v1"
    embedding_dimension: int = 384
    embedding_api_base: Optional[str] = None
    embedding_api_key: Optional[str] = None
    embedding_batch_size: int = 64
    embedding_max_tokens: int = 512
    # tpu-encoder / tpu-hybrid specifics (models/encoder.py; without a
    # weights_path the mini preset reads the shipped encoder-mini checkpoint)
    encoder_preset: str = "mini"  # mini (L6/H384) | base (L12/H768) | large (L24/H1024)
    encoder_weights_path: Optional[Path] = None  # local HF-style dir (safetensors)
    encoder_dtype: str = "bfloat16"
    # tpu-hybrid provider: weight of the encoder part in the score mix
    # (1 - weight goes to the lexical hash part); index dimension is then
    # embedding_dimension + encoder hidden. 0.4 measured best on two
    # held-out repos (docs/BENCHMARKS.md quality table)
    embedding_hybrid_weight: float = 0.4
    # per-query adaptive mix: identifier-bearing queries lean lexical,
    # prose queries lean semantic (providers.HybridEmbeddings._query_weight)
    embedding_hybrid_adaptive: bool = True

    # -- TPU vector index (replaces the reference's Milvus section) -----------
    index_kind: str = "auto"  # flat | ivf | auto (flat until ivf_min_size rows)
    index_metric: str = "ip"  # ip | l2 | cosine
    # int8 by default: per-row-quantized corpus AND queries give EXACT integer
    # dots (s8 x s8 -> s32) — tighter scores than bf16 at half the bytes;
    # the fused f32 device rescore makes final ordering exact (index/scan.py)
    index_dtype: str = "int8"  # int8 | bfloat16 | float32
    # IVF fields: auto promotes the flat index to IVF at ivf_min_size rows
    index_nlist: int = 128  # reference milvus_store.py:81
    index_nprobe: int = 16  # reference milvus_store.py:144
    index_ivf_min_size: int = 8192  # below this, auto uses flat exact scan
    index_kmeans_iters: int = 12
    index_capacity: int = 0  # 0 = grow on demand
    index_snapshot_dir: Optional[Path] = None  # default: workspace_root/"index"
    upsert_batch_size: int = 128  # reference milvus_upsert_batch_size
    search_batch_size: int = 16
    # f32 host rescoring of the top (rescore x k) device candidates; recovers
    # bf16/int8 scoring precision (0 disables)
    index_rescore: int = 4
    # floor on the rescore fetch depth: deep enough that approx-topk +
    # low-precision scoring misses get recovered even at small top_k
    index_rescore_min: int = 128
    # cap accepted by API/store search entry points
    search_top_k_max: int = 1024
    # auto-compaction: reclaim tombstones once they exceed this fraction of
    # live rows AND the absolute floor (0 disables). Runs inline on the
    # write path under the store lock; lock-free readers keep serving the
    # previous snapshot during the re-pack (Milvus compacts server-side)
    index_auto_compact_ratio: float = 0.3
    index_auto_compact_min: int = 4096
    # approximate-selection recall target: read by the JAX package on a TPU
    # only; this engine's selection is always exact
    index_approx_recall_target: float = 0.95
    # fused f32 device rescore: None = auto (on while the f32 mirror fits
    # the HBM budget), True/False to force
    index_device_rescore: Optional[bool] = None
    # device rescore tier: auto (f32 mirror if it fits, else two-level int8
    # residual at 1/4 the footprint), or force f32 | residual | off
    index_rescore_mode: str = "auto"
    # full-matrix route's (Q, rows) score-matrix dtype. Experimental: auto
    # resolves to float32, as in the JAX package
    index_score_dtype: str = "auto"  # auto | float32 | float16
    # second-stage lexical rerank (index/rerank.py): when the caller passes
    # query TEXT (the RAG pipeline and the quality harness do), the dense
    # window of top_k*depth candidates is re-ordered by a blend of dense
    # score and window-BM25 over identifier-aware tokens. weight = lexical
    # share (0 disables). Defaults from the JAX package's held-out quality
    # sweep (docs/BENCHMARKS.md 2026-08-18): weight 0.8 improves every query
    # kind on both held-out corpora vs 0.5; depth 20 adds +0.014 MRR over 10
    # on aiohttp (the window is a gather, not a scan)
    search_rerank_weight: float = 0.8
    search_rerank_depth: int = 20
    # symbol bonus x the query's max idf when the query names a candidate's
    # defining symbol — literally OR as a joined word sequence ("parse
    # config file" -> parse_config_file; index/rerank.py
    # query_symbol_candidates). Shared by both scorer impls; held-out lab:
    # aiohttp MRR@10 0.78 -> 0.93 with the join channel + this default
    search_rerank_sym_bonus: float = 1.0
    # where the second stage runs: "auto" scores the blend ON DEVICE (BM25
    # over per-row term fingerprints, chained after the scan,
    # index/lexical.py) whenever fingerprints are available and the dense
    # scores are already final (fused device rescore active), falling back
    # to the host scorer otherwise; "device" forces it; "host" keeps the
    # round-3 host BM25 (index/rerank.py)
    search_rerank_impl: str = "auto"  # auto | device | host
    # learned term-embedding MaxSim channel (models/term_reranker.py) on the
    # DEVICE rerank path: "auto" loads the shipped table asset when present,
    # "off" disables, any other value is a path to a trained .npz. The
    # channel rewards RELATED (not just identical) query/doc subtokens —
    # the synonymy axis BM25 cannot score. Host-impl reranks stay BM25-only.
    search_rerank_learned: str = "auto"  # auto | off | <path>
    # applied through TWO safety gates (index/lexical.py): headroom (can
    # only promote candidates below the current best) and lexical coverage
    # (fades out as BM25 matches more of the query's idf mass) — measured
    # strictly non-negative on both frozen sets at this default
    search_rerank_learned_weight: float = 0.8
    # fingerprint slots per row for the device scorer (0 = library default,
    # currently 192 — the measured host-parity point; see index/lexical.py).
    # Memory knob: ~6 bytes/slot/row in device memory
    search_rerank_terms: int = 0
    # exact-path rescore candidate pool; 0 = auto (max(4k, 128)). The
    # recall lever for lossy storage: a wider pool recovers more
    # quantized-ranking misses at ~linear gather cost
    index_fetch_width: int = 0
    index_rescore_width: int = 0
    # exact-scan route: auto and xla run the full score matrix; pallas runs
    # the hand-written fused top-2 kernel (ops/scan_top2, CUDA on a card)
    index_scan_impl: str = "auto"  # auto | xla | pallas

    # -- mesh / parallelism ----------------------------------------------------
    # the store's mesh (parallel/mesh.get_mesh, parallel/distributed): corpus
    # rows shard over it; the CPU holds as many shards as the shape asks for
    mesh_shape: str = ""  # e.g. "8" or "4x2"; empty = all local devices, 1-D
    mesh_axis_names: str = "data"
    mesh_coordinator: Optional[str] = None
    mesh_num_processes: int = 1
    mesh_process_id: int = 0

    # -- RAG ------------------------------------------------------------------
    rag_provider: str = "fallback"  # fallback | openai | openai-compatible | tpu-lm
    rag_model: str = "gpt-4o"
    rag_api_base: Optional[str] = None
    rag_api_key: Optional[str] = None
    rag_temperature: float = 0.0
    # tpu-lm provider: in-process causal LM (models/decoder.py) on the card
    rag_weights_path: Optional[Path] = None  # local HF GPT-2-family dir
    rag_preset: str = "mini"  # used only when weights_path is unset
    rag_max_new_tokens: int = 192
    rag_system_prompt: str = (
        "You are a senior software engineer helping teammates understand codebases. "
        "Use the provided context to answer succinctly and cite files that support "
        "your answer."
    )
    rag_prompt_template: Optional[str] = None
    rag_fallback_enabled: bool = True
    # faithfulness gate: definition claims in a generated answer ("`X` is
    # defined in path") must match the retrieved context, or the pipeline
    # emits the extractive fallback instead of an invented definition (the
    # in-process tpu-lm answers through whatever retrieval surfaces and will
    # fabricate a definition when the asked symbol is absent)
    rag_grounding_guard: bool = True
    rag_query_cache_size: int = 256  # LRU entries; 0 disables
    rag_max_context_sources: int = 5
    rag_fallback_max_sources: int = 3
    rag_fallback_summary_sentences: int = 3
    default_llm: str = "gpt-4o"
    llm_endpoints: List[LLMProviderSettings] = field(default_factory=list)

    # -- chunking / ingestion ---------------------------------------------------
    # incremental re-index: skip re-embedding chunks whose content hash is
    # unchanged and prune stored chunks the repo no longer produces
    incremental_reindex: bool = True
    chunk_max_lines: int = 200  # reference tree_sitter_chunker.py:64
    chunk_max_chars: int = 6000  # reference tree_sitter_chunker.py:65
    chunk_chars_per_token_estimate: float = 1.0

    # -- frontend ---------------------------------------------------------------
    frontend_api_root: str = "http://localhost:8000"
    frontend_api_key: Optional[str] = None
    frontend_port: int = 8501
    frontend_request_timeout: int = 30

    def __post_init__(self) -> None:
        # the coercions pydantic applied on construction: path strings from
        # TOML/env become Paths, ints become floats, endpoint dicts become
        # LLMProviderSettings
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            if "Path" in f.type and not isinstance(value, Path):
                setattr(self, f.name, Path(value))
            elif f.type == "float" and isinstance(value, int):
                setattr(self, f.name, float(value))
        self.llm_endpoints = [
            e if isinstance(e, LLMProviderSettings) else LLMProviderSettings(**e)
            for e in self.llm_endpoints
        ]

    def model_copy(self, update: Optional[Dict[str, Any]] = None) -> "AppSettings":
        """A copy with ``update`` applied (pydantic's name, kept for callers
        shared with the JAX package)."""
        return dataclasses.replace(self, **(update or {}))


_FIELD_TYPES: Dict[str, str] = {
    f.name: f.type for f in dataclasses.fields(AppSettings)
}


_CONFIG_ENV_VAR = "SEMCODE_CONFIG_PATH"
_DEFAULT_CONFIG_FILE = Path("semcode_settings.toml")
_PROVIDER_ENV_MAPPING = {
    "openai_api_key": "OPENAI_API_KEY",
    "cohere_api_key": "COHERE_API_KEY",
    "jina_api_key": "JINA_API_KEY",
    "huggingfacehub_api_token": "HUGGINGFACEHUB_API_TOKEN",
}


def _load_toml_config() -> Dict[str, Any]:
    """Load the primary TOML config file, if present."""
    candidates: List[Path] = []
    override = os.getenv(_CONFIG_ENV_VAR)
    if override:
        candidates.append(Path(override))
    candidates.append(_DEFAULT_CONFIG_FILE)
    for candidate in candidates:
        if candidate.is_file():
            with candidate.open("rb") as handle:
                return tomllib.load(handle)
    return {}


def _blank_to_none(value: Any) -> Any:
    if isinstance(value, str) and value.strip() == "":
        return None
    return value


# TOML section -> (toml key, settings field) mappings. Keeps the grouped file
# layout of the reference (semcode_settings.toml.sample) while the model stays
# flat.
_SECTION_FIELDS: Dict[str, Dict[str, str]] = {
    "workspace": {"root": "workspace_root"},
    "general": {"api_key": "api_key", "telemetry_enabled": "telemetry_enabled"},
    "api": {
        "host": "api_host",
        "port": "api_port",
        "batch_window_ms": "api_batch_window_ms",
        "batch_max": "api_batch_max",
        "batch_split": "api_batch_split",
        "warmup": "api_warmup",
        "max_workers": "api_max_workers",
        "queue_max": "api_queue_max",
        "query_timeout_s": "api_query_timeout_s",
    },
    "embedding": {
        "provider": "embedding_provider",
        "model": "embedding_model",
        "dimension": "embedding_dimension",
        "api_base": "embedding_api_base",
        "api_key": "embedding_api_key",
        "batch_size": "embedding_batch_size",
        "max_tokens": "embedding_max_tokens",
        "hybrid_weight": "embedding_hybrid_weight",
        "hybrid_adaptive": "embedding_hybrid_adaptive",
    },
    "encoder": {
        "preset": "encoder_preset",
        "weights_path": "encoder_weights_path",
        "dtype": "encoder_dtype",
    },
    "index": {
        "kind": "index_kind",
        "metric": "index_metric",
        "dtype": "index_dtype",
        "nlist": "index_nlist",
        "nprobe": "index_nprobe",
        "ivf_min_size": "index_ivf_min_size",
        "kmeans_iters": "index_kmeans_iters",
        "capacity": "index_capacity",
        "snapshot_dir": "index_snapshot_dir",
        "upsert_batch_size": "upsert_batch_size",
        "search_batch_size": "search_batch_size",
        "rescore": "index_rescore",
        "rescore_min": "index_rescore_min",
        "top_k_max": "search_top_k_max",
        "rerank_weight": "search_rerank_weight",
        "rerank_depth": "search_rerank_depth",
        "rerank_learned": "search_rerank_learned",
        "rerank_learned_weight": "search_rerank_learned_weight",
        "rerank_impl": "search_rerank_impl",
        "rerank_terms": "search_rerank_terms",
        "rerank_sym_bonus": "search_rerank_sym_bonus",
        "approx_recall_target": "index_approx_recall_target",
        "device_rescore": "index_device_rescore",
        "rescore_mode": "index_rescore_mode",
        "score_dtype": "index_score_dtype",
        "fetch_width": "index_fetch_width",
        "rescore_width": "index_rescore_width",
        "scan_impl": "index_scan_impl",
        "auto_compact_ratio": "index_auto_compact_ratio",
        "auto_compact_min": "index_auto_compact_min",
    },
    "mesh": {
        "shape": "mesh_shape",
        "axis_names": "mesh_axis_names",
        "coordinator": "mesh_coordinator",
        "num_processes": "mesh_num_processes",
        "process_id": "mesh_process_id",
    },
    "rag": {
        "provider": "rag_provider",
        "model": "rag_model",
        "api_base": "rag_api_base",
        "api_key": "rag_api_key",
        "temperature": "rag_temperature",
        "weights_path": "rag_weights_path",
        "preset": "rag_preset",
        "max_new_tokens": "rag_max_new_tokens",
        "system_prompt": "rag_system_prompt",
        "prompt_template": "rag_prompt_template",
        "fallback_enabled": "rag_fallback_enabled",
        "grounding_guard": "rag_grounding_guard",
        "query_cache_size": "rag_query_cache_size",
        "max_context_sources": "rag_max_context_sources",
        "fallback_max_sources": "rag_fallback_max_sources",
        "fallback_summary_sentences": "rag_fallback_summary_sentences",
    },
    "chunking": {
        "max_lines": "chunk_max_lines",
        "max_chars": "chunk_max_chars",
        "chars_per_token_estimate": "chunk_chars_per_token_estimate",
    },
    "ingestion": {
        "chunk_chars_per_token_estimate": "chunk_chars_per_token_estimate",
        "incremental_reindex": "incremental_reindex",
    },
    "frontend": {
        "api_root": "frontend_api_root",
        "api_key": "frontend_api_key",
        "port": "frontend_port",
        "request_timeout": "frontend_request_timeout",
    },
}


def _flatten_config(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Translate grouped TOML sections into AppSettings keyword arguments."""
    data: Dict[str, Any] = {}
    for section, fields in _SECTION_FIELDS.items():
        body = raw.get(section, {})
        if not isinstance(body, dict):
            continue
        for key, field in fields.items():
            if key in body:
                data[field] = _blank_to_none(body[key])
    llm = raw.get("llm", {})
    if isinstance(llm, dict):
        if "default" in llm:
            data["default_llm"] = llm["default"]
        endpoints = llm.get("endpoints")
        if isinstance(endpoints, list):
            data["llm_endpoints"] = [LLMProviderSettings(**e) for e in endpoints]
    return data


def _apply_environment_overrides(raw: Dict[str, Any]) -> None:
    """Export [environment]/[providers] TOML keys into the process env."""
    env_section = raw.get("environment", {})
    tok = env_section.get("tokenizers_parallelism")
    if tok is not None:
        os.environ["TOKENIZERS_PARALLELISM"] = str(tok).lower()
    providers = raw.get("providers", {})
    for key, env_name in _PROVIDER_ENV_MAPPING.items():
        value = providers.get(key)
        if value:
            os.environ[env_name] = value


_ENV_PREFIX = "SEMCODE_"


def _coerce(field: str, value: str) -> Any:
    """Coerce an env-var string to the declared field type."""
    ann = _FIELD_TYPES.get(field)
    if ann is None:
        return value
    if "bool" in ann:
        return value.strip().lower() in {"1", "true", "yes", "on"}
    if "int" in ann and "Path" not in ann:
        try:
            return int(value)
        except ValueError:
            return value
    if "float" in ann:
        try:
            return float(value)
        except ValueError:
            return value
    if "List" in ann or "list" in ann:
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            return [v for v in value.split(",") if v]
    return _blank_to_none(value)


def _env_overrides() -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, value in os.environ.items():
        if not name.startswith(_ENV_PREFIX) or name == _CONFIG_ENV_VAR:
            continue
        field = name[len(_ENV_PREFIX):].lower()
        if field in _FIELD_TYPES:
            out[field] = _coerce(field, value)
    return out


def load_settings() -> AppSettings:
    raw = _load_toml_config()
    _apply_environment_overrides(raw)
    flattened = _flatten_config(raw)
    flattened.update(_env_overrides())
    return AppSettings(**flattened)


settings = load_settings()
