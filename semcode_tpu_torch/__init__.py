"""semcode_tpu_torch: the semcode-tpu engine on PyTorch and CUDA.

A port of the JAX package ``semcode_tpu`` (which stays the reference) to
PyTorch on one NVIDIA Hopper card. It imports nothing of the JAX package:
host-side modules are copied, device code is plain torch, and the exact
scan's Pallas kernel is a hand-written CUDA kernel (``ops/``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"`` (or sets
``SEMCODE_TORCH_DEVICE=cpu``).

Subpackages:
    chunking    host-side code chunker (line/char budget + symbol tagging)
    ingestion   workspace copy / ignore patterns / language detection
    embeddings  embedding provider factory (hash embedder + HTTP providers)
    ops         CUDA kernels and their plain torch versions
    index       flat index + vector store (device BM25 rerank, snapshots)
    storage     repository registry
    services    the ingest pipeline orchestrator
    rag         query pipeline (retrieve -> prompt -> LLM / fallback)
    eval        retrieval-quality harness
    api         aiohttp HTTP server (micro-batched /query, jobs, telemetry)
    frontend    built-in web UI and launcher
    tools       kernel-measurement tools, frozen-set diagnosis, CLI smoke,
                the /query SLO harness
"""

from .version import __version__, get_version

__all__ = ["__version__", "get_version"]
