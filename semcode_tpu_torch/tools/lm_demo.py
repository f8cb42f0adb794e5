"""Retrieve -> generate demo: the ``tpu-lm`` answer path, warm.

Counterpart of ``tools/lm_demo.py``. Drives the production pipeline (store
retrieval -> ``chat_structured`` -> KV-cached greedy decode, replayed as a
CUDA graph on the card) in ONE process over several questions, so every
query after the first shows the WARM decode latency: the CLI runs one
process per query, and its ``llm`` stage then carries the decoder's load
and graph capture. Prints one JSON line per question, with the JAX tool's
keys.

Prereq: an ingested workspace and a decoder checkpoint written by either
package's ``save_lm_params`` (the JAX package's ``train-lm``), e.g.:

  export SEMCODE_WORKSPACE_ROOT=/tmp/ws_lm
  python -m semcode_tpu_torch.cli ingest --name semcode --include semcode_tpu --root . -y

Usage (the card by default; ``SEMCODE_TORCH_DEVICE=cpu`` for the CPU):

  SEMCODE_WORKSPACE_ROOT=/tmp/ws_lm SEMCODE_RAG_PROVIDER=tpu-lm \\
  SEMCODE_RAG_WEIGHTS_PATH=semcode_tpu_torch/assets/lm-tiny \\
  python -m semcode_tpu_torch.tools.lm_demo [question ...]
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

_DEFAULT_QUESTIONS = [
    # the two trained grammar forms, anchored on symbols the corpus tags
    "what does quantize_rows do?",
    "where is hierarchical_topk_merge defined?",
    "what does WindowBatcher do?",
    "what does build_qa_texts do?",
]


def main(argv: Optional[List[str]] = None, pipeline=None) -> None:
    questions = (sys.argv[1:] if argv is None else argv) or _DEFAULT_QUESTIONS

    if pipeline is None:
        from ..rag import SemanticSearchPipeline

        pipeline = SemanticSearchPipeline()
    for i, q in enumerate(questions):
        t0 = time.perf_counter()
        out = pipeline.query(q, top_k=5)
        wall_ms = (time.perf_counter() - t0) * 1000
        print(json.dumps({
            "question": q,
            "answer": out["answer"],
            "fallback_used": out["meta"].get("fallback_used"),
            "top_source": (out["sources"][0]["path"]
                           if out["sources"] else None),
            "wall_ms": round(wall_ms, 1),
            "stage_ms": {k: round(v, 1) for k, v in
                         (out["meta"].get("timings_ms") or {}).items()},
            "warm": i > 0,
        }, ensure_ascii=False), flush=True)


if __name__ == "__main__":
    main()
