"""Retrieval-quality evaluation harness."""

from .quality import (
    QualityQuery,
    QualityReport,
    build_eval_store,
    evaluate_store,
    generate_queries,
    load_frozen_queries,
)

__all__ = [
    "QualityQuery",
    "QualityReport",
    "build_eval_store",
    "evaluate_store",
    "generate_queries",
    "load_frozen_queries",
]
