"""Per-layer quantities the program records itself: the span totals of
``semcode_tpu_torch.utils.tracing``, read after the window.

The program's spans are on while a ``torch.profiler`` records, so in a
``--trace 1`` run the search spans hold the traced slice's calls and no
other; the build's phases keep their totals whether tracing is on or not.
A program without these totals (an older checkout) gives None, and the
harness leaves the metric out.
"""

from __future__ import annotations

from typing import Optional


def span_totals(name: str) -> Optional[dict]:
    """``{"count", "seconds"}`` of the program's span ``name``, or None."""
    try:
        from semcode_tpu_torch.utils import tracing

        spans = tracing.snapshot()["spans"]
    except (ImportError, AttributeError, KeyError):
        return None
    tot = spans.get(name)
    return tot if tot and tot["count"] > 0 else None


def totals() -> Optional[dict]:
    """The program's counters and span totals now, or None."""
    try:
        from semcode_tpu_torch.utils import tracing

        return tracing.snapshot()
    except (ImportError, AttributeError):
        return None


def delta(before: Optional[dict], after: Optional[dict]) -> dict:
    """What the program added to its totals between two ``totals()``:
    ``{"counters": {name: n}, "spans": {name: {"count", "seconds"}}}``,
    names that did not move left out."""
    if before is None or after is None:
        return {}
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in after["counters"].items()}
    spans = {}
    for k, v in after["spans"].items():
        was = before["spans"].get(k, {"count": 0, "seconds": 0.0})
        if v["count"] > was["count"]:
            spans[k] = {"count": v["count"] - was["count"],
                        "seconds": v["seconds"] - was["seconds"]}
    return {"counters": {k: v for k, v in counters.items() if v},
            "spans": spans}


def host_ms_per_call(ctx) -> Optional[float]:
    """Mean host milliseconds of the program's ``ivf.search`` span over the
    traced calls: routing and enqueueing one call, profiler-inflated like
    every traced number."""
    tot = span_totals("ivf.search")
    if tot is None or not ctx.trace.spans:
        return None
    return 1e3 * tot["seconds"] / tot["count"]


def kmeans_seconds(ctx) -> Optional[float]:
    """Seconds in the build's k-means (``ivf.build.kmeans``: k-means++ and
    Lloyd, ending at the centroids' copy to the host)."""
    tot = span_totals("ivf.build.kmeans")
    return None if tot is None else tot["seconds"]


def layout_seconds(ctx) -> Optional[float]:
    """Seconds in the build's layout (``ivf.build.layout``: candidate
    clusters on the device, the balanced assignment on the host, the
    location table)."""
    tot = span_totals("ivf.build.layout")
    return None if tot is None else tot["seconds"]
