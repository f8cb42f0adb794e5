"""Per-layer quantities read from a traced slice (``harness.ReadContext``).

Each ``metrics/<name>.py`` exposes one of these as ``read``; a quantity that
moves different end-to-end metrics in different cells has one file a name
(``search_roofline.serve``, ``search_roofline.bulk``). A reader that finds
nothing to read returns None, and the harness leaves the metric out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def search_roofline(ctx) -> Optional[float]:
    """The traced searches' least device time (``roofline.search_seconds``:
    the work an IVF_FLAT search of this configuration needs, whatever route
    the program takes) over the device time inside the harness's search
    spans, in percent."""
    spent = ctx.trace.span_device_s()
    if spent <= 0 or not ctx.probed or len(ctx.probed) != len(ctx.trace.spans):
        return None
    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    nprobe = int(traffic.get("nprobe") or cfg["index"]["nprobe"])
    need = sum(ctx.roofline.search_seconds(cfg, int(traffic["batch"]), int(traffic["k"]),
                                           nprobe, u) for u in ctx.probed)
    return 100.0 * need / spent


def launches_per_call(ctx) -> Optional[float]:
    """Device operations (kernels, copies, sets) that start inside a search
    span, per span."""
    if not ctx.trace.spans or not ctx.trace.device_ops:
        return None
    return ctx.trace.ops_in_spans() / len(ctx.trace.spans)


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced slice's wall time in which no operation ran on
    the device."""
    if ctx.trace.wall_s <= 0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall_s)


def untraced_p95_ms(ctx) -> Optional[float]:
    """The 95th percentile, in ms, of the window's calls on the host clock,
    those of the traced slice left out (the profiler slows them): a traced
    run's reading of what ``p95_ms`` reads in an untraced one."""
    traced = set(ctx.trace.calls)
    lat = [s for c, s in enumerate(ctx.latency_s) if c not in traced]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95) * 1e3)


def build_seconds(ctx) -> Optional[float]:
    """Seconds from the first ``add`` to the synchronised end of ``bulk``."""
    return ctx.build_s
