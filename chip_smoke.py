"""Drive the PyTorch engine (semcode_tpu_torch) on one CUDA card and check it.

Run from the repository root, with no arguments, on a machine with one
NVIDIA Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):

1. report the card and build the kernels from the sources in the checkout
   (the CUDA scan kernel with nvcc and the native featurizer with g++, in
   parallel);
2. hold the top2_scan kernel against its plain torch version on the card:
   int8 / bf16 / f32 storage, Rs in {100, 128, 1000, 70001}, d in {128,
   384, 3072}, Q in {1, 8, 512}, ip and l2, ~5% dead rows. int8: identical
   rows and bit-identical scores; bf16/f32: scores within rtol 1e-5 (atol
   1e-6), first rows identical wherever a block's top-2 gap exceeds 1e-4,
   and every picked row scoring as the plain version's pick (runner-ups
   may swap with a near-tied third: f32 sums run in another order);
3. the main path end to end: IndexerService ingests the repository's own
   ``semcode_tpu/`` (the frozen query set's corpus) into a flat int8 store
   routed through the kernel (index_scan_impl="pallas"), and the RAG
   pipeline answers the 102 frozen queries with the extractive fallback.
   Kernel launch counts are read around this run. Reports the batch's
   pipeline stages and a torch.profiler breakdown of it, MRR@10,
   recall@10 and p50 single-query latency on the kernel and full-matrix
   routes, and checks the first 8 queries' top-10 paths against the same
   engine on the CPU (plain versions);
4. scale: a 1M x 384 int8 FlatIndex with its f32 rescore mirror (the JAX
   package's bench.py flagship shape, a clustered Gaussian mixture made on
   the card from a seeded torch.Generator): recall@10 against an f32
   brute-force oracle (TF32 off) on both routes (>= 0.99 required on the
   kernel route), QPS at batch 512, p50 latency at batch 8, and the
   kernel's time per batch-512 call (CUDA events) beside its plain
   version, one PyTorch-library computation of the same selection, and
   its bound; plus a torch.profiler breakdown of one batch-512 search.

Prints the ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 1_000_000
DIM = 384
BATCH = 512
SERVE_BATCH = 8
# published H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor-core
# operations and HBM3 bandwidth; used for the kernel's bound
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"CHECK FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: kernel against its plain version ---------------------------------


def kernel_inputs(storage, rs, d, nq, metric, gen):
    """Shard operands as the exact scan builds them (index/scan.py)."""
    import torch

    from semcode_tpu_torch.index.flat import quantize_rows_device
    from semcode_tpu_torch.index.scan import quantize_queries_device
    from semcode_tpu_torch.ops.scan_top2 import NEG

    x = torch.randn(rs, d, generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn(nq, d, generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    dead = torch.rand(rs, generator=gen, device="cuda") < 0.05
    add = torch.where(dead, NEG, 0.0).float()
    if metric == "l2":
        add = add - (x * x).sum(dim=1)
    if storage == "int8":
        vecs, mult = quantize_rows_device(x)
        qq, qsc = quantize_queries_device(q)
    else:
        vecs = x.to(torch.bfloat16 if storage == "bfloat16" else torch.float32)
        mult = torch.ones(rs, device="cuda")
        qq, qsc = q.to(torch.bfloat16), torch.ones(nq, device="cuda")
    if metric == "l2":
        mult = 2.0 * mult
    return vecs, mult.contiguous(), add.contiguous(), qq, qsc


def plain_scores(vecs, mult, add, qq, qsc):
    """(Q, nb*128) scores by the plain version's arithmetic, -3e38 past Rs."""
    import torch

    from semcode_tpu_torch.ops.scan_top2 import BLOCK, NEG

    rs = vecs.shape[0]
    nb = -(-rs // BLOCK)
    v64 = vecs.to(torch.bfloat16).to(torch.float64)
    raw = (qq.to(torch.float64) @ v64.T).to(torch.float32)
    s = raw * qsc[:, None] * mult[None, :] + add[None, :]
    out = torch.full((qq.shape[0], nb * BLOCK), NEG, device=vecs.device)
    out[:, :rs] = s
    return out


def check_float_rows(args, bm, br, rm, rr, tag) -> None:
    """bf16/f32 storage: f32 sums run in another order, so a block's
    runner-up may swap with a near-tied third. Required: first-slot rows
    identical wherever the block's top-2 gap exceeds 1e-4, and every picked
    row inside its block, scoring (plain arithmetic) within rtol 1e-5 of
    the plain version's pick for that slot."""
    import torch

    nb = bm.shape[1] // 2
    gap = (rm[:, :nb] - rm[:, nb:]).abs() > 1e-4
    if not torch.equal(br[:, :nb][gap], rr[:, :nb][gap]):
        fail(f"top2_scan {tag}: first rows differ")
    blk = torch.arange(nb, device=br.device).repeat(2)
    if not torch.equal(br.long() // 128, blk.expand_as(br)):
        fail(f"top2_scan {tag}: a picked row lies outside its block")
    picked = torch.gather(plain_scores(*args), 1, br.long())
    if not torch.allclose(picked, rm, rtol=1e-5, atol=1e-6):
        fail(f"top2_scan {tag}: a picked row does not score as the plain pick")


def check_kernel() -> float:
    import torch

    from semcode_tpu_torch.ops.scan_top2 import top2_scan, top2_scan_reference

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = 0.0
    n = 0
    for storage in ("int8", "bfloat16", "float32"):
        for rs in (100, 128, 1000, 70001):
            for d in (128, 384, 3072):
                for nq in (1, 8, 512):
                    for metric in ("ip", "l2"):
                        args = kernel_inputs(storage, rs, d, nq, metric, gen)
                        bm, br = top2_scan(*args)
                        torch.cuda.synchronize()
                        rm, rr = top2_scan_reference(*args)
                        err = (bm - rm).abs().max().item()
                        worst = max(worst, err)
                        tag = f"{storage} Rs={rs} d={d} Q={nq} {metric}"
                        if storage == "int8":
                            if not (torch.equal(bm, rm) and torch.equal(br, rr)):
                                fail(f"top2_scan {tag}: not bit-identical "
                                     f"(max err {err})")
                        else:
                            if not torch.allclose(bm, rm, rtol=1e-5, atol=1e-6):
                                fail(f"top2_scan {tag}: scores off by {err}")
                            check_float_rows(args, bm, br, rm, rr, tag)
                        n += 1
                        del args, bm, br, rm, rr
    log(f"[kernel] top2_scan matches its plain version in {n} cases "
        f"(max |score err| {worst:.3g})")
    return worst


# -- phase 3: the main path end to end -----------------------------------------


def frozen_queries():
    data = json.loads(
        (ROOT / "tests" / "fixtures" / "frozen_queries.json").read_text()
    )
    return [(q["query"], q["relevant_paths"]) for q in data["queries"]]


def rank_metrics(results, labels):
    rr, hit = [], []
    for res, rel in zip(results, labels):
        rank = None
        for pos, src in enumerate(res["sources"][:10], start=1):
            path = src["path"] or ""
            if any(path == p or path.endswith("/" + p) for p in rel):
                rank = pos
                break
        rr.append(1.0 / rank if rank else 0.0)
        hit.append(1.0 if rank else 0.0)
    return sum(rr) / len(rr), sum(hit) / len(hit)


def p50_latency_ms(pipe, questions) -> float:
    times = []
    for qtext in questions:
        t0 = time.perf_counter()
        pipe.query(qtext, top_k=10)  # host results: ends in a device sync
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main_path(workdir: Path):
    import torch

    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.services import IndexerService
    from semcode_tpu_torch.settings import AppSettings

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    labels = [rel for _, rel in queries]

    def ingest(device: str):
        cfg = AppSettings(
            workspace_root=workdir / device,
            index_kind="flat",
            index_scan_impl="pallas",
            rag_provider="fallback",
            rag_query_cache_size=0,
        )
        svc = IndexerService(config=cfg, device=device)
        res = svc.index_repository([ROOT / "semcode_tpu"], "semcode_tpu")
        pipe = SemanticSearchPipeline(
            config=cfg, vector_store=svc.vector_store,
            embeddings=svc.embeddings, device=device,
        )
        return res, svc, pipe

    top2_scan.launches = 0
    t0 = time.perf_counter()
    res, svc, pipe = ingest("cuda")
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = pipe.query_batch(questions, top_k=10)
    t_batch = time.perf_counter() - t0
    launches = top2_scan.launches
    if launches < 1:
        fail("the main path never launched the top2_scan kernel")
    for qtext, r in zip(questions, results):
        meta = r.get("meta") or {}
        if not r["sources"]:
            fail(f"no hits for frozen query {qtext!r}")
        if not (meta.get("fallback_used")
                and meta.get("reason") == "no_llm_configured"
                and r["answer"]):
            fail(f"no fallback answer for {qtext!r}: {meta}")
    mrr, recall = rank_metrics(results, labels)
    log(f"[e2e] ingested {res.chunk_count} chunks of semcode_tpu/ in "
        f"{t_ingest:.2f} s; 102 queries in one batch: {t_batch * 1e3:.1f} ms; "
        f"top2_scan launches {launches}")
    # where the batch's time goes: the pipeline's host-clock stages (device
    # work is asynchronous, so it lands in the first stage that reads
    # results back), then the kernels on the card
    stages = results[0]["meta"]["batch_timings_ms"]
    log("[e2e] batch stages (host ms): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in stages.items()))
    profile = device_breakdown(lambda: pipe.query_batch(questions, top_k=10),
                               f"{len(questions)}-query batch, kernel route")
    index = svc.vector_store._index
    p50_pallas = p50_latency_ms(pipe, questions)
    index.scan_impl = "xla"
    results_xla = pipe.query_batch(questions, top_k=10)
    mrr_x, recall_x = rank_metrics(results_xla, labels)
    p50_xla = p50_latency_ms(pipe, questions)
    index.scan_impl = "pallas"
    log(f"[e2e] pallas route: MRR@10 {mrr:.4f} recall@10 {recall:.4f} "
        f"p50 query {p50_pallas:.2f} ms")
    log(f"[e2e] xla route:    MRR@10 {mrr_x:.4f} recall@10 {recall_x:.4f} "
        f"p50 query {p50_xla:.2f} ms")

    # the same engine on the CPU, plain versions only: a check, not a fallback
    _, svc_cpu, pipe_cpu = ingest("cpu")
    if not torch.equal(svc.embeddings._proj.cpu(), svc_cpu.embeddings._proj):
        fail("the hash projection generated on the card differs from the CPU's")
    cpu_results = pipe_cpu.query_batch(questions[:8], top_k=10)
    for qtext, a, b in zip(questions, results, cpu_results):
        pa = [s["path"] for s in a["sources"]]
        pb = [s["path"] for s in b["sources"]]
        if pa != pb:
            fail(f"card and CPU disagree on {qtext!r}:\n{pa}\n{pb}")
    log("[e2e] hash projection bit-equal to the CPU's; first 8 queries: card "
        "top-10 paths equal the CPU engine's")
    return {
        "launches": launches, "mrr": mrr, "recall": recall, "mrr_xla": mrr_x,
        "recall_xla": recall_x, "p50_pallas_ms": p50_pallas,
        "p50_xla_ms": p50_xla, "chunks": res.chunk_count,
        "stages_ms": stages, "breakdown": profile,
    }


# -- phase 4: scale -----------------------------------------------------------


def mixture(gen, n, d):
    """bench.py's corpus: unit rows around max(64, n/1000) Gaussian centers."""
    import torch

    n_centers = max(64, n // 1000)
    centers = torch.randn(n_centers, d, generator=gen, device="cuda")
    assign = torch.randint(0, n_centers, (n,), generator=gen, device="cuda")
    x = centers[assign]
    x.add_(0.35 * torch.randn(n, d, generator=gen, device="cuda"))
    return x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9)


def oracle_top10(x, q):
    import torch

    best_s, best_i = [], []
    for lo in range(0, x.shape[0], 1 << 18):
        s = q @ x[lo:lo + (1 << 18)].T  # f32, TF32 off
        v, i = torch.topk(s, 10, dim=1)
        best_s.append(v)
        best_i.append(i + lo)
    s = torch.cat(best_s, dim=1)
    i = torch.cat(best_i, dim=1)
    _, sel = torch.topk(s, 10, dim=1)
    return torch.gather(i, 1, sel)


def recall_at_10(ids, truth) -> float:
    hits = (ids[:, :, None] == truth[:, None, :]).any(dim=2).sum().item()
    return hits / truth.numel()


def device_breakdown(fn, label: str, iters: int = 5):
    """Device time by kernel over ``iters`` calls of ``fn`` (torch.profiler,
    CUDA activity), with the device-busy share of the wall time. Only device
    events count: a CPU operator's device time is that of the kernels it
    launched, which are listed on their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / iters))
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for name, ms in rows[:8]:
        log(f"[profile]   {ms:8.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy,
            "top": [[name[:60], ms] for name, ms in rows[:5]]}


def scale_phase():
    import torch

    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.scan import quantize_queries_device
    from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan, top2_scan_reference

    gen = torch.Generator(device="cuda").manual_seed(42)
    t0 = time.perf_counter()
    x = mixture(gen, N_ROWS, DIM)
    pick = torch.randperm(N_ROWS, generator=gen, device="cuda")[:BATCH]
    q = x[pick] + 0.05 * torch.randn(BATCH, DIM, generator=gen, device="cuda")
    q = q / torch.clamp(q.norm(dim=1, keepdim=True), min=1e-9)
    index = FlatIndex(DIM, metric="ip", dtype="int8", scan_impl="pallas",
                      device="cuda")
    index.add(x.cpu().numpy())
    truth = oracle_top10(x, q)
    del x
    torch.cuda.synchronize()
    log(f"[scale] {N_ROWS} x {DIM} int8 index + f32 mirror built in "
        f"{time.perf_counter() - t0:.1f} s (rescore "
        f"{'on' if index.device_rescore_active else 'off'})")

    out = {}
    for route in ("pallas", "xla"):
        index.scan_impl = route
        _, ids = index.search_device(q, 10)
        rec = recall_at_10(ids, truth)
        iters = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            index.search_device(q, 10)
        torch.cuda.synchronize()
        qps = BATCH * iters / (time.perf_counter() - t0)
        lat = []
        for i in range(50):
            qb = q[(i * SERVE_BATCH) % BATCH:][:SERVE_BATCH]
            t0 = time.perf_counter()
            index.search_device(qb, 10)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        out[route] = {"recall": rec, "qps": qps, "p50_b8_ms": statistics.median(lat)}
        log(f"[scale] {route}: recall@10 {rec:.4f}  QPS@{BATCH} {qps:.0f}  "
            f"p50@{SERVE_BATCH} {out[route]['p50_b8_ms']:.2f} ms")
    index.scan_impl = "pallas"
    out["breakdown"] = device_breakdown(
        lambda: index.search_device(q, 10), f"batch-{BATCH} kernel-route search"
    )
    if out["pallas"]["recall"] < 0.99:
        fail(f"pallas-route recall@10 {out['pallas']['recall']:.4f} < 0.99")

    # the kernel at the main path's shape, with the operands the scan builds
    vecs, norms, valid, scales, _, _ = index._ensure_device()
    qq, qsc = quantize_queries_device(q)
    add = torch.where(valid, 0.0, NEG).float()
    args = (vecs, scales, add, qq, qsc)
    calls = top2_scan.launches
    kernel_ms = cuda_ms(lambda: top2_scan(*args), iters=20)
    bm, br = top2_scan(*args)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: top2_scan_reference(*args), iters=3, warmup=1)
    rm, rr = top2_scan_reference(*args)
    if not (torch.equal(bm, rm) and torch.equal(br, rr)):
        fail("top2_scan differs from its plain version at the main-path shape")
    err = (bm - rm).abs().max().item()
    del rm, rr
    rows = vecs.shape[0]
    nb = -(-rows // 128)

    def library():
        # one PyTorch computation of the same selection: cuBLASLt int8 GEMM,
        # the epilogue, and topk(2) over each 128-row block
        raw = torch._int_mm(qq, vecs.T).float()
        s = raw * qsc[:, None] * scales[None, :] + add[None, :]
        return torch.topk(s.view(BATCH, nb, 128), 2, dim=2)

    library_ms = cuda_ms(library, iters=5)
    n_bytes = rows * DIM + 2 * rows * 4 + BATCH * DIM + BATCH * 4 + BATCH * 2 * nb * 8
    n_ops = 2 * BATCH * rows * DIM
    bound_ms = max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_INT8_OPS) * 1e3
    bound_by = "operations" if n_ops / PEAK_INT8_OPS >= n_bytes / PEAK_HBM_BYTES else "bytes"
    log(f"[scale] top2_scan {rows} x {DIM} int8, Q={BATCH}: {kernel_ms:.3f} ms "
        f"per call (plain {plain_ms:.1f} ms, _int_mm+topk {library_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms by {bound_by}); {top2_scan.launches - calls} "
        "timing launches")
    out["kernel"] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import semcode_tpu_torch  # noqa: F401 - fails outside a checkout
    from semcode_tpu_torch.embeddings.native import get_native
    from semcode_tpu_torch.ops import scan_top2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kernel_lib = pool.submit(scan_top2.build_library)
        native = pool.submit(get_native)
        scan_top2._library.get(kernel_lib.result())
        if native.result() is None:
            fail("the native featurizer did not build")
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")

    worst = check_kernel()
    with tempfile.TemporaryDirectory(prefix="semcode_smoke_") as tmp:
        e2e = main_path(Path(tmp))
    scale = scale_phase()

    kern = scale["kernel"]
    record = {
        "name": "top2_scan",
        "route": "cuda",
        "source": "semcode_tpu_torch/ops/csrc/top2_scan.cu",
        "replaces": "semcode_tpu/ops/scan_kernel2.py:161",
        "launches": e2e["launches"],
        "max_abs_err": max(worst, kern["max_abs_err"]),
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "matched": True,
    }
    summary = {
        "e2e": e2e,
        "scale": {k: v for k, v in scale.items() if k != "kernel"},
    }
    log(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
