"""Drive the PyTorch engine (semcode_tpu_torch) on one CUDA card and check it.

Run from the repository root, with no arguments, on a machine with one
NVIDIA Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):

1. report the card and build the kernels from the sources in the checkout
   (the three CUDA sources with nvcc, each with ptxas's registers, shared
   memory and spills printed, the two measurement builds of top2_scan and
   the three of ivf_scan, and the native featurizer with g++, all started
   together);
2. hold the top2_scan kernel against its plain torch version on the card:
   int8 / bf16 / f32 storage, Rs in {100, 128, 1000, 70001}, d in {128,
   384, 3072}, Q in {1, 8, 512}, ip and l2, ~5% dead rows; then every
   storage at the kernel's tile edges: Q in {65, 1000}, Rs in {256k - 1,
   256k, 256k + 1}, d in {128, 384, 768, 1024, 3072} (768: the tpu-hybrid
   store's width, phase 6), corpora with more work
   items than CTAs, exact duplicates on both sides of the block boundary
   inside a tile and all-dead blocks in either half of a tile. int8:
   identical rows and bit-identical scores; bf16/f32: scores within rtol
   1e-5 (atol 1e-6), first rows identical wherever a block's top-2 gap
   exceeds 1e-4, and every picked row scoring as the plain version's pick
   (runner-ups may swap with a near-tied third: f32 sums run in another
   order);
2b. hold the ivf_scan kernels against their plain versions on the card:
   int8 / bf16 / f32 cluster blocks with ~10% empty slots and duplicated
   rows, d in {128, 384, 3072}, cmax in {128, 2176}, Q in {1, 8, 512},
   nprobe in {1, 16, 32, 128}, k in {10, 64}, with int8 at the bench's
   two probing shapes (nlist 1024, cmax 2176: d 384 at Q 512, nprobe 32;
   d 3072 at Q 8, nprobe 16; phase 11); then every storage at cmax
   2176 with clusters probed by 64, by 65 and by every query (tiles that
   end at, past and far past one 64-query int8 tile, past 20-query bf16
   and 32-query f32 tiles) and empty tails of every length, nprobe up to 128, k 10 and 64,
   d up to 3072; and the prep and merge kernels alone. int8: bit-identical scores and identical
   ids, ties included (the order (score, cluster, slot) is total);
   bf16/f32: scores within rtol 1e-5 (atol 1e-6), ids equal wherever a
   score stands apart from its neighbours by 1e-5;
2c. hold the dot_max kernel against its plain version on the card: modes
   s32 and bf16, every row tile (64, 128, 256), N in {1, 100, 128, 70001},
   d in {128, 384, 3072 (s32 only)}, Q in {1, 8, 64, 512}; rows and queries
   hold the extremes (+127 and -128 in s32, -127 in bf16) so the sign and
   the largest sums are exercised; then the tile edges: N at row-tile
   multiples +- 1, Q in {63, 64, 65, 257}, and both modes at d = 1024 with
   every operand +-127 (the largest sums bf16 mode accepts); equal bit for
   bit in every case;
3. the main path end to end: IndexerService ingests the repository's own
   ``semcode_tpu/`` (the frozen query set's corpus) into a flat int8 store
   routed through the kernel (index_scan_impl="pallas"), and the RAG
   pipeline answers the 102 frozen queries with the extractive fallback.
   Kernel launch counts are read around this run. Reports the batch's
   pipeline stages and a torch.profiler breakdown of it, MRR@10,
   recall@10 and p50 single-query latency on the kernel and full-matrix
   routes, and checks the first 8 queries' top-10 paths against the same
   engine on the CPU (plain versions);
3b. the store over IVF: the same self-ingest with index_kind="auto",
   index_ivf_min_size=128, nlist 16, nprobe 4 must promote to IVFIndex;
   the 102 queries' MRR@10 within 0.01 of the flat store's full-matrix
   route, the first 8 queries' top-10 paths equal to the same engine's on
   the CPU, and a saved and reloaded store returning identical hits;
3c. the main path over bf16 storage: the same self-ingest into a flat
   store with index_dtype="bfloat16" routed through the kernel, the 102
   queries through the pipeline; the kernel launch count is read around
   the run, MRR@10 printed, and the first 8 queries' top-10 paths must
   equal the CPU engine's wherever neighbouring scores differ by > 1e-4;
5. the API server on the card (run after phase 3c, on aiohttp over a
   localhost socket): 5a. ``create_app`` over a fresh int8 kernel-route
   workspace with an API key: a request without the key gets 401,
   ``POST /jobs/ingest`` of ``semcode_tpu/`` is polled to ``completed``,
   ``/repos`` lists it and ``/stats`` names the card; the 102 frozen
   questions go to ``POST /query`` with 32 in flight, so they ride the
   micro-batcher; every answer's paths must equal the same store's
   in-process ``query_batch``, MRR@10 must equal phase 3's kernel-route
   value, top2_scan's launches are read around the run (>= 1), and
   ``/telemetry``'s per-stage means are printed. 5b. the port's
   ``tools.bench_api`` at the reference API bench's shape (20,000 x 384
   int8, concurrency 32, 8 s after a warm-up) on the full-matrix route and
   on the kernel route: QPS, p50, p99, stage means and the device-busy share
   of a profiled window of 64 requests; top2_scan's launches are read around
   the kernel-route leg (>= 1), and an ingest job of ``semcode_tpu/index``
   runs during its timed window: no request may fail or come back without
   hits. Then top2_scan at the served shape (the SLO corpus's 20,000 rows,
   one 16-question sub-batch) against its plain version, bit for bit, with
   its time, bound and library time;
6. the transformer encoder on the card (run after phase 5a): 6a. the
   shipped encoder-mini checkpoint (``semcode_tpu/assets/encoder-mini``, read
   by path) embeds 13 queries (prose, identifiers, empty) and 3 documents
   (two of 3 or more 255-token windows) on the card and on the CPU: per-row
   cosine >= 0.999; the forward timed with CUDA events at batch 64 x 256
   tokens (ingest) and 8 x 64 (served queries): ms, tokens/s, its bound
   (2 x (4h^2 + 2h*mlp + 2Lh) x layers FLOP a token at the bf16 dense peak)
   and the peak's share, a torch.profiler breakdown by operator class
   (GEMM, softmax, layernorm, elementwise) with launches, and one layer's
   attention beside ``scaled_dot_product_attention``; 6b. IndexerService
   self-ingests ``semcode_tpu/`` with ``tpu-hybrid`` into a 768-d int8 flat
   store on the kernel route (top2_scan's launches read around it, >= 1),
   the 102 frozen questions through ``query_batch`` on both routes: MRR@10
   on the full-matrix route within 0.01 of the JAX package's 0.8013 by the
   same recipe (``JAX_HYBRID_FROZEN_MRR``), ingest seconds and the
   embedding's share; 6c. phase 5a's flow over a tpu-hybrid workspace
   (HTTP ingest, 102 questions at 32 in flight, paths equal to the
   in-process ``query_batch``, MRR@10 equal to 6b's kernel route, /telemetry's
   embed stage and QPS); 6d. ``tools.eval_heldout`` over the installed
   aiohttp package for tpu-hybrid and tpu-hash: chunks, queries, MRR@10,
   recall@10 and embed seconds (recorded, not compared: the JAX figures
   came from another aiohttp release).
7. the causal decoder on the card (run after phase 6c): 7a. the seeded
   decoder at full width, the default preset ``mini`` (hidden 384, 6 layers,
   byte vocabulary 258, max_len 1024) and GPT-2 small's shape (hidden 768,
   12 layers, vocabulary 50,257): teacher-forced logits on the card against
   the port's CPU path (float32 within atol 1e-4; bfloat16 within 10% of the
   logits' std, and no further from the float32 logits than 1.25x the CPU's
   bf16 path), the float32 KV-cached greedy tokens equal to the argmax of a
   teacher-forced rollout, the bfloat16 tokens of the CUDA-graph decode step
   equal to the eager step's bit for bit; then at batch 1: the prefill's ms
   at buckets 128, 256 and 512, and a 200-token prompt in bucket 256 with 192
   new tokens: the decode ms a token graphed and eager (CUDA events), the
   generate's tokens/s, the launches and device ms of a step (torch.profiler
   by operator class), the device's busy share of a graphed generate, and the
   bound a step (the bytes it must read over the HBM rate); 7b. tpu-lm through
   the pipeline over phase 3's store (kernel route) with the shipped fixture
   ``semcode_tpu_torch/assets/lm-tiny`` (written by the JAX package's
   trainer; the grounding guard off, the answers it would replace counted):
   8 frozen questions answered, none empty and none from the
   fallback, top2_scan's launches read around them, the float32 tokens on the
   card equal to the CPU path's for every answer's prompt, the bfloat16 graph
   equal to the eager step; then the seeded mini at full width answers two
   questions, its counters showing every token generated; 7c. phase 5a's flow
   with tpu-lm and the fixture: HTTP ingest, the startup warmup (the decode
   graphs of every prompt bucket), 16 frozen questions at 8 in flight through
   ``POST /query``: 0 failed, each answer equal to the in-process one; QPS,
   p50 and the /telemetry stage means.
8. training on the card (run after phase 7c): 8a. the contrastive trainer at
   ``train``'s defaults (the mini encoder, hashing vocabulary 32,768,
   sequence 128, batch 32, bf16 compute on float32 masters) from the port's
   seeded init on PairBatcher batches of ``semcode_tpu/``'s chunks: 3 warm-up
   steps, then 20 timed with CUDA events: ms a step, tokens/s, model FLOPs a
   step against the bf16 dense peak, the device-busy share and launches of a
   profiled step, peak memory, device time by operator class; the last 5
   steps' mean loss must lie below the first 5 steps'; then one float32 step
   on the card against the port's CPU path (same init and batch): loss
   within 1e-4, every gradient within 1e-3 of its largest entry (+ 1e-6);
   8b. the same for the next-token trainer at ``train-lm``'s defaults (the
   mini decoder, byte vocabulary, sequence 512, batch 32, QA mix 0.5);
   8c. the term reranker at the default geometry (131,072 x 32 table, batch
   256, 64 query and 96 doc terms) for 20 steps on pairs of
   ``semcode_tpu_torch/``, ``tools/`` and ``tests/`` (the serving repo held
   out): ms a step and peak memory; 8d. train -> serve: 8a's checkpoint
   (``save_params``) as ``tpu-encoder`` self-ingests ``semcode_tpu/`` into
   an int8 kernel-route store with 8c's table in the rerank; the 102 frozen
   questions through ``query_batch`` must all have hits and launch
   top2_scan (launches read around them; MRR@10 printed, not a target);
   8b's checkpoint answers one question as ``tpu-lm`` (non-empty, the
   decoder having run).
4. scale: a 1M x 384 int8 FlatIndex with its f32 rescore mirror (the JAX
   package's bench.py flagship shape, a clustered Gaussian mixture made on
   the card from a seeded torch.Generator): recall@10 against an f32
   brute-force oracle (TF32 off) on both routes (>= 0.99 required on the
   kernel route), QPS at batch 512, p50 latency at batch 8, and the
   kernel's time per call at Q=512 and Q=8 (CUDA events) beside its plain
   version, one PyTorch-library computation of the same selection, and
   its bound, with its two measurement builds (products alone, selection
   alone) at both; plus a torch.profiler breakdown of one batch-512 search;
   then a bf16 and an f32 FlatIndex of the same rows on the kernel route:
   recall@10 (>= 0.99 required), QPS at batch 512, p50 at batch 8 and the
   same kernel timings by storage;
4b. IVF at scale (bench.py's flagship IVF shape): the same mixture built
   through IVFIndex.bulk into 1M x 384 int8 + f32 mirror, nlist 1024, 10
   k-means iterations, on the card (a second k-means on the same sample
   must reproduce the centroids bit for bit). Mode "ivf" at nprobe 32 and 16:
   recall@10 against the f32 oracle (>= 0.95 required at nprobe 32), ids
   equal to the gather-scan route's on the same layout, QPS at batch 512
   and p50 at batch 8; the cost model's choice at batch 8 / nprobe 8 under
   mode "auto" (must be "ivf" and launch the kernel), and at batch 512
   (must be "exact" and select through scan_topk: its launches on the
   main path, counted from 0, are the kernels line's); at Q=512, nprobe 32,
   k 64: the whole ivf_scan call (CUDA events) and each of its kernels
   (prep, scatter, scan, merge; torch.profiler device time), the scan's two
   measurement builds (products alone, selection alone on synthetic
   scores) and its phase build (each phase's share of the consumer warps'
   cycles, and how long the TMA producer waits for a free stage), beside
   the bound, the plain version and one PyTorch-library computation of the
   same selection; the pairs, tiles, probed clusters
   and most probers of one cluster; and a torch.profiler breakdown of one
   batch-512 probe search with its kernel launches; then bf16 and f32 IVF
   indexes of the same rows: one probe search each (launches read around
   it, recall@10 >= 0.95 required) with a torch.profiler breakdown (device
   busy share), and the bf16/f32 call at the same shape, its scan kernel
   alone, the scan's three measurement builds and its registers and spills,
   beside its bound, plain version and library computation.
4c. the dot_max kernel at phase 4's shape, on phase 4's own int8 rows and
   quantized queries (the bytes top2_scan reads): ms per call in both modes
   at every row tile beside TOP/s, the bound, its plain version and one
   PyTorch-library computation (``torch._int_mm`` + ``amax``), and s32 at
   every row tile at Q=8 too; top2_scan's int8 time printed beside dot_max
   s32 (the same GEMM at the same design with no selection); and one run of
   the kernel-measurement tool ``semcode_tpu_torch.tools.dot_cuda`` at its
   default 1M x 384 x 512 shape with a short SECS (the kernel's launch
   counts, by mode, are read around this run).
4d. scan_topk, the exact route's int8 selection (run after phase 4): its
   registers and spills; against the matrix route (``index/scan._select_xla``,
   sliced to w) bit for bit, scores as bits and rows, at the cells' shapes,
   w 32: 1M x 384 at Q 512 and Q 8 and 1M x 3072 at Q 256 (ms per call
   beside its time before the new epilogue and pooled bounds, its
   bound, its plain version, the matrix route and its products build; the
   kernel's counters of one call: append rounds a warp and item, cuts a
   query and list), with a tag-filtered (1% of rows), an l2 and a
   duplicated-rows case at 1M x 384 (the tile-edge cases are
   ``tests/test_torch_cuda.py``'s); top2_scan_kernel<int8> on the same rows
   (bit for bit, ms beside its earlier time);
   and ``exact_scan``'s whole output (f32 mirror at d 384, residual rescore
   at d 3072, and the filtered case) on the kernel route against the matrix route, bit for bit, with
   ``scan.select.kernel`` counted once a call and a call's ms on each route;
   then ``ExactRoute.scan`` on the same operands at d 384 Q 8 and Q 512 and
   at d 3072 Q 256: the eager, the capturing and the graphed call's ms
   (synchronised each call), their answers bit for bit, the graph's hit
   share over 200 calls of a new key (``scan.graph.*`` counters), and the
   bytes of the route's graph pools.

9. the row-sharded engine on the one card (run after phase 4b; shards placed
   with ``make_mesh((4,), devices=[cuda:0] * 4)``): 9a. phase 3's
   self-ingest into a 4-shard int8 kernel-route store, the 102 frozen
   questions through ``query_batch`` (top2_scan launches read around the
   batch: at least one per shard; MRR@10 printed beside phase 3's one-shard
   figure), every top-10 equal to the same engine's on a 4-shard CPU mesh
   (plain versions), then 16 of them through ``create_app``'s ``POST
   /query`` with the store injected, equal to the in-process answers; 9d.
   the ``("dcn", "data")`` path across two processes (``chip_smoke.py
   --dcn-worker``, each with a timeout), each holding 2 shards over Gloo
   (NCCL on a host of two cards): both processes' answers equal 9a's store;
   9b. phase 4's 1M x 384 int8 flat index with its f32 mirror over 4 shards:
   the per-shard layout (every tensor of the index is one shard's, on
   cuda:0, of shard_rows rows, and no tensor of the global row count
   remains) and the build's ``torch.cuda.memory_allocated()`` growth, which
   may exceed the index's own tensors by no more than 64 MiB; recall@10
   (>= 0.99), one top2_scan launch per shard a search, batch-512 and
   batch-8 search times, launches and device-busy share beside phase 4's,
   and shard 1's kernel call (rows from 250,016, off the 128-row grid, in
   tensors of their own) against its plain version bit for bit; 9c. phase
   4b's IVF (nlist 1024, 256 clusters a shard, nprobe 32) over 4 shards:
   the same layout (nlist_s clusters a shard) and memory checks, recall@10
   (>= 0.95), one ivf_scan launch per shard a search, times beside phase
   4b's, every shard's kernel call on its own clusters with the probes it
   does not own set to -1 against its plain version bit for bit, and the
   kernel route against the gather-scan route; 9e. the memory split across
   processes: two processes over Gloo on the card (``chip_smoke.py
   --split-worker``, each with a timeout), 2 of the 4 shards each, build
   9b's flat index and 9c's IVF from the same seed; each holds only its own
   shards' tensors (the layout and memory checks), at most 0.55 of the
   one-process index's bytes, and answers the 512 queries with 9b's and
   9c's ids; the bytes, the builds' seconds and the phase's are printed.
10. DP x TP training on the one card (run after phase 8; a ``(2, 2)``
   ``("data", "model")`` mesh of ``[cuda:0] * 4``): 10a. 8a's contrastive
   step (mini, 32 pairs x 128, the same PairBatcher batches) on the mesh:
   20 timed bf16 steps (the loss must fall) with ms a step, launches,
   device-busy share and peak memory printed beside 8a's one-device
   figures of the same run; then one float32 step on the mesh against the
   one-device step on the card: the loss and accuracy within 1e-5, every
   gathered gradient within rtol 1e-4 / atol 1e-6; 10b. the same for 8b's
   next-token step (mini decoder, 32 x 512); 10c. the fixture LM at float32
   as the mesh trainer's sharded state: 8 QA prompts, 64 greedy tokens
   each decoded over the 2 model shards (eager) equal to the one-device
   eager path's, every token; 10d. ``entry.dryrun_multichip(8)`` on
   ``[cuda:0] * 8`` with the kernel launches of its index half (its
   indexes' default routes, as the reference's dry run) read around it.
11. the headline benchmark (run after phase 9e): 11a. ``python -m
   semcode_tpu_torch.bench`` as shipped (``BENCH_SCAN_IMPL=auto``) in a
   process of its own with a timeout, at the full 1M x 384 and 1M x 3072,
   ``BENCH_SECS=4``; 11b. the same with ``BENCH_SCAN_IMPL=pallas
   BENCH_HIGHDIM=0 BENCH_API=0``, so the flagship, chunked, serving and
   filtered exact scans go through top2_scan. Each last line must name no
   failed or skipped section, with recall@10 >= 0.99 exact, >= 0.95
   probing at nprobe 32 and 16, >= 0.99 filtered, every filtered hit
   tagged and the writer's 5120 rows written and read back; 11a's 1M x 3072
   index must take the residual rescore tier at recall@10 >= 0.99 exact
   and >= 0.95 probing at nprobe 16. The
   bench's kernel launch counts join the kernels line (``bench_launches``:
   ivf_scan's from 11a, top2_scan's from 11b, each >= 1).

Prints the ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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
NLIST = 1024  # bench.py's IVF flagship layout
KMEANS_ITERS = 10
BATCH = 512
SERVE_BATCH = 8
# published H100 SXM peaks (NVIDIA data sheet, dense): int8 and bf16
# tensor-core operations, float32 operations and HBM3 bandwidth; used for
# the kernels' bounds
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12  # float32 on the CUDA cores, outside the tensor cores
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
    the plain version's pick for that slot; a sentinel slot (a block with
    fewer than two live rows) holds the plain version's row, which the TPU
    kernel's rule fixes."""
    import torch

    from semcode_tpu_torch.ops.scan_top2 import NEG

    nb = bm.shape[1] // 2
    gap = (rm[:, :nb] - rm[:, nb:]).abs() > 1e-4
    if not torch.equal(br[:, :nb][gap], rr[:, :nb][gap]):
        fail(f"top2_scan {tag}: first rows differ")
    blk = torch.arange(nb, device=br.device).repeat(2)
    if not torch.equal(br.long() // 128, blk.expand_as(br)):
        fail(f"top2_scan {tag}: a picked row lies outside its block")
    dead = rm <= NEG
    if not torch.equal(br[dead], rr[dead]):
        fail(f"top2_scan {tag}: a sentinel slot holds another row")
    picked = torch.gather(plain_scores(*args), 1, br.long())
    if not torch.allclose(picked[~dead], rm[~dead], rtol=1e-5, atol=1e-6):
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
    n_edge = 0
    for storage, cases in (("int8", TILE_EDGE_CASES),
                           ("bfloat16", FLOAT_TILE_EDGE_CASES),
                           ("float32", FLOAT_TILE_EDGE_CASES)):
        for rs, d, nq in cases:
            for metric in ("ip", "l2"):
                args = tile_edge_inputs(storage, rs, d, nq, metric, gen)
                bm, br = top2_scan(*args)
                torch.cuda.synchronize()
                rm, rr = top2_scan_reference(*args)
                err = (bm - rm).abs().max().item()
                worst = max(worst, err)
                tag = f"{storage} tile edge Rs={rs} d={d} Q={nq} {metric}"
                if storage == "int8":
                    if not (torch.equal(bm, rm) and torch.equal(br, rr)):
                        fail(f"top2_scan {tag}: not bit-identical (max err {err})")
                else:
                    if not torch.allclose(bm, rm, rtol=1e-5, atol=1e-6):
                        fail(f"top2_scan {tag}: scores off by {err}")
                    check_float_rows(args, bm, br, rm, rr, tag)
                n += 1
                n_edge += 1
                del args, bm, br, rm, rr
    log(f"[kernel] top2_scan matches its plain version in {n} cases, "
        f"{n_edge} of them at the tile edges (max |score err| {worst:.3g})")
    return worst


# cases at the tile edges of the wgmma kernel (256-row tiles, query tiles
# of 64 in pairs): (Rs, d, Q); 70001 x 1000 and 40000 x 3072 hold more work
# items than the card has CTAs. The float cases add d = 128 and 1024: bf16
# rows take two ring chunks per 128 values of depth, f32 rows two raw
# stages per chunk. d = 768 is the tpu-hybrid store's width (384 hash + 384
# encoder; phase 6): int8 rows that deep no longer share a row chunk
# between the consumers (top2_scan.cu), each loads it for itself.
TILE_EDGE_CASES = [
    (255, 384, 65), (256, 384, 1000), (257, 3072, 65),
    (1023, 3072, 1000), (1024, 384, 65), (1025, 3072, 1000),
    (70001, 384, 1000), (40000, 3072, 512),
    (257, 768, 65), (40000, 768, 1000),
]
FLOAT_TILE_EDGE_CASES = [
    (255, 128, 65), (256, 384, 1000), (257, 1024, 65),
    (1023, 3072, 1000), (1024, 384, 65), (1025, 1024, 1000),
    (70001, 384, 1000), (40000, 3072, 512),
    (1023, 768, 65), (40000, 768, 512),
]


def tile_edge_inputs(storage, rs, d, nq, metric, gen):
    """Operands with exact duplicates on both sides of the 128-row block
    boundary inside the first tile (rows 124-131, all live: ties across
    the tile's two blocks), a tie inside block 0, and all-dead blocks
    opening the second tile and closing the third."""
    from semcode_tpu_torch.ops.scan_top2 import NEG

    vecs, mult, add, qq, qsc = kernel_inputs(storage, rs, d, nq, metric, gen)
    for dst, src in ((slice(128, 132), slice(124, 128)), (5, 77)):
        vecs[dst] = vecs[src]
        mult[dst] = mult[src]
        add[dst] = add[src]
    add[124:132] = add[124:132].clamp(min=-1e30)  # keep the duplicates live
    for lo in (256, 640):
        if rs > lo + 128:
            add[lo:lo + 128] = NEG
    return vecs, mult, add, qq, qsc


# -- phase 2b: the IVF kernel against its plain version ------------------------


def unit_blocks(nlist, cmax, d, gen):
    """(nlist, cmax, d) f32 unit rows, slots 8-15 of each cluster copying
    slots 0-7 (ties)."""
    import torch

    x = torch.randn(nlist, cmax, d, generator=gen, device="cuda")
    x = x / x.norm(dim=2, keepdim=True)
    x[:, 8:16] = x[:, 0:8]
    return x


def ivf_inputs(storage, nlist, cmax, d, nq, nprobe, gen):
    """Cluster blocks with ~10% empty slots and duplicated rows (ties).
    int8 blocks are made and quantized IVF_GEN_BYTES of f32 at a time: the
    bench's 1024 x 2176 x 3072 layout is 6.8 GB of int8, 27 GB as f32."""
    import torch

    from semcode_tpu_torch.index.flat import quantize_rows_device

    if storage == "int8":
        per = max(1, IVF_GEN_BYTES // (cmax * d * 4))
        parts = [quantize_rows_device(unit_blocks(min(per, nlist - lo), cmax, d, gen))
                 for lo in range(0, nlist, per)]
        data = torch.cat([p[0] for p in parts]) if len(parts) > 1 else parts[0][0]
        scales = torch.cat([p[1] for p in parts]) if len(parts) > 1 else parts[0][1]
        del parts
    else:
        x = unit_blocks(nlist, cmax, d, gen)
    ids = torch.arange(nlist * cmax, device="cuda", dtype=torch.int32)
    empty = torch.rand(nlist, cmax, generator=gen, device="cuda") < 0.1
    ids = torch.where(empty, -1, ids.reshape(nlist, cmax))
    q = torch.randn(nq, d, generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    probes = torch.argsort(torch.rand(nq, nlist, generator=gen, device="cuda"),
                           dim=1)[:, :nprobe]
    if storage == "int8":
        return data, ids, q, probes, scales
    dt = torch.bfloat16 if storage == "bfloat16" else torch.float32
    return x.to(dt), ids, q, probes, None


def untied_ids_equal(s_ref, i_ref, i_got, tol) -> bool:
    """Ids equal at every position whose reference score stands apart from
    both neighbours by more than ``tol``; the last column (the boundary with
    the candidates not returned) is excluded."""
    import torch

    gap = s_ref[:, :-1] - s_ref[:, 1:]
    apart = torch.ones_like(s_ref, dtype=torch.bool)
    apart[:, 1:] &= gap > tol
    apart[:, :-1] &= gap > tol
    apart[:, -1] = False
    return bool(torch.equal(i_got[apart], i_ref[apart]))


# f32 made at a time for an int8 case's blocks (ivf_inputs)
IVF_GEN_BYTES = 4 << 30

# (storage, nlist, cmax, d, Q, nprobe, k): every value of each axis appears;
# the int8 cases at cmax 2176 are the bench's shapes (phase 11): 1M x 384 at
# batch 512, nprobe 32, and 1M x 3072 at batch 8, nprobe 16
IVF_CASES = [
    ("int8", 16, 128, 128, 1, 1, 10),
    ("int8", 1024, 2176, 384, 512, 32, 64),
    ("int8", 1024, 2176, 3072, 8, 16, 64),
    ("int8", 64, 128, 3072, 8, 16, 64),
    ("int8", 256, 128, 384, 8, 128, 10),
    ("bfloat16", 64, 2176, 128, 8, 16, 64),
    ("bfloat16", 128, 128, 3072, 512, 16, 10),
    ("bfloat16", 256, 128, 384, 1, 128, 64),
    ("float32", 256, 2176, 384, 512, 32, 64),
    ("float32", 32, 2176, 3072, 8, 16, 10),
    ("float32", 16, 128, 128, 1, 1, 64),
]


# cmax 2176 with crowded clusters: (storage, nlist, d, Q, nprobe, k); int8
# tiles hold 64 queries, bf16 tiles 20, f32 tiles 32
IVF_CROWDED_CASES = [
    ("int8", 64, 384, 200, 16, 64),
    ("int8", 16, 3072, 100, 8, 64),
    ("int8", 256, 128, 100, 128, 10),
    ("int8", 16, 384, 700, 8, 64),
    ("bfloat16", 64, 384, 200, 16, 64),
    ("bfloat16", 16, 3072, 100, 8, 64),
    ("float32", 256, 128, 100, 128, 10),
    ("float32", 16, 384, 300, 8, 64),
]


def crowded_probes(nq, nlist, nprobe, gen):
    """Probes over clusters 3.. with cluster 0 probed by queries 0-63, 1 by
    queries 0-64 and 2 by every query."""
    import torch

    probes = torch.argsort(torch.rand(nq, nlist - 3, generator=gen, device="cuda"),
                           dim=1)[:, :nprobe] + 3
    probes[:64, 0] = 0
    probes[:65, 1] = 1
    probes[:, 2] = 2
    return probes


def empty_tails(ids, gen):
    """Empty tails, as a layout leaves them after each cluster's rows:
    cluster 0 keeps 129 slots, 1 keeps 128, 2 all, 3 none, 4 one, the rest
    a random count (the holes already in ids stay)."""
    import torch

    nlist, cmax = ids.shape
    keep = torch.randint(0, cmax + 1, (nlist,), generator=gen, device="cuda")
    keep[:5] = torch.tensor([129, 128, cmax, 0, 1], device="cuda")
    slot = torch.arange(cmax, device="cuda")
    return torch.where(slot[None, :] < keep[:, None], ids, -1)


def check_ivf_kernel() -> float:
    import torch

    from semcode_tpu_torch.ops.ivf_scan import ivf_scan, ivf_scan_reference

    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = 0.0
    cases = [(c, None) for c in IVF_CASES] + [
        ((storage, nlist, 2176, d, nq, nprobe, k), "crowded")
        for storage, nlist, d, nq, nprobe, k in IVF_CROWDED_CASES
    ]
    for (storage, nlist, cmax, d, nq, nprobe, k), kind in cases:
        data, ids, q, probes, scales = ivf_inputs(storage, nlist, cmax, d, nq,
                                                  nprobe, gen)
        if kind == "crowded":
            probes = crowded_probes(nq, nlist, nprobe, gen)
            ids = empty_tails(ids, gen)
        s, i = ivf_scan(data, ids, q, probes, k, scales)
        torch.cuda.synchronize()
        rs, ri = ivf_scan_reference(data, ids, q, probes, k, scales)
        err = (s - rs).abs().max().item()
        worst = max(worst, err)
        tag = (f"{storage} nlist={nlist} cmax={cmax} d={d} Q={nq} nprobe={nprobe} "
               f"k={k}{' crowded' if kind else ''}")
        if storage == "int8":
            if not torch.equal(s, rs):
                fail(f"ivf_scan {tag}: scores not bit-identical (max err {err})")
            if not torch.equal(i, ri):
                fail(f"ivf_scan {tag}: ids differ (ties included)")
        else:
            if not torch.allclose(s, rs, rtol=1e-5, atol=1e-6):
                fail(f"ivf_scan {tag}: scores off by {err}")
            if not untied_ids_equal(rs, ri, i, 1e-5):
                fail(f"ivf_scan {tag}: ids differ at untied positions")
        del data, ids, q, probes, scales, s, i, rs, ri
    n_aux = check_ivf_prep_merge(gen)
    log(f"[kernel] ivf_scan matches its plain version in {len(cases)} cases "
        f"({len(IVF_CROWDED_CASES)} with crowded clusters and empty tails, "
        f"every storage; int8 ids identical, ties included; bf16/f32 by the "
        f"float rule), prep and merge in {n_aux} more (max "
        f"|score err| {worst:.3g})")
    return worst


def check_ivf_prep_merge(gen) -> int:
    """The prep kernel (probe table, tiles, buckets: the order inside a
    bucket is free; each probed cluster's chunk count) and the merge kernel
    (tied scores across lists, empty tails, skipped probes) against their
    plain versions."""
    import torch

    from semcode_tpu_torch.ops import ivf_scan as ivf_ops

    n = 0
    for nq, nlist, nprobe, tile in ((512, 1024, 32, 64), (700, 16, 8, 64),
                                    (100, 256, 128, 32), (50, 70000, 32, 64)):
        probes = torch.randint(-2, nlist + 2, (nq, nprobe), generator=gen, device="cuda")
        cmax = 2176 if nlist <= 1024 else 128
        ids = torch.arange(nlist * cmax, device="cuda", dtype=torch.int32).view(nlist, cmax)
        ids = empty_tails(torch.where(torch.rand(nlist, cmax, generator=gen, device="cuda")
                                      < 0.1, -1, ids), gen)
        table, pair_at, tiles, nchunk = ivf_ops.ivf_prep(probes, nlist, tile, ids)
        rt, rp, rtl, rn = ivf_ops.prep_reference(probes.cpu(), nlist, tile, ids.cpu())
        if not (torch.equal(table.cpu(), rt) and torch.equal(tiles.cpu(), rtl)):
            fail(f"ivf prep Q={nq} nlist={nlist} nprobe={nprobe}: table or tiles differ")
        if not torch.equal(nchunk.cpu(), rn):
            fail(f"ivf prep Q={nq} nlist={nlist} nprobe={nprobe}: chunk counts differ")
        got = pair_at.cpu().clone()
        bounds = {}
        for c, p0, m in rtl.tolist():
            bounds[c] = (bounds.get(c, (p0, 0))[0], p0 + m)
        for lo, hi in bounds.values():
            got[lo:hi] = torch.sort(got[lo:hi]).values
        if not torch.equal(got, rp):
            fail(f"ivf prep Q={nq} nlist={nlist} nprobe={nprobe}: buckets differ")
        n += 1
    for nq, nprobe, k in ((512, 32, 64), (33, 128, 10), (9, 128, 64)):
        m = nq * nprobe
        s = torch.randint(0, 5, (m, k), generator=gen, device="cuda").float() / 4
        s = torch.sort(s, dim=1, descending=True).values
        tail = torch.randint(0, k + 1, (m, 1), generator=gen, device="cuda")
        empty = torch.arange(k, device="cuda")[None, :] >= tail
        s = torch.where(empty, ivf_ops.NEG, s)
        i = torch.randint(0, 1 << 30, (m, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        i = torch.where(empty, -1, i)
        table = torch.argsort(torch.rand(nq, 4 * nprobe, generator=gen, device="cuda"),
                              dim=1)[:, :nprobe].to(torch.int32)
        table = torch.where(torch.rand(nq, nprobe, generator=gen, device="cuda") < 0.2,
                            -1, table)
        got_s, got_i = ivf_ops.ivf_merge(s, i, table, k)
        want_s, want_i = ivf_ops.merge_reference(s, i, table, k)
        if not (torch.equal(got_s, want_s) and torch.equal(got_i, want_i)):
            fail(f"ivf merge Q={nq} nprobe={nprobe} k={k}: differs from its plain version")
        n += 1
    return n


# -- phase 2c: the dot-max kernel against its plain version --------------------


def dot_inputs(mode, n, d, nq, gen):
    """int8 rows and queries drawn over the mode's range, with the extremes
    placed: a row of +127s at n // 2, a row of the lowest value at n - 1
    (in the ragged last tile), and queries 0 and Q-1 of +127s and of the
    lowest value, whose maxima are the largest sums of either sign."""
    import torch

    low = -128 if mode == "s32" else -127
    rows = torch.randint(low, 128, (n, d), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)
    q = torch.randint(low, 128, (nq, d), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    rows[n // 2] = 127
    rows[n - 1] = low
    q[0] = 127
    q[nq - 1] = low
    return rows, q


def check_dot_max() -> int:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2024)
    t0 = time.perf_counter()
    n_cases = 0
    for mode in ("s32", "bf16"):
        for n in (1, 100, 128, 70001):
            for d in ((128, 384, 3072) if mode == "s32" else (128, 384)):
                for nq in (1, 8, 64, 512):
                    rows, q = dot_inputs(mode, n, d, nq, gen)
                    n_cases += check_dot_case(rows, q, mode, f"N={n} d={d} Q={nq}")
                    del rows, q
    n_old = n_cases
    # the tile edges: N at row-tile multiples +- 1 (ragged last tiles of
    # every rtile), Q at the 64-query tile and its neighbours
    for mode in ("s32", "bf16"):
        for n in (63, 65, 127, 129, 255, 257, 513):
            for nq in (63, 64, 65, 257):
                rows, q = dot_inputs(mode, n, 384, nq, gen)
                n_cases += check_dot_case(rows, q, mode, f"N={n} d=384 Q={nq}")
    # every operand +-127 at d = 1024: sums up to 1024 * 127**2 = 16.5M,
    # just under 2**24 where bf16 mode's f32 sums stop being exact
    for mode in ("s32", "bf16"):
        for n, nq in ((70001, 65), (300, 512)):
            sign = lambda shape: torch.where(  # noqa: E731
                torch.rand(shape, generator=gen, device="cuda") < 0.5, -127, 127
            ).to(torch.int8)
            rows, q = sign((n, 1024)), sign((nq, 1024))
            rows[n // 3] = 127
            q[0] = 127
            q[nq - 1] = -127
            n_cases += check_dot_case(rows, q, mode, f"N={n} d=1024 Q={nq} +-127")
    log(f"[kernel] dot_max equals its plain version bit for bit in {n_cases} "
        f"cases ({n_old} before the tile-edge cases; both modes, every row tile) "
        f"in {time.perf_counter() - t0:.1f} s")
    return n_cases


def check_dot_case(rows, q, mode, tag) -> int:
    """dot_max at every row tile against its plain version, bit for bit."""
    import torch

    from semcode_tpu_torch.ops.dot_max import RTILES, dot_max, dot_max_reference

    want = dot_max_reference(rows, q)
    for rtile in RTILES:
        got = dot_max(rows, q, mode=mode, rtile=rtile)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"dot_max {mode} rtile={rtile} {tag}: {bad} maxima differ")
    return len(RTILES)


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
        "stages_ms": stages, "breakdown": profile, "pipeline": pipe,
    }


# -- phase 3b: the store over IVF ----------------------------------------------


def ivf_store(workdir: Path, mrr_flat_xla: float):
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.index.store import VectorStore
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.services import IndexerService
    from semcode_tpu_torch.settings import AppSettings

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    labels = [rel for _, rel in queries]

    def config(device: str, **extra):
        return AppSettings(
            workspace_root=workdir / f"ivf-{device}",
            index_kind="auto",
            index_ivf_min_size=128,
            index_nlist=16,
            index_nprobe=4,
            rag_provider="fallback",
            rag_query_cache_size=0,
            **extra,
        )

    def ingest(device: str):
        cfg = config(device)
        svc = IndexerService(config=cfg, device=device)
        res = svc.index_repository([ROOT / "semcode_tpu"], "semcode_tpu")
        pipe = SemanticSearchPipeline(config=cfg, vector_store=svc.vector_store,
                                      embeddings=svc.embeddings, device=device)
        return res, svc, pipe

    t0 = time.perf_counter()
    res, svc, pipe = ingest("cuda")
    t_ingest = time.perf_counter() - t0
    store = svc.vector_store
    if not isinstance(store._index, IVFIndex):
        fail(f"the store did not promote to IVF at {res.chunk_count} chunks")
    t0 = time.perf_counter()
    results = pipe.query_batch(questions, top_k=10)
    t_batch = time.perf_counter() - t0
    mrr, recall = rank_metrics(results, labels)
    stats = store.stats()
    log(f"[ivf-e2e] ingested {res.chunk_count} chunks in {t_ingest:.2f} s; "
        f"promoted to IVF (nlist {stats['nlist']}, cmax {stats['cmax']}); "
        f"102 queries in {t_batch * 1e3:.1f} ms: MRR@10 {mrr:.4f} "
        f"recall@10 {recall:.4f} (flat full-matrix {mrr_flat_xla:.4f})")
    if abs(mrr - mrr_flat_xla) > 0.01:
        fail(f"IVF store MRR@10 {mrr:.4f} is not within 0.01 of the flat "
             f"store's {mrr_flat_xla:.4f}")

    _, svc_cpu, pipe_cpu = ingest("cpu")
    if not isinstance(svc_cpu.vector_store._index, IVFIndex):
        fail("the CPU store did not promote to IVF")
    for qtext, a, b in zip(questions, results,
                           pipe_cpu.query_batch(questions[:8], top_k=10)):
        pa = [s["path"] for s in a["sources"]]
        pb = [s["path"] for s in b["sources"]]
        if pa != pb:
            fail(f"IVF store: card and CPU disagree on {qtext!r}:\n{pa}\n{pb}")

    # save, reload into a fresh store, query again: identical hits
    import numpy as np

    qvecs = np.asarray(pipe.embeddings.embed_queries(questions), dtype=np.float32)
    before = store.search_batch(qvecs, top_k=10)
    snap = store.save(workdir / "ivf-snapshot")
    again = VectorStore(config("cuda", index_snapshot_dir=snap), device="cuda")
    again.connect()
    if not isinstance(again._index, IVFIndex) or again.count() != store.count():
        fail("the reloaded store is not the saved IVF store")
    after = again.search_batch(qvecs, top_k=10)
    for hb, ha in zip(before, after):
        if [h.id for h in hb] != [h.id for h in ha] or any(
            abs(x.score - y.score) > 1e-5 for x, y in zip(hb, ha)
        ):
            fail("the reloaded IVF store returns other hits")
    log("[ivf-e2e] first 8 queries: card top-10 paths equal the CPU engine's; "
        "saved + reloaded store returns identical hits for all 102 queries")
    return {"mrr": mrr, "recall": recall, "chunks": res.chunk_count,
            "cmax": stats["cmax"], "ingest_s": t_ingest,
            "batch_ms": t_batch * 1e3}


# -- phase 3c: the main path over bf16 storage ----------------------------------


def apart_paths_equal(got, want, tol: float) -> bool:
    """Hit paths equal at every position whose score (``want``'s) differs
    from both neighbours' by more than ``tol``."""
    pa = [s["path"] for s in got["sources"]]
    pb = [s["path"] for s in want["sources"]]
    sb = [s["score"] for s in want["sources"]]
    if len(pa) != len(pb):
        return False
    for i, path in enumerate(pb):
        near = any(abs(sb[i] - sb[j]) <= tol for j in (i - 1, i + 1)
                   if 0 <= j < len(sb))
        if not near and pa[i] != path:
            return False
    return True


def bf16_store(workdir: Path):
    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.services import IndexerService
    from semcode_tpu_torch.settings import AppSettings

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    labels = [rel for _, rel in queries]

    def ingest(device: str):
        cfg = AppSettings(
            workspace_root=workdir / f"bf16-{device}",
            index_kind="flat",
            index_dtype="bfloat16",
            index_scan_impl="pallas",
            rag_provider="fallback",
            rag_query_cache_size=0,
        )
        svc = IndexerService(config=cfg, device=device)
        res = svc.index_repository([ROOT / "semcode_tpu"], "semcode_tpu")
        pipe = SemanticSearchPipeline(config=cfg, vector_store=svc.vector_store,
                                      embeddings=svc.embeddings, device=device)
        return res, svc, pipe

    top2_scan.launches = 0
    t0 = time.perf_counter()
    res, svc, pipe = ingest("cuda")
    results = pipe.query_batch(questions, top_k=10)
    t_run = time.perf_counter() - t0
    launches = top2_scan.launches
    if launches < 1:
        fail("the bf16 store never launched the top2_scan kernel")
    if svc.vector_store._index._storage_name() != "bfloat16":
        fail("the phase 3c store does not hold bf16 rows")
    if any(not r["sources"] for r in results):
        fail("a frozen query got no hits from the bf16 store")
    mrr, recall = rank_metrics(results, labels)
    _, _, pipe_cpu = ingest("cpu")
    for qtext, a, b in zip(questions, results,
                           pipe_cpu.query_batch(questions[:8], top_k=10)):
        if not apart_paths_equal(a, b, 1e-4):
            fail(f"bf16 store: card and CPU disagree on {qtext!r}:\n"
                 f"{[s['path'] for s in a['sources']]}\n"
                 f"{[s['path'] for s in b['sources']]}")
    log(f"[bf16-e2e] ingested {res.chunk_count} chunks into a bf16 flat store "
        f"and answered 102 queries in {t_run:.2f} s: top2_scan launches "
        f"{launches}, MRR@10 {mrr:.4f} recall@10 {recall:.4f}; first 8 queries: "
        "card top-10 paths equal the CPU engine's (positions apart by 1e-4)")
    return {"launches": launches, "mrr": mrr, "recall": recall}


# -- phase 5: the API server on the card ------------------------------------------

API_KEY = "smoke"
API_ROWS = 20_000  # the reference API bench's corpus (tools/bench_api.py)
API_CONCURRENCY = 32
API_SECS = 8.0


async def wait_job(client, job_id: str, headers, timeout_s: float = 300.0):
    import asyncio

    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        r = await client.get(f"/jobs/{job_id}", headers=headers)
        if r.status != 200:
            fail(f"GET /jobs/{job_id} answered {r.status}")
        job = await r.json()
        if job["status"] in ("completed", "failed", "interrupted"):
            return job
        await asyncio.sleep(0.1)
    fail(f"ingest job {job_id} did not finish in {timeout_s} s")


def api_ingest_and_query(workdir: Path, mrr_pallas: float, device: str = "cuda",
                         provider: str = "tpu-hash"):
    """5a: the self-ingest through HTTP on a fresh workspace, then the 102
    frozen questions with 32 in flight: answers equal to the same store's
    in-process query_batch, MRR@10 equal to phase 3's kernel route (6c: the
    same with ``provider`` tpu-hybrid, MRR@10 equal to phase 6b's kernel
    route)."""
    import asyncio

    import aiohttp
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.settings import AppSettings

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    labels = [rel for _, rel in queries]
    cfg = AppSettings(
        workspace_root=workdir / f"api-{provider}-{device}",
        embedding_provider=provider,
        index_kind="flat",
        index_scan_impl="pallas",
        rag_provider="fallback",
        rag_query_cache_size=0,
        api_key=API_KEY,
    )
    tag = "[api]" if provider == "tpu-hash" else f"[api {provider}]"
    app = create_app(config=cfg, device=device)
    auth = {"X-API-Key": API_KEY}
    out = {}

    async def serve():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get("/repos")
            if r.status != 401:
                fail(f"/repos without the API key answered {r.status}, not 401")
            t0 = time.perf_counter()
            r = await client.post("/jobs/ingest", headers=auth, json={
                "name": "semcode_tpu", "root": str(ROOT), "include": ["semcode_tpu"]})
            if r.status != 200:
                fail(f"POST /jobs/ingest answered {r.status}: {await r.text()}")
            job = await wait_job(client, (await r.json())["id"], auth)
            out["ingest_s"] = time.perf_counter() - t0
            if job["status"] != "completed":
                fail(f"the ingest job ended {job['status']}: {job['error']}")
            out["chunks"] = job["result"]["chunk_count"]
            repos = await (await client.get("/repos", headers=auth)).json()
            if [(x["name"], x["chunk_count"]) for x in repos] != [
                    ("semcode_tpu", out["chunks"])]:
                fail(f"/repos does not list the ingested repo: {repos}")
            stats = await (await client.get("/stats", headers=auth)).json()
            out["stats_devices"], out["stats_backend"] = stats["devices"], stats["backend"]
            if device == "cuda" and (stats["backend"] != "cuda" or stats["devices"][0]
                                     != torch.cuda.get_device_name(0)):
                fail(f"/stats does not name the card: {stats}")
            if stats["index"]["rows"] != out["chunks"]:
                fail(f"/stats counts {stats['index']['rows']} rows")

            in_flight = asyncio.Semaphore(API_CONCURRENCY)

            async def ask(question):
                async with in_flight:
                    r = await client.post("/query", headers=auth,
                                          json={"question": question, "top_k": 10})
                    if r.status != 200:
                        fail(f"/query answered {r.status}: {await r.text()}")
                    return await r.json()

            top2_scan.launches = 0
            t0 = time.perf_counter()
            answers = await asyncio.gather(*(ask(q) for q in questions))
            out["served_s"] = time.perf_counter() - t0
            out["launches"] = top2_scan.launches
            tele = await (await client.get("/telemetry", headers=auth)).json()
            out["stages"] = tele["query_stages"]
            return answers
        finally:
            await client.close()

    answers = asyncio.run(serve())
    direct = app["pipeline"].query_batch(questions, top_k=10)
    for qtext, got, want in zip(questions, answers, direct):
        pa = [s["path"] for s in got["sources"]]
        if not pa or pa != [s["path"] for s in want["sources"]]:
            fail(f"/query and query_batch disagree on {qtext!r}:\n{pa}\n"
                 f"{[s['path'] for s in want['sources']]}")
    mrr, recall = rank_metrics(answers, labels)
    # each answer of a batch of n carries n in its meta
    batches = sum(1 / max(int(a["meta"].get("batch_size") or 1), 1) for a in answers)
    out.update(mrr=mrr, recall=recall, batches=round(batches))
    stages = out["stages"]
    log(f"{tag} transport: aiohttp {aiohttp.__version__} on a localhost socket; "
        "HTTP self-ingest of semcode_tpu/: "
        f"{out['chunks']} chunks in {out['ingest_s']:.2f} s; /stats names "
        f"{out['stats_devices']} ({out['stats_backend']})")
    out["qps"] = len(questions) / out["served_s"]
    log(f"{tag} 102 frozen questions, {API_CONCURRENCY} in flight: "
        f"{out['served_s'] * 1e3:.1f} ms ({out['qps']:.1f} QPS) in "
        f"{out['batches']} pipeline calls; "
        f"top2_scan launches {out['launches']}; MRR@10 {mrr:.4f} recall@10 "
        f"{recall:.4f} (in-process kernel route {mrr_pallas:.4f}); every answer's "
        "paths equal the in-process query_batch's")
    log(f"{tag} /telemetry stage means per query (ms): " + ", ".join(
        f"{k} {v}" for k, v in stages["avg_ms_per_query"].items()))
    if device == "cuda" and out["launches"] < 1:
        fail("/query never launched the top2_scan kernel")
    if abs(mrr - mrr_pallas) > 1e-9:
        fail(f"served MRR@10 {mrr:.4f} differs from the in-process kernel "
             f"route's {mrr_pallas:.4f}")
    return out


def api_slo(device: str = "cuda", rows: int = API_ROWS, secs: float = API_SECS):
    """5b: the port's /query SLO harness at the reference API bench's shape,
    on the full-matrix route and on the kernel route; during the kernel
    route's timed window an ingest job of semcode_tpu/index runs behind the
    same server and no query may fail."""
    import asyncio

    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.tools import bench_api

    auth = {"X-API-Key": bench_api.API_KEY}

    async def ingest_job(client):
        r = await client.post("/jobs/ingest", headers=auth, json={
            "name": "index", "root": str(ROOT), "include": ["semcode_tpu/index"]})
        if r.status != 200:
            fail(f"POST /jobs/ingest answered {r.status}")
        t0 = time.perf_counter()
        job = await wait_job(client, (await r.json())["id"], auth)
        job["wall_s"] = time.perf_counter() - t0
        return job

    legs = {}
    for impl in ("auto", "pallas"):
        top2_scan.launches = 0
        leg = bench_api.run_api_bench(
            rows, 384, API_CONCURRENCY, secs, impl=impl, device=device,
            profile_requests=64, during=ingest_job if impl == "pallas" else None)
        leg["launches"] = top2_scan.launches
        legs[impl] = leg
        if leg["failed"] or leg["empty"]:
            fail(f"{impl} route: {leg['failed']} failed and {leg['empty']} empty "
                 f"answers: {leg['errors']}")
        prof = leg.get("profile") or {}
        log(f"[api-slo] {impl}: {rows} x 384 int8, c={API_CONCURRENCY}, "
            f"{secs:.0f} s: QPS {leg['qps']}, p50 {leg['p50_ms']} ms, p99 "
            f"{leg['p99_ms']} ms, {leg['requests']} requests, 0 failed, in "
            f"{leg['pipeline_calls']:.0f} pipeline calls (an answer rode a call of "
            f"{leg['batch_mean']:.2f} on average); store built in "
            f"{leg['build_s']:.2f} s; top2_scan launches {leg['launches']}")
        log(f"[api-slo] {impl} stage means per query (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in leg["stage_ms"].items()))
        if prof:
            log(f"[api-slo] {impl} profiled window of {prof['requests']} requests: "
                f"wall {prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.3f}"
                f" ms ({100 * prof['busy_share']:.2f}%), {prof['launches']} kernel "
                f"launches; most launched {prof['top_launches'][:4]}")
    job = legs["pallas"]["during"]
    if job["status"] != "completed":
        fail(f"the ingest job under query load ended {job['status']}: {job['error']}")
    log(f"[api-slo] ingest of semcode_tpu/index under the pallas leg's load: "
        f"{job['result']['chunk_count']} chunks in {job['wall_s']:.2f} s, no "
        "query failed")
    if device == "cuda" and legs["pallas"]["launches"] < 1:
        fail("the kernel-route SLO leg never launched top2_scan")
    return legs


def api_kernel_shape(rows: int = API_ROWS, nq: int = API_CONCURRENCY // 2):
    """top2_scan at the served path's shape: the SLO store's rows (the same
    seeded vectors as int8) and one sub-batch of hash-embedded questions
    (c = 32 with the batcher's split of 2 runs groups of 16)."""
    import torch

    from semcode_tpu_torch.embeddings.hash_embedder import HashEmbeddings
    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.scan import quantize_queries_device
    from semcode_tpu_torch.ops.scan_top2 import NEG

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(rows, DIM, generator=gen, device="cuda")
    x /= torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9)
    index = FlatIndex(DIM, metric="ip", dtype="int8", scan_impl="pallas",
                      device="cuda")
    index.add(x.cpu().numpy())
    vecs, _, valid, scales, _, _ = shard0(index._ensure_device())
    add = torch.where(valid, 0.0, NEG).float()
    emb = HashEmbeddings(DIM, device="cuda")
    q = emb.embed_queries_device([f"{q} served {i}" for i, (q, _) in
                                  enumerate(frozen_queries()[:nq])])
    qq, qsc = quantize_queries_device(q)
    return time_top2(vecs, scales, add, qq, qsc)


# -- phase 6: the transformer encoder on the card ---------------------------------

# The JAX package's frozen-set MRR@10 with tpu-hybrid by phase 6b's recipe
# (IndexerService self-ingest of semcode_tpu/ into an int8 flat store, the
# full-matrix route, 102 questions through query_batch, ranked by path):
# 0.8013, recall@10 1.0, 181 chunks, from `JAX_PLATFORMS=cpu python
# tests/test_torch_hybrid.py` (JAX 0.9.0, flax 0.12.3, on the CPU); the
# port gives the same 0.8013 on the CPU in that run.
JAX_HYBRID_FROZEN_MRR = 0.8013
ENCODER_SHAPES = (("ingest", 64, 256), ("query", 8, 64))


def encoder_texts():
    """~16 texts: short prose queries, identifier queries, and two chunks
    long enough to take 3 or more 255-token windows."""
    queries = [
        "where is the flat index defined",
        "how are int8 rows quantized before the scan",
        "what happens when the store promotes to IVF",
        "how does the micro-batcher group concurrent queries",
        "load a saved snapshot of the vector store",
        "which module splits source files into chunks",
        "quantize_rows_device",
        "VectorStore.search_batch(",
        "IVFIndex nprobe",
        "top2_scan_reference",
        "embeddingProviderFactory",
        "x",
        "",
    ]
    root = ROOT / "semcode_tpu" / "index"
    docs = [(root / "store.py").read_text()[:12000],
            (root / "flat.py").read_text()[:9000],
            "def parse_config(path):\n    return toml.load(path)\n"]
    return queries, docs


def op_class(name: str) -> str:
    low = name.lower()
    if any(key in low for key in ("gemm", "nvjet", "xmma", "cutlass", "matmul")):
        return "gemm"
    if "softmax" in low:
        return "softmax"
    if "layer_norm" in low or "layernorm" in low:
        return "layernorm"
    return "elementwise"


def op_class_breakdown(fn, iters: int = 5):
    """Device ms per call of ``fn`` by operator class (GEMM, softmax,
    layernorm, elementwise: every other kernel), with the launches per call
    and the largest kernels (torch.profiler, CUDA activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semcode_tpu_torch.utils.tracing import is_span_event

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    classes = dict.fromkeys(("gemm", "softmax", "layernorm", "elementwise"), 0.0)
    counts = dict.fromkeys(classes, 0)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if ev.device_type != DeviceType.CUDA or dev_us <= 0 or is_span_event(ev):
            continue
        cls = op_class(ev.key)
        classes[cls] += dev_us / 1e3 / iters
        counts[cls] += ev.count / iters
        rows.append((ev.key, dev_us / 1e3 / iters))
    rows.sort(key=lambda r: -r[1])
    if not rows:
        fail("the profiler recorded no device time for the encoder")
    return {"ms": classes, "launches": counts,
            "device_ms": sum(classes.values()),
            "top": [[name[:120], ms] for name, ms in rows[:6]]}


def attention_times(model, batch: int, length: int):
    """One layer's attention at this shape: the port's plain products,
    mask and softmax beside ``scaled_dot_product_attention`` on the same
    q, k, v (what a fused kernel could save; not used by the port)."""
    import torch
    import torch.nn.functional as F

    from semcode_tpu_torch.tools._timing import cuda_ms

    attn = model.blocks[0].attn
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(batch, length, model.cfg.hidden, generator=gen,
                    device="cuda").to(model.cfg.dtype)
    mask = torch.ones(batch, 1, length, length, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        q, k, v = (attn.qkv(x).view(batch, length, 3, attn.heads, attn.head_dim)
                   .permute(2, 0, 3, 1, 4).unbind(0))

    def plain():
        with torch.inference_mode():
            logits = (q / attn.scale) @ k.transpose(-1, -2)
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
            return torch.softmax(logits, dim=-1) @ v

    def library():
        with torch.inference_mode():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=1.0 / attn.scale)

    err = (plain().float() - library().float()).abs().max().item()
    return {"plain_ms": cuda_ms(plain, 20), "sdpa_ms": cuda_ms(library, 20),
            "max_abs_diff": err}


def encoder_model_phase():
    """6a: the shipped checkpoint on the card against the port's CPU path,
    then the forward timed at the ingest and the served-query shapes."""
    import numpy as np
    import torch

    from semcode_tpu_torch.models.encoder import EncoderEmbeddings
    from semcode_tpu_torch.tools._timing import cuda_ms

    t0 = time.perf_counter()
    card = EncoderEmbeddings(device="cuda")
    load_s = time.perf_counter() - t0
    cpu = EncoderEmbeddings(device="cpu")
    if card.random_init or card.signature != cpu.signature:
        fail("the card did not load the shipped encoder checkpoint")
    cfg = card.cfg
    queries, docs = encoder_texts()
    window = cfg.max_len - 1
    wins = [max(1, -(-len(card.tokenizer.encode_ids(d, cap=window * card.MAX_DOC_WINDOWS))
                   // window)) for d in docs]
    if sum(w >= 3 for w in wins) < 2:
        fail(f"the long chunks take {wins} windows, not 3 or more")

    def cosines(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        return (a * b).sum(1) / np.maximum(den, 1e-30)

    cos_q = cosines(card.embed_queries(queries), cpu.embed_queries(queries))
    cos_d = cosines(card.embed_documents(docs), cpu.embed_documents(docs))
    cos_1 = cosines([card.embed_query(queries[0])], [cpu.embed_query(queries[0])])
    worst = float(min(cos_q.min(), cos_d.min(), cos_1.min()))
    log(f"[encoder] shipped checkpoint {card.signature} loaded on the card in "
        f"{load_s:.2f} s ({cfg.layers} layers, hidden {cfg.hidden}, {cfg.heads} heads, "
        f"MLP {cfg.mlp_dim}, max_len {cfg.max_len}, {str(cfg.dtype)[6:]}); "
        f"{len(queries)} queries + {len(docs)} documents ({wins} windows): card vs "
        f"CPU per-row cosine min {worst:.6f}")
    if not worst >= 0.999:
        fail(f"the card's encoder vectors differ from the CPU's: cosine {worst}")

    out = {"load_s": load_s, "cos_min": worst, "windows": wins}
    h, mlp, layers = cfg.hidden, cfg.mlp_dim, cfg.layers
    for label, batch, length in ENCODER_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(6)
        ids = torch.randint(2, cfg.vocab_size, (batch, length), generator=gen,
                            device="cuda")
        mask = torch.ones_like(ids)

        def forward():
            with torch.inference_mode():
                return card.model(ids, mask)

        ms = cuda_ms(forward, 30, warmup=3)
        tokens = batch * length
        flops = 2 * (4 * h * h + 2 * h * mlp + 2 * length * h) * layers * tokens
        bound_ms = flops / PEAK_BF16_OPS * 1e3
        prof = op_class_breakdown(forward)
        attn = attention_times(card.model, batch, length)
        rec = {"batch": batch, "length": length, "ms": ms,
               "tokens_per_s": tokens / (ms / 1e3), "flops": flops,
               "bound_ms": bound_ms, "bound_by": "operations",
               "peak_share": bound_ms / ms, "profile": prof, "attention": attn}
        out[label] = rec
        log(f"[encoder] {label} forward {batch} x {length}: {ms:.4f} ms "
            f"(CUDA events, 30 calls), {rec['tokens_per_s']:.4g} tokens/s, "
            f"{flops / 1e9:.2f} GFLOP, bound {bound_ms:.4f} ms (operations, bf16 "
            f"dense peak {PEAK_BF16_OPS / 1e12:.0f} TFLOP/s): "
            f"{100 * rec['peak_share']:.2f}% of peak")
        log(f"[encoder]   device {prof['device_ms']:.4f} ms a forward by class: "
            + ", ".join(f"{k} {v:.4f} ms ({prof['launches'][k]:.0f} launches)"
                        for k, v in prof["ms"].items()))
        log(f"[encoder]   largest kernels: {prof['top'][:4]}")
        log(f"[encoder]   one layer's attention: plain {attn['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {attn['sdpa_ms']:.4f} ms "
            f"(max |diff| {attn['max_abs_diff']:.3g})")
    return out


def hybrid_main_path(workdir: Path, device: str = "cuda"):
    """6b: IndexerService self-ingests semcode_tpu/ with tpu-hybrid into an
    int8 flat store on the kernel route (768-d rows); the 102 frozen
    questions through query_batch on both routes."""
    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.services import IndexerService
    from semcode_tpu_torch.services.indexer import IndexingCallbacks
    from semcode_tpu_torch.settings import AppSettings

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    labels = [rel for _, rel in queries]
    cfg = AppSettings(
        workspace_root=workdir / f"hybrid-{device}",
        embedding_provider="tpu-hybrid",
        index_kind="flat",
        index_scan_impl="pallas",
        rag_provider="fallback",
        rag_query_cache_size=0,
    )
    stamps = {}
    callbacks = IndexingCallbacks(
        stage=lambda s: stamps.setdefault(s, time.perf_counter()))
    top2_scan.launches = 0
    t0 = time.perf_counter()
    svc = IndexerService(config=cfg, device=device)
    res = svc.index_repository([ROOT / "semcode_tpu"], "semcode_tpu",
                               callbacks=callbacks)
    t_ingest = time.perf_counter() - t0
    t_embed = stamps["upserting"] - stamps["embedding"]
    pipe = SemanticSearchPipeline(config=cfg, vector_store=svc.vector_store,
                                  embeddings=svc.embeddings, device=device)
    t0 = time.perf_counter()
    results = pipe.query_batch(questions, top_k=10)
    t_batch = time.perf_counter() - t0
    launches = top2_scan.launches
    store = svc.vector_store
    if store.dim != 768 or store._index._storage_name() != "int8":
        fail(f"the hybrid store holds {store.dim}-d "
             f"{store._index._storage_name()} rows, not 768-d int8")
    if device == "cuda" and launches < 1:
        fail("the tpu-hybrid path never launched top2_scan")
    if any(not r["sources"] for r in results):
        fail("a frozen question got no hits from the hybrid store")
    mrr, recall = rank_metrics(results, labels)
    index = store._index
    index.scan_impl = "xla"
    mrr_x, recall_x = rank_metrics(pipe.query_batch(questions, top_k=10), labels)
    index.scan_impl = "pallas"
    log(f"[hybrid-e2e] tpu-hybrid self-ingest of semcode_tpu/: {res.chunk_count} "
        f"chunks into 768-d int8 rows in {t_ingest:.2f} s, embedding {t_embed:.2f} s "
        f"of it ({100 * t_embed / t_ingest:.1f}%); 102 questions in one batch "
        f"{t_batch * 1e3:.1f} ms; top2_scan launches {launches}")
    log(f"[hybrid-e2e] pallas route: MRR@10 {mrr:.4f} recall@10 {recall:.4f}; "
        f"xla route: MRR@10 {mrr_x:.4f} recall@10 {recall_x:.4f} (the JAX "
        f"package's tpu-hybrid figure by this recipe on the CPU: "
        f"{JAX_HYBRID_FROZEN_MRR:.4f})")
    if abs(mrr_x - JAX_HYBRID_FROZEN_MRR) > 0.01:
        fail(f"tpu-hybrid MRR@10 {mrr_x:.4f} is not within 0.01 of the JAX "
             f"package's {JAX_HYBRID_FROZEN_MRR:.4f}")
    return {"chunks": res.chunk_count, "ingest_s": t_ingest, "embed_s": t_embed,
            "batch_ms": t_batch * 1e3, "launches": launches, "mrr": mrr,
            "recall": recall, "mrr_xla": mrr_x, "recall_xla": recall_x}


def heldout_phase():
    """6d: the held-out harness over the installed aiohttp package, for
    tpu-hybrid and tpu-hash, on the card."""
    from semcode_tpu_torch.tools import eval_heldout

    results = eval_heldout.run(["aiohttp"], ["tpu-hybrid", "tpu-hash"])
    import aiohttp

    out = {}
    for key, r in results.items():
        if not r["device"].startswith("cuda"):
            fail(f"{key} ran on {r['device']}, not the card")
        if not (r["n_queries"] > 0 and 0.0 <= r["mrr@10"] <= 1.0):
            fail(f"{key}: no queries or an impossible MRR@10: {r}")
        out[key] = {k: r[k] for k in ("n_chunks", "n_queries", "mrr@10",
                                      "recall@10", "embed_s", "eval_s")}
        log(f"[heldout] {key} (aiohttp {aiohttp.__version__}): {r['n_chunks']} chunks, "
            f"{r['n_queries']} queries, MRR@10 {r['mrr@10']:.4f} recall@10 "
            f"{r['recall@10']:.4f}, embed {r['embed_s']:.2f} s, eval {r['eval_s']:.2f} s")
    return out


# -- phase 7: the causal decoder on the card ------------------------------------

# a byte-level decoder written by the JAX package's LMTrainer and
# save_lm_params on the CPU (tests/test_torch_decoder.py --write-fixture)
LM_FIXTURE = ROOT / "semcode_tpu_torch" / "assets" / "lm-tiny"
# the decoder at full width, seeded: the default preset (rag_preset "mini",
# the byte vocabulary) and GPT-2 small's shape (the HF checkpoints
# load_hf_decoder_params reads)
DECODER_SHAPES = (("mini", 258), ("base", 50257))
DECODE_BUCKET = 256  # the timed generation: batch 1, this bucket,
DECODE_PROMPT = 200  # a prompt of this many tokens,
DECODE_NEW = 192  # rag_max_new_tokens' default
PREFILL_BUCKETS = (128, 256, 512)
LOGITS_ATOL_F32 = 1e-4  # card vs CPU, float32 logits
# card vs CPU, bfloat16: within this share of the logits' std, and the card
# no further from the float32 logits than BF16_VS_CPU times the CPU's own
# bf16 distance (two bf16 computations round apart: at GPT-2 small's depth
# each lies ~6% of the std from the float32 logits)
LOGITS_REL_BF16 = 0.10
BF16_VS_CPU = 1.25


def decode_step_bytes(model, live_slots: float) -> float:
    """The bytes one greedy decode step must read: every block's kernels,
    biases and layernorms as held, the final layernorm, the float32 head
    (``wte``), one row of each embedding, and the K and V of the live cache
    slots."""
    cfg = model.cfg
    params = sum(p.numel() * p.element_size() for name, p in model.named_parameters()
                 if name not in ("wte", "wpe"))
    head = model.wte.numel() * model.wte.element_size()
    rows = 2 * cfg.hidden * model.wte_c.element_size()
    cache = 2 * cfg.layers * cfg.hidden * live_slots * model.wte_c.element_size()
    return params + head + rows + cache


def decoder_model_phase():
    """7a: the seeded decoder at full width (mini, GPT-2 small's shape) on
    the card against the port's CPU path, then prefill and decode timed."""
    import dataclasses

    import numpy as np
    import torch

    from semcode_tpu_torch.models import decoder as dec
    from semcode_tpu_torch.tools._timing import cuda_ms

    rng = np.random.default_rng(10)
    out = {}
    for preset, vocab in DECODER_SHAPES:
        tag = f"[decoder {preset} v{vocab}]"
        t0 = time.perf_counter()
        cfg = dec.DecoderConfig.preset(preset, vocab_size=vocab)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = dec.init_params(cfg, seed=0)
        card, card32 = dec.build_decoder(params, cfg, "cuda"), dec.build_decoder(params, cfg32, "cuda")
        cpu, cpu32 = dec.build_decoder(params, cfg, "cpu"), dec.build_decoder(params, cfg32, "cpu")
        load_s = time.perf_counter() - t0

        # teacher-forced logits, card vs CPU, a padded row among them
        ids = rng.integers(2, vocab, (2, 64))
        mask = np.ones_like(ids)
        mask[1, 40:] = 0
        live = mask.astype(bool)
        got32 = dec.forward_logits(card32, ids, mask).cpu().numpy()[live]
        want32 = dec.forward_logits(cpu32, ids, mask).numpy()[live]
        err32 = float(np.abs(got32 - want32).max())
        got16 = dec.forward_logits(card, ids, mask).cpu().numpy()[live]
        want16 = dec.forward_logits(cpu, ids, mask).numpy()[live]
        err16, spread = float(np.abs(got16 - want16).max()), float(want16.std())
        card_off = float(np.abs(got16 - want32).max())  # each bf16 path's distance
        cpu_off = float(np.abs(want16 - want32).max())  # to the float32 logits
        log(f"{tag} seeded init ({cfg.layers} layers, hidden {cfg.hidden}, {cfg.heads} "
            f"heads, MLP {cfg.mlp_dim}, max_len {cfg.max_len}) built on the card and "
            f"the CPU in {load_s:.2f} s; teacher-forced logits card vs CPU: float32 "
            f"max |diff| {err32:.3g} (atol {LOGITS_ATOL_F32}), bfloat16 {err16:.3g} = "
            f"{err16 / spread:.4f} of the logits' std {spread:.4g} "
            f"(limit {LOGITS_REL_BF16}); bfloat16 from the float32 logits: card "
            f"{card_off:.3g}, CPU {cpu_off:.3g} (limit {BF16_VS_CPU}x the CPU's)")
        if not err32 <= LOGITS_ATOL_F32:
            fail(f"{tag} float32 logits differ from the CPU's by {err32}")
        if not (err16 <= LOGITS_REL_BF16 * spread and card_off <= BF16_VS_CPU * cpu_off):
            fail(f"{tag} bfloat16 logits differ from the CPU's by {err16} "
                 f"(card {card_off} from float32, CPU {cpu_off})")

        # float32: the KV-cached greedy tokens (graphed) are the argmax of a
        # teacher-forced rollout
        prompt = rng.integers(2, vocab, 40).tolist()
        pids = np.zeros((1, 64), np.int64)
        pmask = np.zeros_like(pids)
        pids[0, :40], pmask[0, :40] = prompt, 1
        cached = dec.generate_tokens(card32, pids, pmask, max_new=16)[0].tolist()
        seq, rollout = list(prompt), []
        for _ in range(16):
            logits = dec.forward_logits(card32, np.asarray([seq]), np.ones((1, len(seq))))
            rollout.append(int(logits[0, -1].argmax()))
            seq.append(rollout[-1])
        if cached != rollout:
            fail(f"{tag} KV-cached tokens {cached} differ from the rollout {rollout}")

        # bfloat16: the graph replays the eager step bit for bit
        ids = np.zeros((1, DECODE_BUCKET), np.int64)
        mask = np.zeros_like(ids)
        ids[0, :DECODE_PROMPT] = rng.integers(2, vocab, DECODE_PROMPT)
        mask[0, :DECODE_PROMPT] = 1
        card.counts.update(dict.fromkeys(card.counts, 0))
        graphed = dec.generate_tokens(card, ids, mask, max_new=DECODE_NEW)
        eager = dec.generate_tokens(card, ids, mask, max_new=DECODE_NEW, graph=False)
        if not torch.equal(graphed, eager):
            fail(f"{tag} graph-replayed tokens differ from the eager step's")
        counts = dict(card.counts)
        if counts["graph_replays"] != DECODE_NEW - 1 or counts["graph_captures"] != 1:
            fail(f"{tag} the graphed generation did not replay its graph: {counts}")
        log(f"{tag} float32 KV-cached greedy = teacher-forced rollout (16 tokens); "
            f"bfloat16 graph = eager step bit for bit ({DECODE_NEW} tokens, "
            f"{len(set(graphed[0].tolist()))} distinct); counts {counts}")
        del card32, cpu32, cpu

        # timings at batch 1: prefill by bucket, then the decode step
        dev_mask = torch.as_tensor(mask, device="cuda")
        rec = {"load_s": load_s, "logits_err_f32": err32, "logits_err_bf16": err16,
               "logits_std": spread, "bf16_from_f32": {"card": card_off, "cpu": cpu_off},
               "prefill_ms": {}}
        with torch.inference_mode():
            for bucket in PREFILL_BUCKETS:
                st = dec._DecodeState(cfg, 1, bucket, DECODE_NEW, "cuda")
                b_ids = torch.randint(2, vocab, (1, bucket), device="cuda")
                b_mask = torch.ones_like(b_ids)
                rec["prefill_ms"][bucket] = cuda_ms(
                    lambda: dec._prefill_into(card, st, b_ids, b_mask, dec._greedy), 20)
            step = card.graphs[(1, DECODE_BUCKET, DECODE_NEW)]

            def replays():
                step.state.reset(dev_mask)
                for _ in range(DECODE_NEW - 1):
                    step.graph.replay()

            st = dec._DecodeState(cfg, 1, DECODE_BUCKET, DECODE_NEW, "cuda")
            dec._prefill_into(card, st, torch.as_tensor(ids, device="cuda"), dev_mask,
                              dec._greedy)

            def eager_steps():
                st.reset(dev_mask)
                for _ in range(DECODE_NEW - 1):
                    dec.decode_step(card, st)

            rec["graph_ms_per_token"] = cuda_ms(replays, 10) / (DECODE_NEW - 1)
            rec["eager_ms_per_token"] = cuda_ms(eager_steps, 3, warmup=1) / (DECODE_NEW - 1)
            st.reset(dev_mask)
            step_prof = op_class_breakdown(lambda: dec.decode_step(card, st))
        walls = {}
        for mode in (True, False):
            dec.generate_tokens(card, ids, mask, max_new=DECODE_NEW, graph=mode)
            t0 = time.perf_counter()
            for _ in range(5):
                dec.generate_tokens(card, ids, mask, max_new=DECODE_NEW, graph=mode)
            walls[mode] = (time.perf_counter() - t0) / 5 * 1e3
        prof = device_breakdown(
            lambda: dec.generate_tokens(card, ids, mask, max_new=DECODE_NEW),
            f"{preset} graphed generate, batch 1, bucket {DECODE_BUCKET}, "
            f"{DECODE_NEW} tokens", iters=3)
        live = DECODE_PROMPT + (DECODE_NEW - 1) / 2 + 1  # mean live slots a step
        step_bytes = decode_step_bytes(card, live)
        rec.update(
            generate_ms=walls[True], generate_eager_ms=walls[False],
            tokens_per_s=DECODE_NEW / (walls[True] / 1e3),
            tokens_per_s_eager=DECODE_NEW / (walls[False] / 1e3),
            step_launches=sum(step_prof["launches"].values()),
            step_device_ms=step_prof["device_ms"], step_profile=step_prof,
            generate_profile=prof, busy_share=prof["device_ms"] / prof["wall_ms"],
            step_bytes=step_bytes, bound_ms_per_token=step_bytes / PEAK_HBM_BYTES * 1e3,
            bound_by="bytes")
        if prof["launches"] < DECODE_NEW - 1:
            log(f"{tag} the profiler traced {prof['launches']:.0f} device launches in "
                "a graphed generate: the graph's kernels are not in its trace, so the "
                "busy share below counts the prefill only")
        log(f"{tag} prefill ms by bucket (CUDA events, 20 calls): "
            + ", ".join(f"{b}: {ms:.4f}" for b, ms in rec["prefill_ms"].items()))
        log(f"{tag} decode a token: graphed {rec['graph_ms_per_token']:.4f} ms, eager "
            f"{rec['eager_ms_per_token']:.4f} ms (CUDA events over {DECODE_NEW - 1} "
            f"steps), bound {rec['bound_ms_per_token']:.4f} ms ({step_bytes / 1e6:.1f} MB "
            f"a step at {PEAK_HBM_BYTES / 1e12:.2f} TB/s); {rec['step_launches']:.0f} "
            f"launches and {step_prof['device_ms']:.4f} ms of device time a step "
            f"({', '.join(f'{k} {v:.4f}' for k, v in step_prof['ms'].items())})")
        log(f"{tag} generate {DECODE_NEW} tokens after a {DECODE_PROMPT}-token prompt "
            f"(host clock, 5 calls): graphed {walls[True]:.2f} ms "
            f"({rec['tokens_per_s']:.1f} tokens/s), eager {walls[False]:.2f} ms "
            f"({rec['tokens_per_s_eager']:.1f} tokens/s); device busy "
            f"{100 * rec['busy_share']:.1f}% of a graphed generate")
        out[f"{preset}_v{vocab}"] = rec
        del card, params
        torch.cuda.empty_cache()
    return out


def lm_pipeline_phase(pipe):
    """7b: tpu-lm through the pipeline over phase 3's store (kernel route):
    the fixture answers 8 frozen questions (non-empty, no fallback), its
    float32 tokens equal the CPU path's and its bfloat16 graph the eager
    step's; then one question with the seeded mini at full width."""
    import dataclasses

    import torch

    from semcode_tpu_torch.models.decoder import CodeDecoderLM, generate_tokens
    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.rag import SemanticSearchPipeline

    questions = [q for q, _ in frozen_queries()][:8]

    def lm_pipe(**rag):
        # the grounding guard off: the fixture, a 0.5M-parameter byte model,
        # cites symbols and lines it never saw, and the guard would answer
        # those questions with the extractive summary (counted below)
        rag.setdefault("rag_grounding_guard", False)
        cfg = dataclasses.replace(pipe.config, rag_provider="tpu-lm", **rag)
        return SemanticSearchPipeline(config=cfg, vector_store=pipe.vector_store,
                                      embeddings=pipe.embeddings, device="cuda")

    fixture = lm_pipe(rag_weights_path=LM_FIXTURE)
    top2_scan.launches = 0
    results = [fixture.query(q, top_k=10) for q in questions]
    launches = top2_scan.launches
    for qtext, r in zip(questions, results):
        if not r["answer"].strip() or r["meta"].get("fallback_used"):
            fail(f"tpu-lm gave no answer to {qtext!r}: {r['meta']}")
    guarded = lm_pipe(rag_weights_path=LM_FIXTURE, rag_grounding_guard=True)
    guard_reasons = [guarded.query(q, top_k=10)["meta"].get("reason") for q in questions]
    llm_ms = [r["meta"]["timings_ms"]["llm"] for r in results]
    chat = fixture._get_llm()
    prompts = [chat.qa_prompt(q, [s["snippet"] for s in r["sources"]])
               for q, r in zip(questions, results)]
    card32 = CodeDecoderLM(weights_path=LM_FIXTURE, dtype="float32", device="cuda")
    cpu32 = CodeDecoderLM(weights_path=LM_FIXTURE, dtype="float32", device="cpu")
    equal = total = 0
    for p in prompts:
        a = card32.generate_ids(p, max_new_tokens=chat.max_new_tokens)
        b = cpu32.generate_ids(p, max_new_tokens=chat.max_new_tokens)
        equal += sum(x == y for x, y in zip(a, b))
        total += len(b)
    graph_equal = 0
    for p in prompts:
        arr, msk, max_new = chat.lm.prompt_arrays(p, chat.max_new_tokens)
        g = generate_tokens(chat.lm.model, arr, msk, max_new=max_new)
        e = generate_tokens(chat.lm.model, arr, msk, max_new=max_new, graph=False)
        graph_equal += bool(torch.equal(g, e))
    log(f"[lm e2e] fixture {LM_FIXTURE.name} ({chat.lm.cfg.layers} layers, hidden "
        f"{chat.lm.cfg.hidden}, max_len {chat.lm.cfg.max_len}) over phase 3's store: "
        f"8 frozen questions answered, none from the fallback; top2_scan launches "
        f"{launches}; llm stage ms {[round(x, 2) for x in llm_ms]} (the first "
        f"captures its bucket's decode graph); float32 tokens card = CPU: {equal} of "
        f"{total}; bfloat16 graph = eager: {graph_equal} of {len(prompts)} answers; "
        f"with the grounding guard on: {guard_reasons}")
    for qtext, r in list(zip(questions, results))[:3]:
        log(f"[lm e2e]   {qtext!r} -> {r['answer'][:100]!r}")
    if equal != total:
        fail(f"the card's float32 tokens differ from the CPU's: {equal} of {total}")
    if graph_equal != len(prompts):
        fail("the fixture's graph-replayed tokens differ from the eager step's")
    if launches < 1:
        fail("the tpu-lm pipeline never launched the top2_scan kernel")

    mini = lm_pipe(rag_weights_path=None, rag_preset="mini")
    timed = []
    for qtext in questions[:2]:
        r = mini.query(qtext, top_k=10)
        model = mini._get_llm().lm.model
        timed.append((r, dict(model.counts)))
    counts = timed[-1][1]
    tokens = counts["prefills"] + counts["decode_steps"]
    if tokens != 2 * DECODE_NEW:
        fail(f"the seeded mini generated {tokens} tokens for 2 answers: {counts}")
    mini_ms = [r["meta"]["timings_ms"].get("llm") for r, _ in timed]
    log(f"[lm e2e] seeded mini at full width: 2 questions, {tokens} tokens generated "
        f"({counts}); llm stage ms {mini_ms} (the first captures its graph); "
        f"reasons {[r['meta'].get('reason') for r, _ in timed]}")
    return {"launches": launches, "llm_ms": llm_ms, "tokens_equal": equal,
            "guard_reasons": guard_reasons,
            "tokens": total, "graph_equal": graph_equal, "mini_llm_ms": mini_ms,
            "mini_counts": counts,
            "answers": [r["answer"][:200] for r in results]}


def api_lm_phase(workdir: Path):
    """7c: phase 5a's flow with provider tpu-lm and the fixture: HTTP
    ingest, the startup warmup's graphs, 16 frozen questions at 8 in flight
    through POST /query, each answer equal to the in-process one."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.settings import AppSettings

    questions = [q for q, _ in frozen_queries()][:16]
    cfg = AppSettings(
        workspace_root=workdir / "api-tpu-lm", index_kind="flat",
        index_scan_impl="pallas", rag_provider="tpu-lm", rag_weights_path=LM_FIXTURE,
        rag_grounding_guard=False,  # as in 7b: every answer is the decoder's
        rag_query_cache_size=0, api_key=API_KEY,
    )
    t0 = time.perf_counter()
    app = create_app(config=cfg, device="cuda")
    auth = {"X-API-Key": API_KEY}
    out = {}

    async def serve():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/jobs/ingest", headers=auth, json={
                "name": "semcode_tpu", "root": str(ROOT), "include": ["semcode_tpu"]})
            job = await wait_job(client, (await r.json())["id"], auth)
            if job["status"] != "completed":
                fail(f"the ingest job ended {job['status']}: {job['error']}")
            await asyncio.to_thread(app["warmup_thread"].join)
            out["ready_s"] = time.perf_counter() - t0
            in_flight = asyncio.Semaphore(8)

            async def ask(question):
                async with in_flight:
                    t = time.perf_counter()
                    r = await client.post("/query", headers=auth,
                                          json={"question": question, "top_k": 10})
                    body = await r.json()
                    return r.status, body, (time.perf_counter() - t) * 1e3

            top2_scan.launches = 0
            t = time.perf_counter()
            replies = await asyncio.gather(*(ask(q) for q in questions))
            out["served_s"] = time.perf_counter() - t
            out["launches"] = top2_scan.launches
            tele = await (await client.get("/telemetry", headers=auth)).json()
            out["stages"] = tele["query_stages"]["avg_ms_per_query"]
            return replies
        finally:
            await client.close()

    replies = asyncio.run(serve())
    failed = sum(status != 200 for status, _, _ in replies)
    if failed:
        fail(f"{failed} of 16 tpu-lm queries failed: {[b for s, b, _ in replies if s != 200]}")
    direct = app["pipeline"].query_batch(questions, top_k=10)
    for qtext, (_, got, _), want in zip(questions, replies, direct):
        if got["answer"] != want["answer"] or [s["path"] for s in got["sources"]] != [
                s["path"] for s in want["sources"]]:
            fail(f"/query and query_batch answer {qtext!r} differently:\n"
                 f"{got['answer'][:200]!r}\n{want['answer'][:200]!r}")
    lat = sorted(ms for _, _, ms in replies)
    model = app["pipeline"]._get_llm().lm.model
    out.update(qps=len(questions) / out["served_s"], p50_ms=statistics.median(lat),
               failed=failed, fallbacks=sum(bool(b["meta"].get("fallback_used"))
                                            for _, b, _ in replies),
               captures=model.counts["graph_captures"],
               # each answer's own llm stage (/telemetry aggregates the batch
               # stages: "answer" there is a batch's generations, lock waits in)
               llm_ms=statistics.mean(b["meta"]["timings_ms"]["llm"] for _, b, _ in replies))
    log(f"[api tpu-lm] server ready (ingest + warmup joined) in {out['ready_s']:.2f} s, "
        f"{out['captures']} decode graphs captured; 16 frozen questions, 8 in flight: "
        f"{out['served_s'] * 1e3:.1f} ms ({out['qps']:.2f} QPS), p50 {out['p50_ms']:.1f} "
        f"ms, 0 failed, {out['fallbacks']} fallback answers, top2_scan launches "
        f"{out['launches']}; llm stage {out['llm_ms']:.2f} ms an answer; every answer "
        "equals the in-process query_batch's")
    log("[api tpu-lm] /telemetry stage means per query (ms): " + ", ".join(
        f"{k} {v}" for k, v in out["stages"].items()))
    return out


# -- phase 4: scale -----------------------------------------------------------


# -- phase 8: training on the card ---------------------------------------------

TRAIN_WARMUP = 3  # steps before the timed ones (cuBLAS handles, allocator)
TRAIN_STEPS = 20
# train-rerank's recipe holds the serving repo (semcode_tpu/) out; these
# trees hold more than 256 distinct chunks, so a batch is full
RERANK_CORPUS = ("semcode_tpu_torch", "tools", "tests")
ENCODER_TRAIN = dict(preset="mini", seq_len=128, batch_size=32)  # `train`'s defaults
LM_TRAIN = dict(preset="mini", seq_len=512, batch_size=32, qa_mix=0.5)  # `train-lm`'s
RERANK_TRAIN = dict(batch_size=256, steps=20)  # `train-rerank`'s batch, geometry


def train_chunks(dirs=("semcode_tpu",)):
    from semcode_tpu_torch.cli import _chunk_dirs

    return _chunk_dirs(",".join(str(ROOT / d) for d in dirs))


def transformer_step_flops(layers, hidden, mlp, seq, n_seqs, extra_params=0):
    """Model FLOPs of one training step: 6 x (the products' parameters) x
    tokens, plus the attention products (QK^T and PV, 4 L^2 h a sequence and
    layer forward, three times that with the backward)."""
    params = layers * (4 * hidden * hidden + 2 * hidden * mlp) + extra_params
    return 6 * params * seq * n_seqs + 3 * 4 * layers * seq * seq * hidden * n_seqs


def timed_training(trainer, params, opt_state, batches, label, flops, tokens, held):
    """TRAIN_WARMUP steps, then TRAIN_STEPS timed with CUDA events (each
    step uploads its batch, as the CLI's loop does); the timed steps'
    losses, peak memory above ``held`` (what the process held before the
    trainer was made), and a profiled step (device-busy share, launches,
    operator classes)."""
    import torch

    it = iter(batches)
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(params, opt_state, next(it))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    losses = []
    start.record()
    for _ in range(TRAIN_STEPS):
        losses.append(trainer.train_step(params, opt_state, next(it))[2]["loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() - held
    losses = [float(x) for x in losses]
    batch = next(it)

    def step():
        trainer.train_step(params, opt_state, batch)

    busy = device_breakdown(step, f"{label} train step", iters=3)
    classes = op_class_breakdown(step, iters=3)
    bound_ms = flops / PEAK_BF16_OPS * 1e3
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    rec = {"ms": ms, "tokens_per_s": tokens / (ms / 1e3), "flops": flops,
           "bound_ms": bound_ms, "bound_by": "operations", "peak_share": bound_ms / ms,
           "busy_share": busy["device_ms"] / busy["wall_ms"],
           "launches": busy["launches"], "peak_bytes": peak, "losses": losses,
           "loss_first5": first, "loss_last5": last, "classes": classes}
    log(f"[train] {label}: {ms:.3f} ms a step (CUDA events, {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP}), {rec['tokens_per_s']:.4g} tokens/s, {flops:.3g} model FLOP a "
        f"step, bound {bound_ms:.4f} ms (bf16 dense peak {PEAK_BF16_OPS / 1e12:.0f} "
        f"TFLOP/s): {100 * rec['peak_share']:.2f}% of peak; device busy "
        f"{100 * rec['busy_share']:.1f}% of a profiled step, {busy['launches']:.0f} "
        f"launches a step; peak memory {peak / 2**30:.2f} GiB above earlier phases'")
    log(f"[train]   device {classes['device_ms']:.3f} ms a step by class: "
        + ", ".join(f"{k} {v:.3f} ms ({classes['launches'][k]:.0f} launches)"
                    for k, v in classes["ms"].items()))
    log(f"[train]   largest kernels: {classes['top'][:4]}")
    log(f"[train]   loss over the timed steps: {[round(x, 4) for x in losses]}; "
        f"first 5 mean {first:.4f}, last 5 mean {last:.4f}")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: a non-finite loss {losses}")
    if not last < first:
        fail(f"{label}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return rec


def card_vs_cpu_step(make_trainer, state, batch, label):
    """One float32 step's loss and gradients on the card against the port's
    CPU path, same init and batch (TF32 off): the loss within 1e-4, each
    gradient within 1e-3 of its largest entry (+ 1e-6)."""
    import torch

    card, cpu = make_trainer("cuda"), make_trainer("cpu")
    pc, _ = card.state_from(state)
    pp, _ = cpu.state_from(state)
    mc, gc = card.value_and_grad(pc, batch)
    mp, gp = cpu.value_and_grad(pp, batch)
    loss_err = abs(float(mc["loss"]) - float(mp["loss"]))
    worst, worst_name = 0.0, None
    for name, g in gp.items():
        err = (gc[name].cpu() - g).abs().max().item()
        ratio = err / (1e-3 * g.abs().max().item() + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"[train] {label} float32 step card vs CPU: loss {float(mc['loss']):.6f} vs "
        f"{float(mp['loss']):.6f} (|diff| {loss_err:.3g}); worst gradient at "
        f"{worst:.3f} of its tolerance ({worst_name})")
    if loss_err > 1e-4 or worst > 1.0:
        fail(f"{label}: the card's float32 step differs from the CPU's "
             f"(loss {loss_err:.3g}, gradient {worst:.3f} of tolerance at {worst_name})")
    del card, cpu, pc, pp, gc, gp
    torch.cuda.empty_cache()
    return {"loss_abs_err": loss_err, "grad_tol_share": worst}


def encoder_training_phase(workdir: Path, chunks):
    """8a: the contrastive trainer at `train`'s defaults (mini encoder,
    sequence 128, batch 32, bf16 compute on float32 masters) on PairBatcher
    batches of semcode_tpu/'s chunks; saves the checkpoint for 8d."""
    import dataclasses

    import torch

    from semcode_tpu_torch.models.data import PairBatcher
    from semcode_tpu_torch.models.encoder import (
        EncoderConfig,
        encoder_state_to_jax,
        random_state,
    )
    from semcode_tpu_torch.models.tokenizer import HashingTokenizer
    from semcode_tpu_torch.models.train import ContrastiveTrainer, save_params

    seq, bsz = ENCODER_TRAIN["seq_len"], ENCODER_TRAIN["batch_size"]
    tok = HashingTokenizer(max_len=seq)
    cfg = EncoderConfig.preset(ENCODER_TRAIN["preset"], vocab_size=tok.vocab_size,
                               max_len=seq)
    batcher = PairBatcher([c.content for c in chunks], tok, seq_len=seq, batch_size=bsz,
                          symbols=[c.symbol for c in chunks],
                          languages=[c.language for c in chunks])
    batches = list(batcher.batches(TRAIN_WARMUP + TRAIN_STEPS + 1))
    held = torch.cuda.memory_allocated()
    trainer = ContrastiveTrainer(cfg, device="cuda")
    params, opt_state = trainer.init_state(seed=0)
    flops = transformer_step_flops(cfg.layers, cfg.hidden, cfg.mlp_dim, seq, 2 * bsz)
    rec = timed_training(trainer, params, opt_state, batches,
                         f"encoder ({ENCODER_TRAIN['preset']}, 2 x {bsz} x {seq})",
                         flops, 2 * bsz * seq, held)
    out = workdir / "trained-encoder"
    save_params(encoder_state_to_jax(params, cfg), cfg, out)
    del trainer, params, opt_state
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    rec["card_vs_cpu"] = card_vs_cpu_step(
        lambda dev: ContrastiveTrainer(f32, device=dev), random_state(f32, 0),
        batches[0], "encoder")
    rec["checkpoint"] = str(out)
    return rec


def lm_training_phase(workdir: Path, chunks):
    """8b: the next-token trainer at `train-lm`'s defaults (mini decoder,
    byte vocabulary, sequence 512, batch 32, QA mix 0.5); saves the
    checkpoint for 8d."""
    import dataclasses

    import torch

    from semcode_tpu_torch.models.decoder import (
        DecoderConfig,
        decoder_state_from_jax,
        decoder_state_to_jax,
        init_params,
    )
    from semcode_tpu_torch.models.tokenizer import ByteTokenizer
    from semcode_tpu_torch.models.train_lm import (
        LMTrainer,
        WindowBatcher,
        build_qa_texts,
        save_lm_params,
    )

    seq, bsz = LM_TRAIN["seq_len"], LM_TRAIN["batch_size"]
    tok = ByteTokenizer(max_len=seq)
    cfg = DecoderConfig.preset(LM_TRAIN["preset"], vocab_size=tok.vocab_size,
                               max_len=max(seq, 1024))
    batcher = WindowBatcher([c.content for c in chunks], tok, seq_len=seq, batch_size=bsz,
                            anchored_texts=build_qa_texts(chunks),
                            anchored_frac=LM_TRAIN["qa_mix"])
    batches = list(batcher.batches(TRAIN_WARMUP + TRAIN_STEPS + 1))
    held = torch.cuda.memory_allocated()
    trainer = LMTrainer(cfg, device="cuda")
    params, opt_state = trainer.init_state(seed=0)
    flops = transformer_step_flops(cfg.layers, cfg.hidden, cfg.mlp_dim, seq, bsz,
                                   extra_params=cfg.vocab_size * cfg.hidden)
    rec = timed_training(trainer, params, opt_state, batches,
                         f"LM ({LM_TRAIN['preset']}, {bsz} x {seq})", flops, bsz * seq,
                         held)
    out = workdir / "trained-lm"
    save_lm_params(decoder_state_to_jax(params), cfg, out)
    del trainer, params, opt_state
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    rec["card_vs_cpu"] = card_vs_cpu_step(
        lambda dev: LMTrainer(f32, device=dev),
        decoder_state_from_jax(init_params(f32, seed=0)), batches[0], "LM")
    rec["checkpoint"] = str(out)
    return rec


def rerank_training_phase(workdir: Path):
    """8c: the term reranker at the default geometry (131,072 x 32 table,
    batch 256, 64 query terms, 96 doc terms) for 20 steps on pairs of the
    held-out trees; saves the table for 8d."""
    import torch

    from semcode_tpu_torch.models.term_reranker import (
        DEFAULT_BUCKETS,
        DEFAULT_DIM,
        build_pairs,
        featurize_pairs,
        save_table,
        train_term_table,
    )

    chunks = train_chunks(RERANK_CORPUS)
    metas = [(f"c{i}", {"text": c.content, "symbol": c.symbol,
                        "path": str(getattr(c, "path", "") or ""), "language": c.language})
             for i, c in enumerate(chunks)]
    t0 = time.perf_counter()
    feats = featurize_pairs(build_pairs(metas))
    feat_s = time.perf_counter() - t0
    steps, bsz = RERANK_TRAIN["steps"], RERANK_TRAIN["batch_size"]
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    table = train_term_table(feats, steps=steps, batch_size=bsz, log_every=1,
                             log=lines.append, device="cuda")
    wall_s = time.perf_counter() - t0  # ends in the table's copy to the host
    peak = torch.cuda.max_memory_allocated() - held
    losses = [float(s.split("loss=")[1].split()[0]) for s in lines]
    ms = wall_s * 1e3 / steps
    log(f"[train] term reranker ({DEFAULT_BUCKETS} x {DEFAULT_DIM}, batch {bsz}, "
        f"{feats['q_ids'].shape[1]} x {feats['d_ids'].shape[1]} terms; {len(chunks)} "
        f"chunks -> {feats['q_ids'].shape[0]} pairs, featurized in {feat_s:.2f} s): "
        f"{ms:.2f} ms a step (host clock over {steps} steps, host sampling and the "
        f"first step's set-up included), peak memory {peak / 2**30:.2f} GiB above "
        f"earlier phases'; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if table.shape != (DEFAULT_BUCKETS, DEFAULT_DIM) or not torch.isfinite(
            torch.from_numpy(table)).all():
        fail(f"the term table came back {table.shape} or not finite")
    out = workdir / "term-reranker.npz"
    save_table(table, out)
    return {"ms": ms, "peak_bytes": peak, "losses": losses, "pairs": int(feats["q_ids"].shape[0]),
            "featurize_s": feat_s, "table": str(out)}


def train_serve_phase(workdir: Path, encoder_ckpt, lm_ckpt, table):
    """8d: 8a's encoder serves a self-ingest of semcode_tpu/ (tpu-encoder,
    kernel route, 8c's table in the rerank); the frozen questions through
    query_batch, top2_scan's launches read around them; 8b's LM answers one
    question as tpu-lm."""
    import dataclasses

    from semcode_tpu_torch.ops.scan_top2 import top2_scan
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.services import IndexerService
    from semcode_tpu_torch.settings import AppSettings

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    cfg = AppSettings(
        workspace_root=workdir / "train-serve",
        embedding_provider="tpu-encoder",
        encoder_weights_path=Path(encoder_ckpt),
        index_kind="flat",
        index_scan_impl="pallas",
        search_rerank_learned=str(table),
        rag_provider="fallback",
        rag_query_cache_size=0,
    )
    svc = IndexerService(config=cfg, device="cuda")
    res = svc.index_repository([ROOT / "semcode_tpu"], "semcode_tpu")
    emb = svc.embeddings
    if emb.random_init or emb.cfg.max_len != ENCODER_TRAIN["seq_len"]:
        fail("the store's encoder is not 8a's checkpoint")
    if svc.vector_store._learned_table() is None:
        fail("the store did not load 8c's term table")
    pipe = SemanticSearchPipeline(config=cfg, vector_store=svc.vector_store,
                                  embeddings=emb, device="cuda")
    top2_scan.launches = 0
    results = pipe.query_batch(questions, top_k=10)
    launches = top2_scan.launches
    if any(not r["sources"] for r in results):
        fail("a frozen question got no hits from the trained encoder's store")
    if launches < 1:
        fail("the trained encoder's store never launched top2_scan")
    mrr, recall = rank_metrics(results, [rel for _, rel in queries])

    lm_cfg = dataclasses.replace(cfg, rag_provider="tpu-lm", rag_weights_path=Path(lm_ckpt),
                                 rag_grounding_guard=False)
    lm_pipe = SemanticSearchPipeline(config=lm_cfg, vector_store=svc.vector_store,
                                     embeddings=emb, device="cuda")
    answer = lm_pipe.query(questions[0], top_k=10)
    chat = lm_pipe._get_llm()
    counts = dict(chat.lm.model.counts)
    if not answer["answer"].strip():
        fail(f"the trained LM gave an empty answer: {answer['meta']}")
    if counts["prefills"] < 1:
        fail(f"the trained LM never ran: {counts}")
    # the completion itself, before the pipeline's stops and strip
    raw = chat.lm.generate(chat.qa_prompt(questions[0], [s["snippet"] for s in
                                                         answer["sources"]]),
                           max_new_tokens=chat.max_new_tokens)
    log(f"[train-serve] trained encoder: {res.chunk_count} chunks of semcode_tpu/ into "
        f"{svc.vector_store.dim}-d rows, 102 frozen questions all with hits; top2_scan "
        f"launches {launches}; MRR@10 {mrr:.4f} recall@10 {recall:.4f} (20 steps from a "
        f"random init: not a target)")
    log(f"[train-serve] trained LM as tpu-lm: {questions[0]!r} -> "
        f"{answer['answer'][:100]!r} (fallback {answer['meta'].get('fallback_used')}, "
        f"reason {answer['meta'].get('reason')}; decoder counts {counts}); its raw "
        f"completion: {raw[:80]!r}")
    return {"launches": launches, "mrr": mrr, "recall": recall, "chunks": res.chunk_count,
            "lm_fallback": bool(answer["meta"].get("fallback_used")), "lm_counts": counts,
            "lm_raw": raw[:200]}


def training_phase(workdir: Path):
    """8: the three trainers on the card, then their outputs served (8d)."""
    t0 = time.perf_counter()
    chunks = train_chunks()
    encoder = encoder_training_phase(workdir, chunks)
    lm = lm_training_phase(workdir, chunks)
    rerank = rerank_training_phase(workdir)
    serve = train_serve_phase(workdir, encoder["checkpoint"], lm["checkpoint"],
                              rerank["table"])
    log(f"[train] phase 8 took {time.perf_counter() - t0:.1f} s")
    return {"encoder": encoder, "lm": lm, "rerank": rerank, "serve": serve}


# -- phase 10: DP x TP sharded training and the multi-device entry -----------------

TRAIN_MESH = (2, 2)  # ("data", "model"): 2 replicas x 2 model shards, all on cuda:0
TP_DECODE_ROWS, TP_DECODE_BUCKET, TP_DECODE_NEW = 8, 256, 64  # 10c


def train_mesh():
    """Phase 10's (data, model) mesh on the one card: the counterpart of
    XLA's forced host device count."""
    from semcode_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(TRAIN_MESH, ("data", "model"),
                     devices=["cuda:0"] * int(math.prod(TRAIN_MESH)))


def sharded_vs_one_device(make_trainer, state, batch, label):
    """One float32 step on the (2, 2) mesh against the one-device step on
    the card, same init and batch: the loss and accuracy within 1e-5 and
    every gathered gradient within rtol 1e-4 / atol 1e-6 (the CPU tests'
    tolerances, tests/test_torch_train_sharded.py)."""
    import torch

    one, sharded = make_trainer(None), make_trainer(train_mesh())
    p1, _ = one.state_from(state)
    p2, _ = sharded.state_from(state)
    m1, g1 = one.value_and_grad(p1, batch)
    m2, g2 = sharded.value_and_grad(p2, batch)
    g2 = sharded.gather(g2)
    loss_err = abs(float(m2["loss"]) - float(m1["loss"]))
    acc_err = abs(float(m2["accuracy"]) - float(m1["accuracy"]))
    worst, worst_name = 0.0, None
    for name, g in g1.items():
        ratio = ((g2[name] - g).abs() / (1e-6 + 1e-4 * g.abs())).max().item()
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"[sharded-train] {label} float32 step on the {TRAIN_MESH} mesh vs one device: "
        f"loss {float(m2['loss']):.6f} vs {float(m1['loss']):.6f} (|diff| {loss_err:.3g}), "
        f"accuracy |diff| {acc_err:.3g}; worst gradient at {worst:.3f} of its tolerance "
        f"({worst_name})")
    if loss_err > 1e-5 or acc_err > 1e-5 or worst > 1.0:
        fail(f"{label}: the sharded float32 step differs from the one-device step "
             f"(loss {loss_err:.3g}, gradient {worst:.3f} of tolerance at {worst_name})")
    del one, sharded, p1, p2, g1, g2
    torch.cuda.empty_cache()
    return {"loss_abs_err": loss_err, "grad_tol_share": worst}


def beside(label, rec, one):
    log(f"[sharded-train] {label} on the {TRAIN_MESH} mesh: {rec['ms']:.3f} ms a step, "
        f"{rec['launches']:.0f} launches, busy {100 * rec['busy_share']:.1f}%, peak "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB; one device (phase 8, this run): "
        f"{one['ms']:.3f} ms, {one['launches']:.0f} launches, busy "
        f"{100 * one['busy_share']:.1f}%, peak {one['peak_bytes'] / 2**30:.2f} GiB "
        f"({rec['ms'] / one['ms']:.2f}x the time)")


def sharded_encoder_phase(chunks, one):
    """10a: 8a's contrastive step (mini, hashing vocabulary, 32 pairs of
    128, PairBatcher pairs of semcode_tpu/) on the (2, 2) mesh: 20 timed bf16
    steps beside 8a's figures (``one``); the float32 step against one
    device."""
    import dataclasses

    import torch

    from semcode_tpu_torch.models.data import PairBatcher
    from semcode_tpu_torch.models.encoder import EncoderConfig, random_state
    from semcode_tpu_torch.models.tokenizer import HashingTokenizer
    from semcode_tpu_torch.models.train import ContrastiveTrainer

    seq, bsz = ENCODER_TRAIN["seq_len"], ENCODER_TRAIN["batch_size"]
    tok = HashingTokenizer(max_len=seq)
    cfg = EncoderConfig.preset(ENCODER_TRAIN["preset"], vocab_size=tok.vocab_size,
                               max_len=seq)
    batcher = PairBatcher([c.content for c in chunks], tok, seq_len=seq, batch_size=bsz,
                          symbols=[c.symbol for c in chunks],
                          languages=[c.language for c in chunks])
    batches = list(batcher.batches(TRAIN_WARMUP + TRAIN_STEPS + 1))
    held = torch.cuda.memory_allocated()
    trainer = ContrastiveTrainer(cfg, train_mesh())
    params, opt_state = trainer.init_state(seed=0)
    flops = transformer_step_flops(cfg.layers, cfg.hidden, cfg.mlp_dim, seq, 2 * bsz)
    label = f"sharded encoder ({ENCODER_TRAIN['preset']}, 2 x {bsz} x {seq})"
    rec = timed_training(trainer, params, opt_state, batches, label, flops,
                         2 * bsz * seq, held)
    beside("encoder", rec, one)
    del trainer, params, opt_state
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    rec["vs_one_device"] = sharded_vs_one_device(
        lambda mesh: ContrastiveTrainer(f32, mesh),
        random_state(f32, 0), batches[0], "encoder")
    return rec


def sharded_lm_phase(chunks, one):
    """10b: 8b's next-token step (mini decoder, 32 x 512 bytes, QA mix 0.5)
    on the (2, 2) mesh, as 10a."""
    import dataclasses

    import torch

    from semcode_tpu_torch.models.decoder import (
        DecoderConfig,
        decoder_state_from_jax,
        init_params,
    )
    from semcode_tpu_torch.models.tokenizer import ByteTokenizer
    from semcode_tpu_torch.models.train_lm import LMTrainer, WindowBatcher, build_qa_texts

    seq, bsz = LM_TRAIN["seq_len"], LM_TRAIN["batch_size"]
    tok = ByteTokenizer(max_len=seq)
    cfg = DecoderConfig.preset(LM_TRAIN["preset"], vocab_size=tok.vocab_size,
                               max_len=max(seq, 1024))
    batcher = WindowBatcher([c.content for c in chunks], tok, seq_len=seq, batch_size=bsz,
                            anchored_texts=build_qa_texts(chunks),
                            anchored_frac=LM_TRAIN["qa_mix"])
    batches = list(batcher.batches(TRAIN_WARMUP + TRAIN_STEPS + 1))
    held = torch.cuda.memory_allocated()
    trainer = LMTrainer(cfg, train_mesh())
    params, opt_state = trainer.init_state(seed=0)
    flops = transformer_step_flops(cfg.layers, cfg.hidden, cfg.mlp_dim, seq, bsz,
                                   extra_params=cfg.vocab_size * cfg.hidden)
    rec = timed_training(trainer, params, opt_state, batches,
                         f"sharded LM ({LM_TRAIN['preset']}, {bsz} x {seq})", flops,
                         bsz * seq, held)
    beside("LM", rec, one)
    del trainer, params, opt_state
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    rec["vs_one_device"] = sharded_vs_one_device(
        lambda mesh: LMTrainer(f32, mesh),
        decoder_state_from_jax(init_params(f32, seed=0)), batches[0], "LM")
    return rec


def sharded_decode_phase(chunks):
    """10c: the fixture LM at float32 as the (2, 2) trainer's sharded state;
    8 QA prompts of semcode_tpu/'s chunks and frozen questions (bucket 256),
    64 greedy tokens each through ``generate_tokens`` over the 2 model
    shards (eager) against the one-device eager path on the gathered state:
    every token equal."""
    import torch

    from semcode_tpu_torch.models.decoder import (
        QA_ANSWER,
        QA_CONTEXT,
        QA_CTX_CHARS,
        QA_QUESTION,
        build_decoder,
        decoder_state_from_jax,
        decoder_state_to_jax,
        generate_tokens,
    )
    from semcode_tpu_torch.models.tokenizer import ByteTokenizer
    from semcode_tpu_torch.models.train_lm import LMTrainer, load_lm_params

    params, cfg = load_lm_params(LM_FIXTURE, dtype=torch.float32)
    trainer = LMTrainer(cfg, train_mesh())
    state, _ = trainer.state_from(decoder_state_from_jax(params))
    sharded = trainer.decoder(state)
    one = build_decoder(decoder_state_to_jax(trainer.gather(state)), cfg, "cuda")
    tok = ByteTokenizer()
    budget = TP_DECODE_BUCKET * 3 // 4
    ids = torch.zeros(TP_DECODE_ROWS, TP_DECODE_BUCKET, dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, ((question, _), chunk) in enumerate(zip(frozen_queries(), chunks[::7])):
        row = tok.encode(f"{QA_CONTEXT}{chunk.content[:QA_CTX_CHARS]}{QA_QUESTION}"
                         f"{question}{QA_ANSWER}")[-budget:]
        ids[i, :len(row)] = torch.tensor(row)
        mask[i, :len(row)] = 1
        if i + 1 == TP_DECODE_ROWS:
            break
    out, ms = {}, {}
    for name, model in (("sharded", sharded), ("one", one), ("sharded", sharded)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kwargs = {} if name == "sharded" else {"graph": False}
        out[name] = generate_tokens(model, ids, mask, max_new=TP_DECODE_NEW, **kwargs).cpu()
        ms[name] = (time.perf_counter() - t0) * 1e3 / TP_DECODE_NEW
    equal = int((out["sharded"] == out["one"]).sum())
    total = out["one"].numel()
    log(f"[sharded-decode] fixture {LM_FIXTURE.name} at float32 on {len(sharded.devices)} "
        f"model shards: {equal} of {total} tokens equal to the one-device eager path "
        f"({TP_DECODE_ROWS} prompts in bucket {TP_DECODE_BUCKET}, {TP_DECODE_NEW} new each); "
        f"{ms['sharded']:.2f} ms a token sharded, {ms['one']:.2f} one device (host "
        f"clock, eager, the second sharded call)")
    if equal != total:
        fail(f"the sharded decode's tokens differ from one device's ({equal} of {total})")
    return {"equal": equal, "total": total, "ms_token": ms["sharded"],
            "one_ms_token": ms["one"]}


def dryrun_phase():
    """10d: ``entry.dryrun_multichip(8)`` on [cuda:0] * 8, the launch counts of
    its index half read around it."""
    from semcode_tpu_torch.entry import dryrun_multichip
    from semcode_tpu_torch.ops.ivf_scan import ivf_scan
    from semcode_tpu_torch.ops.scan_top2 import top2_scan

    top2_scan.launches = ivf_scan.launches = 0
    t0 = time.perf_counter()
    line = dryrun_multichip(8)
    secs = time.perf_counter() - t0
    launches = {"top2_scan": top2_scan.launches, "ivf_scan": ivf_scan.launches}
    log(f"[dryrun] {line} in {secs:.1f} s; kernel launches of its index half "
        f"(the indexes' default routes): {launches}")
    return {"line": line, "s": secs, "launches": launches}


def sharded_training_phase(training):
    """10: DP x TP training on the one card beside phase 8 (``training``),
    the sharded decode and the multi-device dry run."""
    t0 = time.perf_counter()
    chunks = train_chunks()
    encoder = sharded_encoder_phase(chunks, training["encoder"])
    lm = sharded_lm_phase(chunks, training["lm"])
    decode = sharded_decode_phase(chunks)
    dryrun = dryrun_phase()
    log(f"[sharded-train] phase 10 took {time.perf_counter() - t0:.1f} s")
    return {"encoder": encoder, "lm": lm, "decode": decode, "dryrun": dryrun}


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

    from semcode_tpu_torch.utils.tracing import is_span_event

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    launches = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev_us > 0 and not is_span_event(ev):
            rows.append((ev.key, dev_us / 1e3 / iters))
            launches += ev.count
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{launches / iters:.0f} device launches per call")
    for name, ms in rows[:8]:
        log(f"[profile]   {ms:8.3f} ms  {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy, "launches": launches / iters,
            "top": [[name[:60], ms] for name, ms in rows[:5]]}


def kernel_device_ms(fn, names, iters: int = 10):
    """Device ms per call of ``fn`` spent in the kernels whose names contain
    each of ``names`` (torch.profiler, CUDA activity), for kernels that
    ``fn`` launches once a call: averaged over the launches the profiler
    recorded. It has been seen to drop a window's events (a scan "taking"
    0.016 ms), so a window with none of a kernel is profiled again, up to
    three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semcode_tpu_torch.utils.tracing import is_span_event

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = dict.fromkeys(names, 0.0)
        count = dict.fromkeys(names, 0)
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if ev.device_type != DeviceType.CUDA or is_span_event(ev):
                continue
            for name in names:
                if name in ev.key:
                    total[name] += dev_us / 1e3
                    count[name] += ev.count
        if all(count[name] for name in names):
            break
        log(f"[profile] no launch of {[nm for nm in names if not count[nm]]} "
            "recorded; profiling again")
    for name in names:
        if count[name] == 0:
            fail(f"the profiler recorded no launch of {name}")
        if count[name] != iters:
            log(f"[profile] {name}: {count[name]} of {iters} launches recorded")
    return {name: total[name] / count[name] for name in names}


def scale_phase():
    import torch

    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.scan import quantize_queries_device
    from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan
    from semcode_tpu_torch.tools._corpus import mixture, oracle_topk, queries_near

    gen = torch.Generator(device="cuda").manual_seed(42)
    t0 = time.perf_counter()
    x = mixture(gen, N_ROWS, DIM)
    q = queries_near(gen, x, BATCH)
    x_host = x.cpu().numpy()
    index = FlatIndex(DIM, metric="ip", dtype="int8", scan_impl="pallas",
                      device="cuda")
    index.add(x_host)
    truth = oracle_topk(x, q, 10)
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

    # the kernel at the main path's shape, with the operands the scan builds,
    # at the bulk batch and at the interactive one
    vecs, _, valid, scales, _, _ = shard0(index._ensure_device())
    add = torch.where(valid, 0.0, NEG).float()
    qq_all, qsc_all = quantize_queries_device(q)
    calls = top2_scan.launches
    timed = {nq: time_top2(vecs, scales, add, qq_all[:nq], qsc_all[:nq])
             for nq in (BATCH, SERVE_BATCH)}
    log(f"[scale] {top2_scan.launches - calls} top2_scan timing launches")
    out["kernel"] = timed[BATCH]
    out["kernel_q8"] = timed[SERVE_BATCH]
    out["dot_max"] = dot_max_phase(vecs, qq_all, timed)
    del index, vecs, valid, scales, add, qq_all, qsc_all
    for storage in ("bfloat16", "float32"):
        out[storage] = float_scale_leg(storage, x_host, q, truth)
    return out


def float_scale_leg(storage, x_host, q, truth):
    """Phase 4 over bf16 or f32 storage: the same rows in a FlatIndex of
    that dtype on the kernel route; recall, QPS, p50 and the kernel's
    timings. top2_scan's launches are read around the searches."""
    import gc

    import torch

    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan
    from semcode_tpu_torch.tools._corpus import oracle_topk

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index = FlatIndex(DIM, metric="ip", dtype=storage, scan_impl="pallas",
                      device="cuda")
    index.add(x_host)
    vecs, _, valid, _, _, _ = shard0(index._ensure_device())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    top2_scan.launches = 0
    _, ids = index.search_device(q, 10)
    rec = recall_at_10(ids, truth)
    qps, p50 = timed_search(lambda qb: index.search_device(qb, 10), q)
    launches = top2_scan.launches
    # bf16 rows are rescored from their f32 mirror: held to the f32 oracle.
    # f32 rows have no rescore tier (storage counts as exact) and the kernel
    # rounds them and the queries to bf16 (scan_kernel2.py:130): held to the
    # oracle of those rounded operands, with the f32 oracle's recall printed
    held, oracle = rec, "f32"
    if storage == "float32":
        xb = torch.from_numpy(x_host).to("cuda").to(torch.bfloat16).float()
        held = recall_at_10(ids, oracle_topk(xb, q.to(torch.bfloat16).float(), 10))
        oracle = "bf16-rounded"
        del xb
    log(f"[scale] {storage} flat index ({N_ROWS} x {DIM}, built in {build_s:.1f} "
        f"s), kernel route: recall@10 {rec:.4f} (f32 oracle), {held:.4f} "
        f"({oracle} oracle)  QPS@{BATCH} {qps:.0f}  p50@{SERVE_BATCH} {p50:.2f} "
        f"ms; top2_scan launches {launches}")
    if held < 0.99:
        fail(f"{storage} kernel-route recall@10 {held:.4f} < 0.99 against the "
             f"{oracle} oracle")
    if launches < 1:
        fail(f"the {storage} flat search never launched the top2_scan kernel")
    rows = vecs.shape[0]
    add = torch.where(valid, 0.0, NEG).float()
    ones_r = torch.ones(rows, device="cuda")
    qb = q.to(torch.bfloat16)
    ones_q = torch.ones(BATCH, device="cuda")
    timed = {nq: time_top2(vecs, ones_r, add, qb[:nq], ones_q[:nq])
             for nq in (BATCH, SERVE_BATCH)}
    return {"recall": rec, "recall_held": held, "oracle": oracle, "qps": qps,
            "p50_b8_ms": p50, "launches": launches,
            "kernel": timed[BATCH], "kernel_q8": timed[SERVE_BATCH]}


def time_top2(vecs, scales, add, qq, qsc):
    """top2_scan on a flat index's own operands (int8, bf16 or f32 rows):
    ms per call (CUDA events) beside its plain version, one PyTorch-library
    computation of the same selection and its bound; and its two
    measurement builds (products and pipeline alone, selection and pipeline
    alone)."""
    import torch

    from semcode_tpu_torch.device import f32_matmul
    from semcode_tpu_torch.ops.scan_top2 import (
        scan_geometry, top2_scan, top2_scan_probe, top2_scan_reference,
    )
    from semcode_tpu_torch.tools._timing import cuda_ms

    storage = str(vecs.dtype).replace("torch.", "")
    args = (vecs, scales, add, qq, qsc)
    rows, nq = vecs.shape[0], qq.shape[0]
    nb = -(-rows // 128)
    kernel_ms = cuda_ms(lambda: top2_scan(*args), iters=20)
    bm, br = top2_scan(*args)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: top2_scan_reference(*args), iters=3, warmup=1)
    rm, rr = top2_scan_reference(*args)
    tag = f"{storage} at the main-path shape (Q={nq})"
    if storage == "int8":
        if not (torch.equal(bm, rm) and torch.equal(br, rr)):
            fail(f"top2_scan differs from its plain version {tag}")
    else:
        if not torch.allclose(bm, rm, rtol=1e-5, atol=1e-6):
            fail(f"top2_scan {tag}: scores off by {(bm - rm).abs().max().item()}")
        check_float_rows(args, bm, br, rm, rr, tag)
    err = (bm - rm).abs().max().item()
    del rm, rr
    probe_ms = {kind: cuda_ms(lambda: top2_scan_probe(kind, *args), iters=20)
                for kind in ("products", "selection")}

    if storage == "int8":
        # cuBLASLt's int8 GEMM takes more than 16 query rows: zero rows pad it
        qpad = torch.cat([qq, qq.new_zeros((max(0, 24 - nq), DIM))])

        def library():
            # one PyTorch computation of the same selection: cuBLASLt int8
            # GEMM, the epilogue, and topk(2) over each 128-row block
            raw = torch._int_mm(qpad, vecs.T)[:nq].float()
            s = raw * qsc[:, None] * scales[None, :] + add[None, :]
            return torch.topk(s.view(nq, nb, 128), 2, dim=2)
        peak, esize = PEAK_INT8_OPS, 1
    else:
        qf = qq.float()

        def library():
            # the f32 GEMM (TF32 off) of the bf16-rounded operands, the
            # epilogue and topk(2) over each 128-row block, in row chunks
            out = []
            for lo in range(0, rows, 1 << 17):
                v = vecs[lo:lo + (1 << 17)].to(torch.bfloat16).float()
                s = f32_matmul(qf, v.T) * qsc[:, None]
                s = s * scales[None, lo:lo + v.shape[0]] + add[None, lo:lo + v.shape[0]]
                out.append(torch.topk(s.view(nq, -1, 128), 2, dim=2))
            return out
        peak, esize = PEAK_BF16_OPS, vecs.element_size()

    library_ms = cuda_ms(library, iters=5)
    n_bytes = (rows * DIM * esize + 2 * rows * 4 + nq * DIM * qq.element_size()
               + nq * 4 + nq * 2 * nb * 8)
    n_ops = 2 * nq * rows * DIM
    bound_ms = max(n_bytes / PEAK_HBM_BYTES, n_ops / peak) * 1e3
    bound_by = "operations" if n_ops / peak >= n_bytes / PEAK_HBM_BYTES else "bytes"
    geom = scan_geometry(rows, DIM, nq, torch.cuda.get_device_properties(0).multi_processor_count,
                         storage)
    log(f"[scale] top2_scan {rows} x {DIM} {storage}, Q={nq}: {kernel_ms:.3f} ms "
        f"per call (plain {plain_ms:.1f} ms, library {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms by {bound_by}); measurement builds: products alone "
        f"{probe_ms['products']:.3f} ms, selection alone {probe_ms['selection']:.3f} "
        f"ms; grid {geom.grid} CTAs over {geom.work_items} work items, "
        f"{geom.stages} stages, {geom.smem_bytes} B shared memory, rows "
        f"{'shared' if geom.shared_rows else 'loaded per consumer'}, consumers "
        f"{'taking turns' if geom.turns else 'together'}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "products_ms": probe_ms["products"],
            "selection_ms": probe_ms["selection"]}


# -- phase 4c: the dot-max kernel at the main shape ------------------------------


def dot_max_phase(vecs, qq, top2):
    """dot_max on phase 4's own int8 rows and quantized queries, in both
    modes at every row tile; top2_scan's int8 time (``top2``: phase 4's
    timings by batch) beside dot_max s32, the same GEMM with no selection;
    one run of the tools.dot_cuda entry point."""
    import contextlib
    import io

    import torch

    from semcode_tpu_torch.ops.dot_max import MODES, RTILES, dot_max, dot_max_reference
    from semcode_tpu_torch.tools import dot_cuda
    from semcode_tpu_torch.tools._timing import cuda_ms

    t0 = time.perf_counter()
    rows, d = vecs.shape
    nq = qq.shape[0]
    want = dot_max_reference(vecs, qq)
    plain_ms = cuda_ms(lambda: dot_max_reference(vecs, qq), iters=3, warmup=1)
    if not torch.equal(dot_cuda.int_mm_max(vecs, qq), want):
        fail("torch._int_mm + amax differs from dot_max's plain version")
    library_ms = cuda_ms(lambda: dot_cuda.int_mm_max(vecs, qq), iters=5)
    n_ops = 2 * nq * rows * d
    n_bytes = rows * d + nq * d + nq * 4
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    bounds = {"s32": n_ops / PEAK_INT8_OPS * 1e3, "bf16": n_ops / PEAK_BF16_OPS * 1e3}
    ms = {}
    err = 0
    for mode in ("s32", "bf16"):
        for rtile in RTILES:
            got = dot_max(vecs, qq, mode=mode, rtile=rtile)
            torch.cuda.synchronize()
            err = max(err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                fail(f"dot_max {mode} rtile={rtile} differs from its plain "
                     "version at the main-path shape")
            t = cuda_ms(lambda: dot_max(vecs, qq, mode=mode, rtile=rtile), iters=20)
            ms[f"{mode}_{rtile}"] = t
            log(f"[dot-max] {mode} rtile {rtile}: {t:.3f} ms per call, "
                f"{n_ops / t / 1e9:.1f} TOP/s (bound {max(bounds[mode], bytes_ms):.3f} ms "
                f"by {'operations' if bounds[mode] >= bytes_ms else 'bytes'})")
    q8 = qq[:SERVE_BATCH]
    want8 = dot_max_reference(vecs, q8)
    for rtile in RTILES:
        if not torch.equal(dot_max(vecs, q8, rtile=rtile), want8):
            fail(f"dot_max s32 rtile={rtile} differs from its plain version at Q=8")
        ms[f"s32_{rtile}_q{SERVE_BATCH}"] = cuda_ms(
            lambda: dot_max(vecs, q8, rtile=rtile), iters=20)
    log(f"[dot-max] s32 at Q={SERVE_BATCH}: " + ", ".join(
        f"rtile {r} {ms[f's32_{r}_q{SERVE_BATCH}']:.3f} ms" for r in RTILES)
        + f" (bound {(rows * d + SERVE_BATCH * (d + 4)) / PEAK_HBM_BYTES * 1e3:.3f} "
        "ms by bytes)")
    best = {mode: min(RTILES, key=lambda r: ms[f"{mode}_{r}"]) for mode in MODES}
    for batch, suffix in ((nq, ""), (SERVE_BATCH, f"_q{SERVE_BATCH}")):
        t = top2[batch]
        gemm = ms[f"s32_{best['s32']}{suffix}"]
        log(f"[dot-max] at Q={batch}: top2_scan int8 {t['ms']:.3f} ms (products "
            f"alone {t['products_ms']:.3f}, selection alone {t['selection_ms']:.3f}) "
            f"beside dot_max s32 {gemm:.3f} ms at rtile {best['s32']}, the same "
            "GEMM and ring with no selection")

    # the kernel-measurement tool's path, at its default shape, short SECS
    buf = io.StringIO()
    dot_max.launches = 0
    for mode in MODES:
        dot_max.mode_launches[mode] = 0
    with contextlib.redirect_stdout(buf):
        dot_cuda.main([], {"SECS": "0.1", "CHUNK_B": "4"})
    launches = dict(dot_max.mode_launches)
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
    for rec in lines:
        log(f"[dot_cuda] {json.dumps(rec)}")
    kernel_lines = [r for r in lines if r["mode"] != "torch_int_mm_s8s8"]
    if len(lines) != 1 + 2 * len(RTILES) or any("error" in r for r in lines):
        fail("tools.dot_cuda did not print one result line per config")
    if not all(r["max_equal"] for r in kernel_lines):
        fail("tools.dot_cuda: a kernel line does not equal the _int_mm yardstick")
    if min(launches.values()) < 1 or dot_max.launches != sum(launches.values()):
        fail(f"tools.dot_cuda did not launch the dot_max kernel in both modes: "
             f"{launches}")
    log(f"[dot-max] tools.dot_cuda ran {len(lines)} configs; dot_max launches "
        f"{launches}; phase 4c took {time.perf_counter() - t0:.1f} s")
    out = {}
    for mode in MODES:
        bound_ms = max(bounds[mode], bytes_ms)
        bound_by = "operations" if bounds[mode] >= bytes_ms else "bytes"
        out[mode] = {"ms": ms[f"{mode}_{best[mode]}"], "rtile": best[mode],
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": float(err), "launches": launches[mode]}
        log(f"[dot-max] {rows} x {d} int8, Q={nq}, {mode}: best rtile {best[mode]} "
            f"{out[mode]['ms']:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}; "
            f"plain {plain_ms:.1f} ms; _int_mm+amax {library_ms:.3f} ms)")
    out["ms_by_config"] = ms
    return out


# -- phase 4d: scan_topk, the exact route's int8 selection in one kernel --------

TOPK_WIDTH = 32  # the exact route's auto top-W slice, max(3k, 32) at k 10
# scan_topk before its in-test appends and pooled bounds (step 0: one
# H100 80GB HBM3 at 700 W), and top2_scan_kernel<int8> at 1M x 384, Q 512
TOPK_STEP0_MS = {"d384_q512": 2.125, "d384_q8": 0.372, "d3072_q256": 1.788}
TOP2_INT8_STEP0_MS = 0.605


def topk_rows(x, gen, dup: bool, live_share: float):
    """int8 rows of ``x`` as the indexes quantize them, their norms and a
    liveness mask; ``dup`` repeats rows exactly (score ties) on both sides
    of a 256-row tile boundary and far apart."""
    import torch

    from semcode_tpu_torch.index.flat import quantize_rows_device

    vecs, sc = quantize_rows_device(x)
    norms = (x * x).sum(dim=1)
    rows = x.shape[0]
    if dup:
        for dst, src, n in ((250, 0, 12), (rows // 2, 0, 64), (rows - 5, 300 % rows, 5)):
            n = min(n, rows - dst, rows - src)
            vecs[dst:dst + n] = vecs[src:src + n]
            sc[dst:dst + n] = sc[src:src + n]
            norms[dst:dst + n] = norms[src:src + n]
    valid = torch.rand(rows, generator=gen, device=x.device) < live_share
    return vecs, sc, valid, norms


def topk_matches(tag, got, want) -> None:
    """Scores (as bits: -0 and +0 differ) and rows equal, or fail naming the
    first query that differs."""
    import torch

    (gs, gi), (ws, wi) = got, want
    same_s = (gs.view(torch.int32) == ws.view(torch.int32)).all(dim=1)
    same_i = (gi == wi).all(dim=1)
    bad = torch.nonzero(~(same_s & same_i)).flatten()
    if bad.numel():
        q = int(bad[0])
        fail(f"scan_topk {tag}: {bad.numel()} queries differ; query {q}:\n"
             f"  kernel {gs[q, :8].tolist()} {gi[q, :8].tolist()}\n"
             f"  want   {ws[q, :8].tolist()} {wi[q, :8].tolist()}")


def time_topk(vecs, sc, valid, nrm, qq, qsc, fetch, label, step0_ms=None):
    """scan_topk at one cell's shape, held to the matrix route bit for bit:
    ms per call (CUDA events) beside its plain version, the matrix route it
    replaces (library_ms: its product, keys and radix top-k, then the
    slice), its products-and-ring build, its bound and (``step0_ms``) its
    time before the in-test appends and pooled bounds; the kernel's
    counters of one call: offer rounds that entered the append path (a
    lane's 8 rows of one query) per warp and item, and cuts per query and
    list."""
    import torch

    from semcode_tpu_torch.index.scan import _select_xla
    from semcode_tpu_torch.ops.scan_top2 import (
        scan_topk, scan_topk_counts, scan_topk_probe, scan_topk_reference, topk_geometry,
    )
    from semcode_tpu_torch.tools._timing import cuda_ms

    rows, d = vecs.shape
    nq, w = qq.shape[0], TOPK_WIDTH
    metric = "l2" if nrm is not None else "ip"
    args = (vecs, sc, valid, nrm, qq, qsc, w)
    # the matrix route's operands: the norms are read for l2 only
    matrix = (qq, qsc, vecs, nrm if nrm is not None else sc, valid, sc, "int8",
              metric, fetch, False)
    got = scan_topk(*args)
    rounds, cuts = scan_topk_counts()
    ms, mp = _select_xla(*matrix)
    topk_matches(f"{label} vs matrix route", got, (ms[:, :w], mp[:, :w]))
    err = (got[0] - ms[:, :w]).abs().max().item()
    del ms, mp
    kernel_ms = cuda_ms(lambda: scan_topk(*args), iters=20)
    library_ms = cuda_ms(lambda: _select_xla(*matrix), iters=3, warmup=1)
    plain_ms = cuda_ms(lambda: scan_topk_reference(*args), iters=2, warmup=1)
    torch.cuda.empty_cache()
    # the measurement builds: products and ring alone (a selection on zero
    # products, where every score ties, measures nothing the cells see)
    probe_ms = {"products": cuda_ms(lambda: scan_topk_probe("products", *args), iters=10)}
    n_bytes = rows * (d + 4 + 1) + nq * (d + 4) + nq * w * 12
    n_ops = 2 * nq * rows * d
    bound_ms = max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_INT8_OPS) * 1e3
    bound_by = "operations" if n_ops / PEAK_INT8_OPS >= n_bytes / PEAK_HBM_BYTES else "bytes"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geom = topk_geometry(rows, d, nq, sms, w)
    warp_items = geom.n_row_tiles * geom.n_query_pairs * 8
    log(f"[topk] {label}: scan_topk {kernel_ms:.3f} ms per call"
        + (f" (step 0 {step0_ms:.3f} ms)" if step0_ms else "")
        + f" (plain {plain_ms:.1f} ms, matrix route {library_ms:.3f} ms, bound {bound_ms:.3f} "
        f"ms by {bound_by}); grid {geom.grid} ({geom.lists} lists x {geom.n_query_pairs} "
        f"pairs), {geom.stages} stages, {geom.smem_bytes} B; products "
        f"and ring alone {probe_ms['products']:.3f} ms; append rounds {rounds} "
        f"({rounds / warp_items:.2f} a warp and item), cuts {cuts} "
        f"({cuts / (nq * geom.lists):.2f} a query and list)")
    return {"ms": kernel_ms, "step0_ms": step0_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "stages": geom.stages,
            "products_ms": probe_ms["products"], "append_rounds": rounds, "cuts": cuts,
            "append_rounds_per_warp_item": rounds / warp_items,
            "cuts_per_query_list": cuts / (nq * geom.lists)}


def exact_scan_both_routes(mesh, ops, q, fetch, label, **kw):
    """exact_scan's whole output on the kernel route against the matrix
    route (select_route forced to it), bit for bit; the counters read
    around each; the call's wall ms on each route."""
    import torch

    from semcode_tpu_torch.index import scan
    from semcode_tpu_torch.utils import tracing

    vecs, norms, valid, sc, mirror = ops

    def call():
        return scan.exact_scan(mesh, vecs, norms, valid, sc, mirror, q, 10, fetch,
                               "ip", "int8", **kw)

    def timed(n=10):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    before = tracing.snapshot()["counters"]
    got = call()
    after = tracing.snapshot()["counters"]
    kernel_calls = after.get("scan.select.kernel", 0) - before.get("scan.select.kernel", 0)
    if kernel_calls != 1 or after.get("scan.select.matrix", 0) != before.get(
            "scan.select.matrix", 0):
        fail(f"exact_scan {label} did not take the kernel route once: {after}")
    kernel_ms = timed()
    real = scan.select_route
    scan.select_route = lambda *a: "matrix"
    try:
        want = call()
        matrix_ms = timed(4)
    finally:
        scan.select_route = real
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        fail(f"exact_scan {label}: the kernel route's answers differ from the "
             "matrix route's")
    log(f"[topk] exact_scan {label}: answers equal on both routes bit for bit; "
        f"a call {kernel_ms:.3f} ms (kernel route) vs {matrix_ms:.3f} ms (matrix route)")
    return {"call_ms": kernel_ms, "matrix_call_ms": matrix_ms}


def graphed_route(mesh, ops, q, label, allow_tags=None, tags=None, route=None):
    """``ExactRoute.scan`` on phase 4d's operands (``ops``: vecs, norms,
    valid, scales, and the f32 mirror or the (residual, scales) pair):
    eager (the graph turned away) against graphed, bit for bit; each one's
    ms a call, synchronised each call; the capturing call's ms; the replay
    share of 200 calls of a new key; and the bytes of the route's graph
    pools. Pass ``route`` to add a key to a route.
    Returns (figures, route)."""
    import torch

    from semcode_tpu_torch.index import scan
    from semcode_tpu_torch.parallel.mesh import ShardedRows
    from semcode_tpu_torch.utils import tracing

    vecs, norms, valid, sc, tier = ops

    def split(t):
        return ShardedRows.of(mesh, t)

    if tags is None:
        tags = torch.zeros(vecs.shape[0], dtype=torch.int32, device=vecs.device)
    rows = scan.ExactRows(split(vecs), split(norms), split(valid), split(sc),
                          tuple(map(split, tier)) if isinstance(tier, tuple) else split(tier),
                          split(tags))
    route = route or scan.ExactRoute("ip", "int8", vecs.shape[1])

    def call():
        return route.scan(mesh, rows, q, 10, allow_tags)

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    real = scan.ExactRoute._graphed
    scan.ExactRoute._graphed = lambda *_: False
    try:
        want = call()
        eager_ms = timed(50)
    finally:
        scan.ExactRoute._graphed = real
    names = ("scan.graph.capture", "scan.graph.replay", "scan.graph.eager")
    before = tracing.snapshot()["counters"]
    got = [call() for _ in range(scan.SCAN_CAPTURE_CALLS - 1)]  # eager, the key's first
    capture_ms = timed(1)
    got += [call()]
    graph_ms = timed(199 - scan.SCAN_CAPTURE_CALLS)
    after = tracing.snapshot()["counters"]
    cap, rep, eag = (after.get(n, 0) - before.get(n, 0) for n in names)
    share = rep / max(cap + rep + eag, 1)
    for g in got + [call()]:
        if not (torch.equal(g[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(g[1], want[1])):
            fail(f"ExactRoute.scan {label}: the graphed answers differ from the eager ones")
    if (cap, eag) != (1, scan.SCAN_CAPTURE_CALLS - 1):
        fail(f"ExactRoute.scan {label}: {cap} captures and {eag} eager calls in 200")
    pool_bytes = sum(e.bytes for e in route._graphs.graphs.values())
    log(f"[topk] ExactRoute.scan {label}: graphed answers equal the eager ones bit for "
        f"bit; a call {eager_ms:.3f} ms eager vs {graph_ms:.3f} ms graphed, the capturing "
        f"call {capture_ms:.2f} ms; hit share {share:.3f} over 200 calls ({cap} capture, "
        f"{rep} replays, {eag} eager); the graph pools of the route's "
        f"{len(route._graphs.graphs)} key(s) {pool_bytes / 2**20:.1f} MiB")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms, "capture_ms": capture_ms,
            "hit_share": share, "pool_bytes": pool_bytes}, route


def topk_phase():
    """Phase 4d: scan_topk against the matrix route at the cells' shapes
    (1M x 384 at Q 512 and Q 8, 1M x 3072 at Q 256, w 32; a tag-filtered,
    an l2 and a tied case), exact_scan's whole output on both routes, and
    the timings. Its tile-edge cases are tests/test_torch_cuda.py's."""
    import gc

    import torch

    from semcode_tpu_torch.index.flat import quantize_residual_device
    from semcode_tpu_torch.index.scan import quantize_queries_device
    from semcode_tpu_torch.ops.scan_top2 import (
        NEG, scan_topk, scan_topk_attributes, top2_scan, top2_scan_reference,
    )
    from semcode_tpu_torch.parallel.mesh import make_mesh
    from semcode_tpu_torch.tools._timing import cuda_ms
    from semcode_tpu_torch.tools._corpus import (
        mixture, mixture_centers, mixture_chunk, queries_near,
    )

    regs, local = scan_topk_attributes()
    log(f"[topk] scan_topk_s8: {regs} registers a thread, {local} B of local memory")
    launches0 = scan_topk.launches
    mesh = make_mesh((1,), ("data",), devices=["cuda"])
    out = {"registers": regs, "local_bytes": local}
    gen = torch.Generator(device="cuda").manual_seed(42)

    # 1M x 384, the d384 cells' corpus: f32 mirror, fetch 128
    x = mixture(gen, N_ROWS, DIM)
    q = queries_near(gen, x, BATCH)
    vecs, sc, valid, norms = topk_rows(x, gen, False, 1.0)
    qq, qsc = quantize_queries_device(q)
    out["d384_q512"] = time_topk(vecs, sc, valid, None, qq, qsc, 128,
                                 f"{N_ROWS} x {DIM} Q={BATCH}", TOPK_STEP0_MS["d384_q512"])
    out["d384_q8"] = time_topk(vecs, sc, valid, None, qq[:SERVE_BATCH],
                               qsc[:SERVE_BATCH], 128, f"{N_ROWS} x {DIM} Q={SERVE_BATCH}",
                               TOPK_STEP0_MS["d384_q8"])
    # top2_scan_kernel<int8> on the same rows and queries: its stream is
    # scan_topk's, its code and answers stay as they were
    add = torch.where(valid, 0.0, NEG).float()
    top2_args = (vecs, sc, add, qq, qsc)
    bm, br = top2_scan(*top2_args)
    rm, rr = top2_scan_reference(*top2_args)
    if not (torch.equal(bm, rm) and torch.equal(br, rr)):
        fail("top2_scan int8 differs from its plain version at the scan_topk shape")
    del bm, br, rm, rr
    top2_ms = cuda_ms(lambda: top2_scan(*top2_args), iters=20)
    log(f"[topk] top2_scan_kernel<int8> {N_ROWS} x {DIM} Q={BATCH}: {top2_ms:.3f} ms per "
        f"call (step 0 {TOP2_INT8_STEP0_MS:.3f} ms), answers equal to its plain version")
    out["top2_int8_ms"] = top2_ms
    del add, top2_args
    # the tag-filtered (1% of rows allowed), l2 and tied cases at full size
    tags = (torch.arange(N_ROWS, device="cuda") % 100 == 0).to(torch.int32)
    time_topk(vecs, sc, valid & (tags == 1), None, qq, qsc, 128,
              f"{N_ROWS} x {DIM} Q={BATCH}, 1% of rows allowed")
    time_topk(vecs, sc, valid, norms, qq, qsc, 128, f"{N_ROWS} x {DIM} Q={BATCH} l2")
    tv, tsc, tvalid, _ = topk_rows(x, gen, True, 0.95)
    time_topk(tv, tsc, tvalid, None, qq, qsc, 128,
              f"{N_ROWS} x {DIM} Q={BATCH}, duplicated rows")
    del tv, tsc, tvalid
    ops = (vecs, norms, valid, sc, x)
    out["exact_d384_q512"] = exact_scan_both_routes(mesh, ops, q, 128, f"{N_ROWS} x {DIM} "
                                                    f"Q={BATCH}, f32 mirror",
                                                    rescore_width=TOPK_WIDTH)
    out["exact_d384_q8"] = exact_scan_both_routes(mesh, ops, q[:SERVE_BATCH], 128,
                                                  f"{N_ROWS} x {DIM} Q={SERVE_BATCH}",
                                                  rescore_width=TOPK_WIDTH)
    exact_scan_both_routes(mesh, ops, q, 128, f"{N_ROWS} x {DIM} Q={BATCH}, tag 1 (1%)",
                           rescore_width=TOPK_WIDTH, tags=tags,
                           allow=torch.tensor([1], dtype=torch.int32, device="cuda"))
    out["graph_d384_q512"], route = graphed_route(mesh, ops, q,
                                                  f"{N_ROWS} x {DIM} Q={BATCH}")
    out["graph_d384_q8"], _ = graphed_route(mesh, ops, q[:SERVE_BATCH],
                                            f"{N_ROWS} x {DIM} Q={SERVE_BATCH}", route=route)
    graphed_route(mesh, ops, q, f"{N_ROWS} x {DIM} Q={BATCH}, tag 1 (1%)",
                  allow_tags=[1], tags=tags)
    del route
    del x, q, vecs, sc, valid, norms, qq, qsc, ops, tags
    gc.collect()
    torch.cuda.empty_cache()

    # 1M x 3072, the d3072 bulk cell's corpus: residual rescore, fetch 96
    d, nq, chunks = 3072, 256, 4
    centers = mixture_centers(gen, N_ROWS // 1000, d)
    parts = [], [], [], [], []
    for i in range(chunks):
        xc = mixture_chunk(3072, i, centers, N_ROWS // chunks)
        v, s, ok, nr = topk_rows(xc, gen, i == 0, 1.0)
        r, rs = quantize_residual_device(xc, v, s)
        for dst, t in zip(parts, (v, s, nr, r, rs)):
            dst.append(t)
        if i == 0:
            q = queries_near(gen, xc, nq)
        del xc
    vecs, sc, norms, resid, rscl = (torch.cat(p) for p in parts)
    del parts
    valid = torch.ones(N_ROWS, dtype=torch.bool, device="cuda")
    qq, qsc = quantize_queries_device(q)
    out["d3072_q256"] = time_topk(vecs, sc, valid, None, qq, qsc, 96,
                                  f"{N_ROWS} x {d} Q={nq}", TOPK_STEP0_MS["d3072_q256"])
    out["exact_d3072_q256"] = exact_scan_both_routes(
        mesh, (vecs, norms, valid, sc, None), q, 96,
        f"{N_ROWS} x {d} Q={nq}, residual rescore", rescore_width=TOPK_WIDTH,
        resid=resid, rscales=rscl)
    out["graph_d3072_q256"], _ = graphed_route(
        mesh, (vecs, norms, valid, sc, (resid, rscl)), q,
        f"{N_ROWS} x {d} Q={nq}, residual rescore")
    # the launches of this phase's own calls; the main path's are phase 4b's
    out["smoke_launches"] = scan_topk.launches - launches0
    del vecs, sc, norms, resid, rscl, valid, q, qq, qsc
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 4b: IVF at scale ------------------------------------------------------


def timed_search(search, q, iters: int = 20):
    """(QPS at the batch of ``q``, p50 ms at batch 8) of ``search(q)``."""
    import torch

    search(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        search(q)
    torch.cuda.synchronize()
    qps = q.shape[0] * iters / (time.perf_counter() - t0)
    lat = []
    for i in range(50):
        qb = q[(i * SERVE_BATCH) % q.shape[0]:][:SERVE_BATCH]
        t0 = time.perf_counter()
        search(qb)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return qps, statistics.median(lat)


def ivf_library(data, ids, scales, qq, qsc, probing, k):
    """One PyTorch computation of the kernel's selection: cuBLASLt int8 GEMM
    of the queries against the probed union's rows (in slabs of 128
    clusters), the epilogue, the probe/slot mask and a running topk."""
    import torch

    from semcode_tpu_torch.ops.ivf_scan import NEG

    nlist, cmax, d = data.shape
    union = torch.nonzero(probing.any(dim=0)).flatten()
    best_s = torch.full((qq.shape[0], k), NEG, device="cuda")
    best_i = torch.full((qq.shape[0], k), -1, dtype=torch.int32, device="cuda")
    for lo in range(0, union.numel(), 128):
        cl = union[lo:lo + 128]
        raw = torch._int_mm(qq, data[cl].reshape(-1, d).T).float()
        s = raw * qsc[:, None] * scales[cl].reshape(1, -1)
        blk_ids = ids[cl].reshape(1, -1)
        ok = (blk_ids >= 0) & probing[:, cl].repeat_interleave(cmax, dim=1)
        s = torch.where(ok, s, NEG)
        best_s, pos = torch.topk(torch.cat([best_s, s], dim=1), k, dim=1)
        best_i = torch.gather(
            torch.cat([best_i, blk_ids.expand(qq.shape[0], -1)], dim=1), 1, pos)
    return best_s, best_i


def scan_phase_shares(args, storage):
    """(each phase's share of the consumer warps' cycles, the share of its
    time the TMA producer waits for a free stage) in ivf_scan's phase build
    (clock64 counters in csrc/ivf_scan.cu), over three calls on ``args``."""
    import torch

    from semcode_tpu_torch.ops.ivf_scan import PHASE_NAMES, ivf_scan_probe, scan_phases

    scan_phases(storage)  # clears
    for _ in range(3):
        ivf_scan_probe("phases", *args)
    torch.cuda.synchronize()
    ph = scan_phases(storage)
    shares = {name: ph[name] / max(ph["consumer total"], 1) for name in PHASE_NAMES[:6]}
    return shares, ph["producer waiting"] / max(ph["producer total"], 1)


def phase_line(shares, producer_wait) -> str:
    return (", ".join(f"{name} {100 * v:.1f}%" for name, v in shares.items())
            + f"; the TMA producer waits for a free stage {100 * producer_wait:.1f}% "
            "of its time")


def ivf_scale_phase():
    import gc

    import numpy as np
    import torch

    from semcode_tpu_torch.device import f32_matmul
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.index.scan import quantize_queries_device, stable_topk
    from semcode_tpu_torch.ops.ivf_scan import (
        ivf_prep, ivf_scan, ivf_scan_probe, ivf_scan_reference,
    )
    from semcode_tpu_torch.ops.scan_top2 import scan_topk
    from semcode_tpu_torch.tools._corpus import mixture, oracle_topk, queries_near
    from semcode_tpu_torch.tools._timing import cuda_ms
    from semcode_tpu_torch.utils import tracing

    gc.collect()
    torch.cuda.empty_cache()  # phase 4's flat index is gone
    gen = torch.Generator(device="cuda").manual_seed(42)  # phase 4's corpus
    x = mixture(gen, N_ROWS, DIM)
    q = queries_near(gen, x, BATCH)
    truth = oracle_topk(x, q, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = IVFIndex(DIM, nlist=NLIST, nprobe=32, metric="ip", dtype="int8",
                     kmeans_iters=KMEANS_ITERS, device="cuda")
    with index.bulk(expected_rows=N_ROWS):
        for lo in range(0, N_ROWS, 131072):
            index.add(x[lo:lo + 131072])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = shard0(index._ensure_device())
    log(f"[ivf-scale] {N_ROWS} x {DIM} int8 IVF (nlist {NLIST}, "
        f"{KMEANS_ITERS} k-means iterations) + f32 mirror built in "
        f"{build_s:.1f} s: cmax {index.cmax}, rescore "
        f"{'on' if index.device_rescore_active else 'off'}")

    # the build repeats: a second k-means on the same training sample must
    # give the same centroids, bit for bit
    built = index.centroids
    index.train()
    if not np.array_equal(index.centroids, built):
        fail("a second k-means on the same sample gave other centroids")
    index.centroids = built
    log("[ivf-scale] a second k-means on the same sample reproduces the "
        "centroids bit for bit")
    out = {"build_s": build_s, "cmax": index.cmax}

    def searcher(nprobe):
        return lambda qb: index.search_device(qb, 10, nprobe=nprobe, mode="ivf")

    # timings in turns (32, 16, 16, 32): one machine's host noise must not
    # decide which width reads faster
    for nprobe in (32, 16, 16, 32):
        qps, p50 = timed_search(searcher(nprobe), q)
        rec = out.setdefault(f"nprobe{nprobe}", {"qps": [], "p50_b8_ms": []})
        rec["qps"].append(qps)
        rec["p50_b8_ms"].append(p50)
    for nprobe in (32, 16):
        _, ids = searcher(nprobe)(q)
        rec = out[f"nprobe{nprobe}"]
        rec["recall"] = recall_at_10(ids, truth)
        log(f"[ivf-scale] nprobe {nprobe}: recall@10 {rec['recall']:.4f}  "
            f"QPS@{BATCH} " + " / ".join(f"{v:.0f}" for v in rec["qps"])
            + f"  p50@{SERVE_BATCH} "
            + " / ".join(f"{v:.2f}" for v in rec["p50_b8_ms"]) + " ms")
        # the same layout through the reference's gather-scan route
        index.use_pallas = "never"
        s_g, ids_g = searcher(nprobe)(q)
        index.use_pallas = "auto"
        if not untied_ids_equal(s_g, ids_g, ids, 1e-5):
            fail(f"IVF nprobe {nprobe}: kernel route and gather-scan route "
                 "disagree at untied positions")
    if out["nprobe32"]["recall"] < 0.95:
        fail(f"IVF recall@10 {out['nprobe32']['recall']:.4f} < 0.95 at nprobe 32")
    log("[ivf-scale] kernel-route ids equal the gather-scan route's at "
        "nprobe 32 and 16 (untied positions)")

    # the cost model at batch 8 / nprobe 8, through the default mode
    mode = index._pick_mode(SERVE_BATCH, 8, 10)
    ivf_scan.launches = 0
    index.search(q[:SERVE_BATCH].cpu().numpy(), k=10, nprobe=8)
    launches = ivf_scan.launches
    log(f"[ivf-scale] mode='auto' at batch {SERVE_BATCH}, nprobe 8 picks "
        f"{mode!r}; ivf_scan launches {launches}")
    if mode != "ivf" or launches < 1:
        fail("the auto-mode batch-8 search did not probe through the kernel")
    out["auto_mode_b8"] = mode
    # the bulk cells' main path: auto mode at batch BATCH takes the exact
    # route, whose int8 selection is scan_topk (its launches counted from 0)
    mode = index._pick_mode(BATCH, index.nprobe, 10)
    scan_topk.launches = 0
    replays = tracing.snapshot()["counters"].get("scan.graph.replay", 0)
    index.search_device(q, 10)
    torch.cuda.synchronize()
    out["topk_launches"] = scan_topk.launches
    log(f"[ivf-scale] mode='auto' at batch {BATCH}, nprobe {index.nprobe} picks "
        f"{mode!r}; scan_topk launches {out['topk_launches']}")
    if tracing.snapshot()["counters"].get("scan.graph.replay", 0) != replays:
        fail("the counted batch-512 search replayed a graph, which the kernel's "
             "launch counter does not see")
    if mode != "exact" or out["topk_launches"] < 1:
        fail("the auto-mode batch-512 search did not select through scan_topk")
    out["breakdown"] = device_breakdown(
        lambda: index.search_device(q, 10, nprobe=32, mode="ivf"),
        f"batch-{BATCH} IVF probe search (nprobe 32)",
    )

    # the kernel at the main path's shape: the probes _ivf_search picks and
    # the scan width it asks for (max(4k, 64) with the rescore mirror)
    _, probes = stable_topk(f32_matmul(q, dev.centroids.T), 32)
    args = (dev.data, dev.ids, q, probes, 64, dev.scales)
    calls = ivf_scan.launches
    call_ms = cuda_ms(lambda: ivf_scan(*args), iters=20)
    parts = kernel_device_ms(lambda: ivf_scan(*args),
                             ("ivf_prep", "ivf_scatter", "ivf_scan_s8", "ivf_merge"))
    probe_ms = {kind: kernel_device_ms(lambda: ivf_scan_probe(kind, *args),
                                       ("ivf_scan_s8",))["ivf_scan_s8"]
                for kind in ("products", "selection")}
    phases, producer_wait = scan_phase_shares(args, torch.int8)
    s, i = ivf_scan(*args)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: ivf_scan_reference(*args), iters=2, warmup=1)
    rs, ri = ivf_scan_reference(*args)
    if not torch.equal(s, rs) or not torch.equal(i, ri):
        fail("ivf_scan differs from its plain version at the main-path shape")
    err = (s - rs).abs().max().item()
    # the work this call's probes give: pairs, tiles, probed clusters and
    # the chunks the scan streams of each
    _, pair_at, tiles, nchunk = ivf_prep(probes, NLIST, ids=dev.ids)
    per_cluster = torch.zeros(NLIST, dtype=torch.int64, device="cuda")
    per_cluster.index_add_(0, tiles[:, 0].long(), tiles[:, 2].long())
    n_pairs, n_tiles = pair_at.numel(), tiles.shape[0]
    probed = per_cluster > 0
    n_union = int(probed.sum())
    most = int(per_cluster.max())
    qq, qsc = quantize_queries_device(q)
    probing = torch.zeros((BATCH, NLIST), dtype=torch.bool, device="cuda")
    probing.scatter_(1, probes, True)
    library_ms = cuda_ms(
        lambda: ivf_library(dev.data, dev.ids, dev.scales, qq, qsc, probing, 64),
        iters=3, warmup=1,
    )
    cmax = index.cmax
    # the bytes the function must move: the id of every slot of the probed
    # clusters, the row and scale of every valid one, the queries, probes
    # and output; its useful products: each pair against its cluster's
    # valid rows
    valid = (dev.ids >= 0).sum(dim=1)
    n_valid = int(valid[probed].sum())
    n_bytes = (n_union * cmax * 4 + n_valid * (DIM + 4) + q.numel() * 4
               + probes.numel() * probes.element_size() + BATCH * 64 * 8)
    n_ops = 2 * DIM * int((per_cluster * valid).sum())
    bound_ms = max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_INT8_OPS) * 1e3
    bound_by = "operations" if n_ops / PEAK_INT8_OPS >= n_bytes / PEAK_HBM_BYTES else "bytes"
    # what the scan streams: each tile's cluster up to its last valid chunk
    streamed = int(nchunk[tiles[:, 0].long()].sum()) * 128 * (DIM + 8)
    kernel_ms = parts["ivf_scan_s8"]
    log(f"[ivf-scale] ivf_scan Q={BATCH} nprobe 32 k 64: {n_pairs} pairs in "
        f"{n_tiles} tiles over {n_union} probed clusters (cmax {cmax}, "
        f"{n_valid} valid slots, fill {n_valid / (n_union * cmax):.4f}; the most "
        f"probers of one cluster {most}); bound {bound_ms:.3f} ms by {bound_by} "
        f"({n_bytes / 1e9:.3f} GB, {n_ops:.3g} ops); the scan streams "
        f"{streamed / 1e9:.3f} GB (each cluster to its last valid chunk)")
    log(f"[ivf-scale] whole call {call_ms:.3f} ms (CUDA events); kernels "
        f"(profiler): scan {kernel_ms:.3f} ms, prep {parts['ivf_prep']:.4f}, "
        f"scatter {parts['ivf_scatter']:.4f}, merge {parts['ivf_merge']:.4f} ms; "
        f"scan measurement builds: products alone {probe_ms['products']:.3f} ms, "
        f"selection alone {probe_ms['selection']:.3f} ms; plain {plain_ms:.1f} ms, "
        f"_int_mm+mask+topk {library_ms:.3f} ms; {ivf_scan.launches - calls} "
        "timing launches")
    log("[ivf-scale] int8 scan phases (consumer warps' cycles): "
        + phase_line(phases, producer_wait))
    out["kernel"] = {"ms": call_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err,
                     "launches": launches, "union": n_union, "pairs": n_pairs,
                     "tiles": n_tiles, "most_probers": most,
                     "bound_gb": n_bytes / 1e9, "streamed_gb": streamed / 1e9,
                     "prep_ms": parts["ivf_prep"], "scatter_ms": parts["ivf_scatter"],
                     "merge_ms": parts["ivf_merge"],
                     "products_ms": probe_ms["products"],
                     "selection_ms": probe_ms["selection"],
                     "phases": phases, "producer_wait": producer_wait}
    del index, dev, args
    for storage in ("bfloat16", "float32"):
        out[storage] = ivf_float_leg(storage, x, q, truth)
    return out


def ivf_library_float(data, ids, q, probing, k):
    """One PyTorch computation of the bf16/f32 scan's selection: the f32
    GEMM (TF32 off) of the f32 queries against the probed union's rows (in
    slabs of 128 clusters), the probe/slot mask and a running topk."""
    import torch

    from semcode_tpu_torch.device import f32_matmul
    from semcode_tpu_torch.ops.ivf_scan import NEG

    nlist, cmax, d = data.shape
    union = torch.nonzero(probing.any(dim=0)).flatten()
    best_s = torch.full((q.shape[0], k), NEG, device="cuda")
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device="cuda")
    for lo in range(0, union.numel(), 128):
        cl = union[lo:lo + 128]
        s = f32_matmul(q, data[cl].reshape(-1, d).float().T)
        blk_ids = ids[cl].reshape(1, -1)
        ok = (blk_ids >= 0) & probing[:, cl].repeat_interleave(cmax, dim=1)
        s = torch.where(ok, s, NEG)
        best_s, pos = torch.topk(torch.cat([best_s, s], dim=1), k, dim=1)
        best_i = torch.gather(
            torch.cat([best_i, blk_ids.expand(q.shape[0], -1)], dim=1), 1, pos)
    return best_s, best_i


def ivf_float_leg(storage, x, q, truth):
    """Phase 4b over bf16 or f32 storage: the same rows in an IVFIndex of
    that dtype (nlist 1024); one probe search at nprobe 32 (ivf_scan's
    launches read around it) and a profile of it (device busy share), then
    the bf16/f32 scan's call at Q=512, nprobe 32, k 64 and the scan kernel
    alone, its two measurement builds (products alone, selection alone) and
    its registers and spills, beside its bound, plain version and library."""
    import gc

    import torch

    from semcode_tpu_torch.device import f32_matmul
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.index.scan import stable_topk
    from semcode_tpu_torch.ops.ivf_scan import (
        ivf_scan, ivf_scan_probe, ivf_scan_reference, scan_attributes,
    )
    from semcode_tpu_torch.tools._timing import cuda_ms

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index = IVFIndex(DIM, nlist=NLIST, nprobe=32, metric="ip", dtype=storage,
                     kmeans_iters=KMEANS_ITERS, device="cuda")
    with index.bulk(expected_rows=N_ROWS):
        for lo in range(0, N_ROWS, 131072):
            index.add(x[lo:lo + 131072])
    dev = shard0(index._ensure_device())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ivf_scan.launches = 0
    _, ids = index.search_device(q, 10, nprobe=32, mode="ivf")
    launches = ivf_scan.launches
    rec = recall_at_10(ids, truth)
    if launches < 1:
        fail(f"the {storage} IVF probe search never launched the ivf_scan kernel")
    if rec < 0.95:
        fail(f"{storage} IVF recall@10 {rec:.4f} < 0.95 at nprobe 32")
    search = device_breakdown(
        lambda: index.search_device(q, 10, nprobe=32, mode="ivf"),
        f"batch-{BATCH} {storage} IVF probe search (nprobe 32)",
    )

    _, probes = stable_topk(f32_matmul(q, dev.centroids.T), 32)
    args = (dev.data, dev.ids, q, probes, 64, dev.scales)
    name = "ivf_scan_bf16" if storage == "bfloat16" else "ivf_scan_f32"
    call_ms = cuda_ms(lambda: ivf_scan(*args), iters=20)
    scan_ms = kernel_device_ms(lambda: ivf_scan(*args), (name,))[name]
    probe_ms = {kind: kernel_device_ms(lambda: ivf_scan_probe(kind, *args), (name,))[name]
                for kind in ("products", "selection")}
    regs, spill = scan_attributes(dev.data.dtype)
    phases, producer_wait = scan_phase_shares(args, dev.data.dtype)
    s, i = ivf_scan(*args)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: ivf_scan_reference(*args), iters=2, warmup=1)
    rs, ri = ivf_scan_reference(*args)
    err = (s - rs).abs().max().item()
    if not torch.allclose(s, rs, rtol=1e-5, atol=1e-6):
        fail(f"ivf_scan {storage} at the main-path shape: scores off by {err}")
    if not untied_ids_equal(rs, ri, i, 1e-5):
        fail(f"ivf_scan {storage} at the main-path shape: ids differ at untied "
             "positions")
    del s, i, rs, ri
    probing = torch.zeros((BATCH, NLIST), dtype=torch.bool, device="cuda")
    probing.scatter_(1, probes, True)
    library_ms = cuda_ms(
        lambda: ivf_library_float(dev.data, dev.ids, q, probing, 64),
        iters=3, warmup=1,
    )
    # the bytes the function must move (as for int8: every slot's id in the
    # probed clusters, every valid slot's row, queries, probes, output) and
    # its useful f32 products at the card's f32 rate
    per_cluster = torch.zeros(NLIST, dtype=torch.int64, device="cuda")
    per_cluster.index_add_(0, probes.flatten().long(),
                           torch.ones(probes.numel(), dtype=torch.int64, device="cuda"))
    probed = per_cluster > 0
    valid = (dev.ids >= 0).sum(dim=1)
    n_union = int(probed.sum())
    n_valid = int(valid[probed].sum())
    n_bytes = (n_union * index.cmax * 4 + n_valid * DIM * dev.data.element_size()
               + q.numel() * 4 + probes.numel() * probes.element_size()
               + BATCH * 64 * 8)
    n_ops = 2 * DIM * int((per_cluster * valid).sum())
    bound_ms = max(n_bytes / PEAK_HBM_BYTES, n_ops / PEAK_F32_OPS) * 1e3
    bound_by = "operations" if n_ops / PEAK_F32_OPS >= n_bytes / PEAK_HBM_BYTES else "bytes"
    log(f"[ivf-scale] {storage} IVF (built in {build_s:.1f} s, cmax {index.cmax}): "
        f"nprobe 32 recall@10 {rec:.4f}, ivf_scan launches {launches}; call at "
        f"Q={BATCH} nprobe 32 k 64: {call_ms:.3f} ms (CUDA events), scan kernel "
        f"{name} {scan_ms:.3f} ms (profiler; products alone "
        f"{probe_ms['products']:.3f}, selection alone {probe_ms['selection']:.3f}; "
        f"{regs} registers, {spill} B local a thread); bound {bound_ms:.3f} ms by "
        f"{bound_by} ({n_bytes / 1e9:.3f} GB, {n_ops:.3g} f32 ops); plain "
        f"{plain_ms:.1f} ms, f32 GEMM+mask+topk {library_ms:.3f} ms")
    log(f"[ivf-scale] {storage} scan phases (consumer warps' cycles): "
        + phase_line(phases, producer_wait))
    return {"recall": rec, "launches": launches, "build_s": build_s,
            "search": search,
            "kernel": {"ms": call_ms, "kernel_ms": scan_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err,
                       "products_ms": probe_ms["products"],
                       "selection_ms": probe_ms["selection"],
                       "registers": regs, "local_bytes": spill,
                       "phases": phases, "producer_wait": producer_wait}}


# -- phase 9: the row-sharded engine on the one card ------------------------------

SHARDS = 4  # shards of phase 9's mesh, all on the one card
DCN_TIMEOUT_S = 300  # each 9d worker: start, self-ingest, 102 questions
SPLIT_TIMEOUT_S = 420  # each 9e worker: start, 1M flat and IVF builds, searches
# what the JAX package replicates on every device too: IVF's centroids and
# its pending tail; every other tensor of an index is split by shard
REPLICATED = ("centroids", "_pend")
# memory_allocated() growth an index build may show beyond its own tensors:
# allocator rounding and a library workspace, far below one global copy
# (phase 9b's int8 rows alone are 0.38 GB)
MEM_SLACK = 64 << 20


def shard0(state):
    """A one-shard index's device state as plain tensors: shard 0 of each
    ShardedRows (which then holds every row); replicated tensors as they
    are."""
    from semcode_tpu_torch.parallel.mesh import ShardedRows

    if isinstance(state, ShardedRows):
        if list(state.parts) != [0] or state.shard_rows != state.rows:
            fail(f"{state} is not a one-shard container")
        return state.shard(0)
    if isinstance(state, tuple):
        parts = [shard0(t) for t in state]
        return type(state)(*parts) if hasattr(state, "_fields") else tuple(parts)
    return state


def index_layout(index, label: str) -> dict:
    """The per-shard layout of 9b, 9c and 9e: every tensor ``index`` holds
    is one shard's tensor of a ShardedRows, for exactly this process's
    shards, on that shard's mesh device, with ``shard_rows`` rows
    (``nlist_s`` clusters for the IVF layout); the only other tensors are
    the replicated ones. Returns the bytes held, each storage once (the IVF
    snapshot shares the mirror's tensors)."""
    import torch

    from semcode_tpu_torch.parallel.mesh import ShardedRows, local_shards

    shards = local_shards(index.mesh)
    held = {}
    rows = {}

    def walk(obj, path):
        if isinstance(obj, ShardedRows):
            if list(obj.parts) != [r for r, _ in shards]:
                fail(f"{label}: {path} holds shards {sorted(obj.parts)}, this "
                     f"process owns {[r for r, _ in shards]}")
            for r, dev in shards:
                t = obj.shard(r)
                if t.device != dev or t.shape[0] != obj.shard_rows:
                    fail(f"{label}: {path} shard {r} is {tuple(t.shape)} on "
                         f"{t.device}, not {obj.shard_rows} rows on {dev}")
                st = t.untyped_storage()
                held.setdefault(st.data_ptr(), ("sharded", st.nbytes()))
            rows[path.split(".")[-1]] = obj.shard_rows
        elif isinstance(obj, torch.Tensor):
            if not any(name in path.split(".") for name in REPLICATED):
                fail(f"{label}: {path} {tuple(obj.shape)} is a tensor outside "
                     "the shards")
            st = obj.untyped_storage()
            held.setdefault(st.data_ptr(), ("replicated", st.nbytes()))
        elif isinstance(obj, (tuple, list)):
            names = getattr(obj, "_fields", None)
            for i, v in enumerate(obj):
                walk(v, f"{path}.{names[i] if names else i}")

    for name, value in vars(index).items():
        walk(value, name)
    sharded = sum(b for kind, b in held.values() if kind == "sharded")
    replicated = sum(b for kind, b in held.values() if kind == "replicated")
    if not sharded:
        fail(f"{label}: the index holds no per-shard tensors")
    return {"bytes": sharded + replicated, "sharded_bytes": sharded,
            "replicated_bytes": replicated, "shard_rows": rows,
            "shards": [r for r, _ in shards]}


def memory_check(grown: int, layout: dict, label: str) -> None:
    """The build's memory_allocated() growth holds the index's own tensors
    and nothing more: no global copy beside the shards."""
    log(f"[shard] {label}: memory_allocated() grew {grown / 2**30:.3f} GiB in "
        f"the build; the index holds {layout['bytes'] / 2**30:.3f} GiB "
        f"({layout['sharded_bytes'] / 2**30:.3f} in shards {layout['shards']}, "
        f"{layout['replicated_bytes'] / 2**20:.1f} MiB replicated); "
        f"shard rows {layout['shard_rows']}")
    if grown > layout["bytes"] + MEM_SLACK:
        fail(f"{label}: the build grew memory by {grown} B, more than the "
             f"index's {layout['bytes']} B of tensors")


def shard_mesh(n: int = SHARDS, device: str = "cuda:0"):
    """A 1-D mesh of ``n`` shards on one device: the counterpart of XLA's
    forced host device count, here on the card."""
    from semcode_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((n,), ("data",), devices=[device] * n)


def sharded_ingest(workdir: Path, device: str, mesh, tag: str, **extra):
    """Phase 3's self-ingest (int8 rows, kernel route, fallback answers)
    into a store on ``mesh``; returns (config, result, service, pipeline)."""
    from semcode_tpu_torch.index.store import VectorStore
    from semcode_tpu_torch.rag import SemanticSearchPipeline
    from semcode_tpu_torch.services import IndexerService
    from semcode_tpu_torch.settings import AppSettings

    cfg = AppSettings(workspace_root=workdir / f"sharded-{tag}", index_kind="flat",
                      index_scan_impl="pallas", rag_provider="fallback",
                      rag_query_cache_size=0, **extra)
    store = VectorStore(cfg, mesh=mesh)
    svc = IndexerService(config=cfg, vector_store=store, device=device)
    res = svc.index_repository([ROOT / "semcode_tpu"], "semcode_tpu")
    pipe = SemanticSearchPipeline(config=cfg, vector_store=store,
                                  embeddings=svc.embeddings, device=device)
    return cfg, res, svc, pipe


def result_paths(results):
    return [[s["path"] for s in r["sources"]] for r in results]


def sharded_store_phase(workdir: Path, mrr_one_shard: float):
    """9a: phase 3's self-ingest into a 4-shard int8 kernel-route store on
    the card; the 102 frozen questions through query_batch (top2_scan
    launches read around the batch: at least one per shard), every top-10
    equal to the same engine's on a 4-shard CPU mesh (plain versions); 16 of
    the questions through create_app's POST /query with the store
    injected, each answer equal to the in-process one."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from semcode_tpu_torch.api.main import create_app
    from semcode_tpu_torch.ops.scan_top2 import top2_scan

    queries = frozen_queries()
    questions = [q for q, _ in queries]
    labels = [rel for _, rel in queries]
    cfg, res, svc, pipe = sharded_ingest(workdir, "cuda", shard_mesh(), "cuda")
    index = svc.vector_store._index
    if index.n_shards != SHARDS or index.mesh.home.type != "cuda":
        fail(f"the phase 9a store is not on {SHARDS} shards of the card")
    top2_scan.launches = 0
    t0 = time.perf_counter()
    results = pipe.query_batch(questions, top_k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = top2_scan.launches
    if launches < SHARDS:
        fail(f"the 4-shard batch launched top2_scan {launches} times, fewer than "
             "one per shard")
    mrr, recall = rank_metrics(results, labels)
    paths = result_paths(results)
    if not all(paths):
        fail("a frozen question has no hits on the 4-shard store")
    shard_rows = index.capacity // SHARDS
    log(f"[shard] 9a: {res.chunk_count} chunks over {SHARDS} shards of "
        f"{shard_rows} rows on one card; 102 questions in {batch_ms:.1f} ms; "
        f"top2_scan launches {launches}; MRR@10 {mrr:.4f} recall@10 {recall:.4f} "
        f"(one shard, phase 3: MRR@10 {mrr_one_shard:.4f}; the kernel route "
        "keeps 2 rows a 128-row block of each shard)")

    from semcode_tpu_torch.parallel.mesh import make_mesh

    _, _, _, pipe_cpu = sharded_ingest(
        workdir, "cpu", make_mesh((SHARDS,), ("data",), devices=["cpu"] * SHARDS),
        "cpu")
    cpu_paths = result_paths(pipe_cpu.query_batch(questions, top_k=10))
    for qtext, got, want in zip(questions, paths, cpu_paths):
        if got != want:
            fail(f"the 4-shard card store and the 4-shard CPU engine disagree "
                 f"on {qtext!r}:\n{got}\n{want}")
    log("[shard] 9a: all 102 top-10 paths equal the 4-shard CPU engine's")

    app = create_app(config=cfg, indexer=svc, pipeline=pipe)
    served = questions[:16]

    async def serve():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for question in served:
                r = await client.post("/query", json={"question": question,
                                                      "top_k": 10})
                if r.status != 200:
                    fail(f"/query answered {r.status}: {await r.text()}")
                out.append(await r.json())
            return out
        finally:
            await client.close()

    top2_scan.launches = 0
    answers = asyncio.run(serve())
    http_launches = top2_scan.launches
    if result_paths(answers) != paths[:16]:
        fail("the 4-shard store's /query answers differ from query_batch's")
    if http_launches < SHARDS:
        fail(f"/query on the 4-shard store launched top2_scan {http_launches} "
             "times")
    log(f"[shard] 9a: 16 questions through POST /query equal the in-process "
        f"answers; top2_scan launches {http_launches}")
    return {"launches": launches, "http_launches": http_launches, "mrr": mrr,
            "recall": recall, "mrr_one_shard": mrr_one_shard,
            "chunks": res.chunk_count, "shards": index.n_shards,
            "shard_rows": shard_rows, "batch_ms": batch_ms, "paths": paths}


def sharded_scale_phase(one_shard: dict):
    """9b: phase 4's 1M x 384 int8 FlatIndex with its f32 mirror over 4
    shards of the card: recall@10 against the f32 oracle, batch-512 and
    batch-8 search times, launches and the device-busy share beside phase
    4's one-shard figures; one shard's top2_scan at its own rows (a range
    that starts off the 128-row grid) against its plain version."""
    import gc

    import torch

    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.scan import quantize_queries_device
    from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan, top2_scan_reference
    from semcode_tpu_torch.tools._corpus import mixture, oracle_topk, queries_near

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(42)  # phase 4's corpus
    x = mixture(gen, N_ROWS, DIM)
    q = queries_near(gen, x, BATCH)
    truth = oracle_topk(x, q, 10)
    x_host = x.cpu().numpy()
    del x
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = FlatIndex(DIM, metric="ip", dtype="int8", scan_impl="pallas",
                      mesh=shard_mesh())
    index.add(x_host)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() - base_mem
    if index.n_shards != SHARDS:
        fail(f"the phase 9b index is on {index.n_shards} shards")
    shard_rows = index.capacity // SHARDS
    layout = index_layout(index, "9b")
    memory_check(grown, layout, "9b")
    top2_scan.launches = 0
    _, ids = index.search_device(q, 10)
    launches = top2_scan.launches
    if launches != SHARDS:
        fail(f"one 4-shard search launched top2_scan {launches} times, not "
             "once per shard")
    rec = recall_at_10(ids, truth)
    qps, p50 = timed_search(lambda qb: index.search_device(qb, 10), q)
    ms512 = 1e3 * BATCH / qps
    breakdown = device_breakdown(lambda: index.search_device(q, 10),
                                 f"batch-{BATCH} search over {SHARDS} shards")
    base = one_shard["breakdown"]
    busy = breakdown["device_ms"] / breakdown["wall_ms"]
    busy1 = base["device_ms"] / base["wall_ms"]
    log(f"[shard] 9b: {N_ROWS} x {DIM} int8 + f32 mirror over {SHARDS} shards "
        f"of {shard_rows} rows built in {build_s:.1f} s; recall@10 {rec:.4f}; "
        f"batch {BATCH} {ms512:.3f} ms ({qps:.0f} QPS), batch {SERVE_BATCH} p50 "
        f"{p50:.3f} ms; {breakdown['launches']:.0f} device launches a search, "
        f"device busy {100 * busy:.1f}%; one shard (phase 4): batch {BATCH} "
        f"{1e3 * BATCH / one_shard['pallas']['qps']:.3f} ms, batch {SERVE_BATCH} "
        f"p50 {one_shard['pallas']['p50_b8_ms']:.3f} ms, "
        f"{base['launches']:.0f} launches, busy {100 * busy1:.1f}%")
    if rec < 0.99:
        fail(f"4-shard recall@10 {rec:.4f} < 0.99")

    # shard 1's rows start at row 250,016, off the 128-row grid, and sit in
    # tensors of their own: its kernel call at the main path's shape
    # against the plain version
    vecs, _, valid, scales, _, _ = index._ensure_device()
    lo, hi = shard_rows, 2 * shard_rows
    add = torch.where(valid.shard(1), 0.0, NEG).float()
    qq, qsc = quantize_queries_device(q)
    args = (vecs.shard(1), scales.shard(1), add, qq, qsc)
    bm, br = top2_scan(*args)
    rm, rr = top2_scan_reference(*args)
    if not torch.equal(bm, rm) or not torch.equal(br, rr):
        fail("top2_scan on shard 1's rows differs from its plain version")
    log(f"[shard] 9b: top2_scan on shard 1 (rows {lo}-{hi - 1}, Q {BATCH}) "
        "equals its plain version bit for bit")
    index_shards = index.n_shards
    del index, vecs, valid, scales, add
    return {"launches": launches, "recall": rec, "ms_b512": ms512,
            "p50_b8_ms": p50, "qps": qps, "build_s": build_s,
            "shards": index_shards, "shard_rows": shard_rows, "breakdown": breakdown, "busy": busy,
            "mem_grown": grown, "bytes": layout["bytes"], "ids": ids.cpu().tolist(),
            "one_shard": {"ms_b512": 1e3 * BATCH / one_shard["pallas"]["qps"],
                          "p50_b8_ms": one_shard["pallas"]["p50_b8_ms"],
                          "launches": base["launches"], "busy": busy1}}


def sharded_ivf_phase(one_shard: dict):
    """9c: phase 4b's 1M x 384 int8 IVF (nlist 1024, 256 clusters a shard,
    nprobe 32) over 4 shards of the card: recall@10, ivf_scan launched once
    per shard in a search, ms beside phase 4b's; each shard's kernel call
    with the probes it does not own out of range against the plain
    version, and the kernel route against the gather-scan route."""
    import gc

    import torch

    from semcode_tpu_torch.device import f32_matmul
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.index.scan import stable_topk
    from semcode_tpu_torch.ops.ivf_scan import ivf_scan, ivf_scan_reference
    from semcode_tpu_torch.tools._corpus import mixture, oracle_topk, queries_near

    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(42)  # phase 4's corpus
    x = mixture(gen, N_ROWS, DIM)
    q = queries_near(gen, x, BATCH)
    truth = oracle_topk(x, q, 10)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = IVFIndex(DIM, nlist=NLIST, nprobe=32, metric="ip", dtype="int8",
                     kmeans_iters=KMEANS_ITERS, mesh=shard_mesh())
    with index.bulk(expected_rows=N_ROWS):
        for lo in range(0, N_ROWS, 131072):
            index.add(x[lo:lo + 131072])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() - base_mem
    del x
    index_shards = index.n_shards
    nlist_s = index.nlist // SHARDS
    if index_shards != SHARDS or index.nlist != NLIST or nlist_s != 256:
        fail(f"the 4-shard IVF holds nlist {index.nlist} on {index_shards} shards")
    layout = index_layout(index, "9c")
    if layout["shard_rows"]["data"] != nlist_s:
        fail(f"9c: a shard holds {layout['shard_rows']['data']} clusters, not {nlist_s}")
    memory_check(grown, layout, "9c")

    def search(qb):
        return index.search_device(qb, 10, nprobe=32, mode="ivf")

    ivf_scan.launches = 0
    s, ids = search(q)
    launches = ivf_scan.launches
    if launches != SHARDS:
        fail(f"one 4-shard probe search launched ivf_scan {launches} times, "
             "not once per shard")
    rec = recall_at_10(ids, truth)
    qps, p50 = timed_search(search, q)
    breakdown = device_breakdown(lambda: search(q),
                                 f"batch-{BATCH} IVF probe search over {SHARDS} shards")
    busy = breakdown["device_ms"] / breakdown["wall_ms"]
    qps1 = one_shard["nprobe32"]["qps"]
    p501 = one_shard["nprobe32"]["p50_b8_ms"]
    base = one_shard["breakdown"]
    log(f"[shard] 9c: {N_ROWS} x {DIM} int8 IVF, nlist {NLIST} = {SHARDS} x "
        f"{nlist_s}, built in {build_s:.1f} s (cmax {index.cmax}); nprobe 32: "
        f"recall@10 {rec:.4f}; batch {BATCH} {1e3 * BATCH / qps:.3f} ms ({qps:.0f} "
        f"QPS), batch {SERVE_BATCH} p50 {p50:.3f} ms; ivf_scan launches a search "
        f"{launches}; {breakdown['launches']:.0f} device launches, device busy "
        f"{100 * busy:.1f}%; one shard (phase 4b): batch {BATCH} "
        + " / ".join(f"{1e3 * BATCH / v:.3f}" for v in qps1)
        + f" ms, batch {SERVE_BATCH} p50 " + " / ".join(f"{v:.3f}" for v in p501)
        + f" ms, {base['launches']:.0f} launches, busy "
        f"{100 * base['device_ms'] / base['wall_ms']:.1f}%")
    if rec < 0.95:
        fail(f"4-shard IVF recall@10 {rec:.4f} < 0.95 at nprobe 32")
    # the same layout through the gather-scan route
    index.use_pallas = "never"
    s_g, ids_g = search(q)
    index.use_pallas = "auto"
    if not untied_ids_equal(s_g, ids_g, ids, 1e-5):
        fail("4-shard IVF: the kernel route and the gather-scan route disagree")

    # each shard's call at the main path's shape, on the shard's own
    # tensors: the probes _ivf_search picks, those another shard owns out
    # of range (-1)
    dev = index._ensure_device()
    _, probes = stable_topk(f32_matmul(q, dev.centroids.T), 32)
    owned_total = 0
    for rank in range(SHARDS):
        lo = rank * nlist_s
        owned = (probes // nlist_s) == rank
        owned_total += int(owned.sum())
        local = torch.where(owned, probes - lo, -1)
        args = (dev.data.shard(rank), dev.ids.shard(rank), q, local, 64,
                dev.scales.shard(rank))
        ks, ki = ivf_scan(*args)
        rs, ri = ivf_scan_reference(*args)
        if not torch.equal(ks, rs) or not torch.equal(ki, ri):
            fail(f"ivf_scan on shard {rank} differs from its plain version")
    if owned_total != probes.numel():
        fail("the shards do not own every probe once")
    log(f"[shard] 9c: each shard's ivf_scan (probes it does not own set to -1, "
        f"{owned_total} owned probes in all) equals its plain version bit for "
        "bit; kernel-route ids equal the gather-scan route's (untied positions)")
    del index, dev
    return {"launches": launches, "recall": rec, "ms_b512": 1e3 * BATCH / qps,
            "p50_b8_ms": p50, "qps": qps, "build_s": build_s,
            "shards": index_shards, "breakdown": breakdown, "busy": busy,
            "mem_grown": grown, "bytes": layout["bytes"], "ids": ids.cpu().tolist(),
            "one_shard": {"ms_b512": [1e3 * BATCH / v for v in qps1],
                          "p50_b8_ms": p501, "launches": base["launches"],
                          "busy": base["device_ms"] / base["wall_ms"]}}


def dcn_port(rank: int, out_path: str) -> int:
    """The coordinator port of 9d's group: worker 0 takes a free one just
    before its group binds it and announces it in ``<out>.port``; worker 1
    waits for that file."""
    import socket

    port_file = Path(out_path + ".port")
    if rank == 0:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        tmp = port_file.with_suffix(".tmp")
        tmp.write_text(str(port))
        tmp.rename(port_file)
        return port
    deadline = time.monotonic() + DCN_TIMEOUT_S
    while not port_file.exists():
        if time.monotonic() > deadline:
            raise RuntimeError("9d worker 0 never announced its port")
        time.sleep(0.05)
    return int(port_file.read_text())


def dcn_worker(rank: int, out_path: str, backend: str) -> int:
    """One process of 9d: joins the two-process group, holds 2 of the 4
    shards (a ("dcn", "data") = (2, 2) mesh), self-ingests like 9a and
    answers the 102 frozen questions; rank 0 writes the answers."""
    import torch

    sys.path.insert(0, str(ROOT))
    from semcode_tpu_torch.ops import scan_top2
    from semcode_tpu_torch.ops.build import BUILD_DIR
    from semcode_tpu_torch.parallel import distributed
    from semcode_tpu_torch.parallel.mesh import make_mesh
    from semcode_tpu_torch.settings import AppSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    # the parent built the kernel library: load it instead of rebuilding
    scan_top2._library.get(BUILD_DIR / "libsemcode_top2_scan.so")
    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    torch.cuda.set_device(torch.device(device))
    port = dcn_port(rank, out_path)
    cfg = AppSettings(mesh_num_processes=2, mesh_coordinator=f"127.0.0.1:{port}",
                      mesh_process_id=rank)
    distributed.maybe_init_distributed(cfg, device=device, backend=backend)
    try:
        mesh = make_mesh((2, 2), ("dcn", "data"), devices=[device] * 2)
        with tempfile.TemporaryDirectory(prefix="semcode_dcn_") as tmp:
            _, res, svc, pipe = sharded_ingest(Path(tmp), device, mesh, f"dcn{rank}")
            questions = [qq for qq, _ in frozen_queries()]
            scan_top2.top2_scan.launches = 0
            results = pipe.query_batch(questions, top_k=10)
            out = {"paths": result_paths(results), "chunks": res.chunk_count,
                   "launches": scan_top2.top2_scan.launches,
                   "backend": backend, "device": device}
        if rank == 0:
            Path(out_path).write_text(json.dumps(out))
        else:
            Path(out_path + ".1").write_text(json.dumps(out))
    finally:
        distributed.shutdown()
    return 0


def run_pair(workdir: Path, label: str, flag: str, extra, timeout: float):
    """Run ``chip_smoke.py FLAG RANK OUT *extra`` as two processes until both
    end; a worker that fails or outlives ``timeout`` fails the run (once
    more on a fresh port if the coordinator port was taken). Returns both
    workers' JSON (rank 0 writes OUT, rank 1 OUT.1) and the seconds."""
    for attempt in range(2):
        out_path = workdir / f"{label}{attempt}.json"
        t0 = time.perf_counter()
        outs = [open(workdir / f"{label}{attempt}.{rank}.log", "w+") for rank in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(rank),
             str(out_path), *extra],
            stdout=outs[rank], stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        try:
            # until both end, or one fails (its peer would wait for it)
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    fail(f"a {label} worker outlived its {timeout} s timeout")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        logs = []
        for f in outs:
            f.seek(0)
            logs.append(f.read())
            f.close()
        if all(p.returncode == 0 for p in procs):
            break
        # another process took the port between worker 0's probe and its
        # group's bind: try once more on a fresh port
        if attempt == 0 and any("address already in use" in text.lower()
                                for text in logs):
            log(f"[shard] {label}: the coordinator port was taken; retrying once")
            continue
        fail(f"{label} failed:\n" + "\n".join(
            f"worker {rank} (rc {p.returncode}):\n{text[-3000:]}"
            for rank, (p, text) in enumerate(zip(procs, logs)) if p.returncode != 0))
    wall_s = time.perf_counter() - t0
    for rank, text in enumerate(logs):
        for line in text.splitlines():
            if line.startswith(f"[{label}]"):
                log(f"{line} (worker {rank})")
    got = [json.loads(out_path.read_text()),
           json.loads(Path(str(out_path) + ".1").read_text())]
    return got, wall_s


def dcn_phase(workdir: Path, want: dict):
    """9d: the ("dcn", "data") path across two processes on the card, each
    holding 2 shards: Gloo (NCCL refuses two ranks on one device), the
    (Q, k) candidates staged through the host; one process per card over
    NCCL on a host with two cards. Both processes' answers must equal 9a's
    single-process 4-shard store's; a worker that fails or outlives its
    timeout fails the run."""
    import torch

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    got, wall_s = run_pair(workdir, "dcn", "--dcn-worker", [backend], DCN_TIMEOUT_S)
    for rank, g in enumerate(got):
        if g["paths"] != want["paths"]:
            bad = next(i for i, (a, b) in enumerate(zip(g["paths"], want["paths"]))
                       if a != b)
            fail(f"9d process {rank} answers question {bad} otherwise than 9a's "
                 f"store:\n{g['paths'][bad]}\n{want['paths'][bad]}")
        if g["launches"] < 2:
            fail(f"9d process {rank} launched top2_scan {g['launches']} times")
    log(f"[shard] 9d: two processes ({backend}, {got[0]['device']} and "
        f"{got[1]['device']}), 2 shards each: all 102 top-10 paths equal 9a's "
        f"4-shard store in both; top2_scan launches {got[0]['launches']} and "
        f"{got[1]['launches']}; {wall_s:.1f} s for both workers")
    return {"backend": backend, "launches": [g["launches"] for g in got],
            "wall_s": wall_s}


def split_worker(rank: int, out_path: str) -> int:
    """One process of 9e: joins a two-process Gloo group on the card, holds
    2 of the 4 shards (a ("dcn", "data") = (2, 2) mesh) and builds phase
    9b's 1M x 384 int8 flat index with its f32 mirror, then 9c's IVF (nlist
    1024), from phase 4's seed; writes each index's ids for the 512
    queries, the bytes it holds and its build's memory growth."""
    import gc

    import torch

    sys.path.insert(0, str(ROOT))
    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.ops import ivf_scan, scan_top2
    from semcode_tpu_torch.ops.build import BUILD_DIR
    from semcode_tpu_torch.parallel import distributed
    from semcode_tpu_torch.parallel.mesh import make_mesh
    from semcode_tpu_torch.settings import AppSettings
    from semcode_tpu_torch.tools._corpus import mixture, queries_near

    torch.backends.cuda.matmul.allow_tf32 = False
    # the parent built the kernel libraries: load them instead of rebuilding
    scan_top2._library.get(BUILD_DIR / "libsemcode_top2_scan.so")
    ivf_scan._library.get(BUILD_DIR / "libsemcode_ivf_scan.so")
    device = "cuda:0"
    torch.cuda.set_device(torch.device(device))
    port = dcn_port(rank, out_path)
    cfg = AppSettings(mesh_num_processes=2, mesh_coordinator=f"127.0.0.1:{port}",
                      mesh_process_id=rank)
    distributed.maybe_init_distributed(cfg, device=device, backend="gloo")
    t_start = time.perf_counter()
    try:
        mesh = make_mesh((2, 2), ("dcn", "data"), devices=[device] * 2)
        gen = torch.Generator(device="cuda").manual_seed(42)  # phase 4's corpus
        x = mixture(gen, N_ROWS, DIM)
        q = queries_near(gen, x, BATCH)
        out = {}

        def build(name, make):
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            index = make()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            grown = torch.cuda.memory_allocated() - base
            layout = index_layout(index, f"9e {name}, process {rank}")
            if layout["shards"] != [2 * rank, 2 * rank + 1]:
                fail(f"9e process {rank} holds shards {layout['shards']}")
            memory_check(grown, layout, f"9e {name}, process {rank}")
            log(f"[split] {name}: process {rank} holds {layout['bytes']} B "
                f"({layout['bytes'] / 2**30:.3f} GiB) of index tensors, shards "
                f"{layout['shards']}; memory_allocated() grew {grown} B; built "
                f"in {build_s:.1f} s")
            return index, {"bytes": layout["bytes"], "mem_grown": grown,
                           "build_s": build_s, "shards": layout["shards"],
                           "shard_rows": layout["shard_rows"]}

        x_host = x.cpu().numpy()

        def flat():
            index = FlatIndex(DIM, metric="ip", dtype="int8", scan_impl="pallas",
                              mesh=mesh)
            index.add(x_host)
            return index

        index, rec = build("flat", flat)
        del x_host
        scan_top2.top2_scan.launches = 0
        _, ids = index.search_device(q, 10)
        rec.update(ids=ids.cpu().tolist(), launches=scan_top2.top2_scan.launches)
        out["flat"] = rec
        del index, ids

        def ivf():
            index = IVFIndex(DIM, nlist=NLIST, nprobe=32, metric="ip", dtype="int8",
                             kmeans_iters=KMEANS_ITERS, mesh=mesh)
            with index.bulk(expected_rows=N_ROWS):
                for lo in range(0, N_ROWS, 131072):
                    index.add(x[lo:lo + 131072])
            return index

        index, rec = build("ivf", ivf)
        ivf_scan.ivf_scan.launches = 0
        _, ids = index.search_device(q, 10, nprobe=32, mode="ivf")
        rec.update(ids=ids.cpu().tolist(), launches=ivf_scan.ivf_scan.launches)
        out["ivf"] = rec
        del index, ids
        out["seconds"] = time.perf_counter() - t_start
        Path(out_path if rank == 0 else out_path + ".1").write_text(json.dumps(out))
    finally:
        distributed.shutdown()
    return 0


def split_phase(workdir: Path, flat: dict, ivf: dict):
    """9e: the memory split across processes. Two processes on the card over
    Gloo, 2 of the 4 shards each, build 9b's flat index and 9c's IVF from
    the same seed: each must hold at most 0.55 of the one-process 4-shard
    index's bytes (its own shards' tensors and the replicated centroids),
    and both must answer the 512 queries with 9b's and 9c's ids."""
    got, wall_s = run_pair(workdir, "split", "--split-worker", [], SPLIT_TIMEOUT_S)
    out = {"wall_s": wall_s, "seconds": [g["seconds"] for g in got]}
    for name, one in (("flat", flat), ("ivf", ivf)):
        for rank, g in enumerate(got):
            rec = g[name]
            if rec["ids"] != one["ids"]:
                bad = next(i for i, (a, b) in enumerate(zip(rec["ids"], one["ids"]))
                           if a != b)
                fail(f"9e {name}: process {rank} answers query {bad} with "
                     f"{rec['ids'][bad]}, the one-process 4-shard index with "
                     f"{one['ids'][bad]}")
            share = rec["bytes"] / one["bytes"]
            if share > 0.55:
                fail(f"9e {name}: process {rank} holds {rec['bytes']} B, "
                     f"{share:.3f} of the one-process index's {one['bytes']} B")
            if rec["launches"] < 2:
                fail(f"9e {name}: process {rank} launched its kernel "
                     f"{rec['launches']} times in a search")
        out[name] = {
            "bytes": [g[name]["bytes"] for g in got],
            "mem_grown": [g[name]["mem_grown"] for g in got],
            "build_s": [g[name]["build_s"] for g in got],
            "launches": [g[name]["launches"] for g in got],
            "one_process_bytes": one["bytes"],
            "share": [g[name]["bytes"] / one["bytes"] for g in got],
        }
        log(f"[shard] 9e {name}: two processes of 2 shards each hold "
            + " and ".join(f"{b / 2**30:.3f} GiB" for b in out[name]["bytes"])
            + f" of index tensors against {one['bytes'] / 2**30:.3f} GiB in one "
            f"process of 4 shards (shares "
            + " / ".join(f"{v:.3f}" for v in out[name]["share"])
            + f"); the 512 queries' top-10 ids equal the one-process index's "
            f"in both; launches a search {out[name]['launches']}")
    log(f"[shard] 9e: {wall_s:.1f} s for both workers (each "
        + " / ".join(f"{v:.1f}" for v in out["seconds"]) + " s after joining the group)")
    return out


# -- phase 11: the headline benchmark ----------------------------------------------

# the limits each bench line must meet (key, least value); 11a adds the
# 1M x 3072 section's, exact and probing at nprobe 16
BENCH_FLOORS = (("recall_at_10_exact", 0.99), ("recall_at_10_probing", 0.95),
                ("recall_at_10_probing16", 0.95), ("filtered_recall_at_10", 0.99))
BENCH_SECS = "4"
BENCH_TIMEOUT_S = 300
BENCH_PALLAS_TIMEOUT_S = 200


def bench_phase(label: str, env_extra: dict, timeout: float) -> dict:
    """11a / 11b: ``python -m semcode_tpu_torch.bench`` as shipped, in a
    process of its own with a timeout, at the full 1M x 384 (and 11a's 1M
    x 3072) with BENCH_SECS 4. Its last line must name no failed or
    skipped section and meet BENCH_FLOORS, hold every filtered hit to its
    tag and show the writer's 5120 rows; 11a's 1M x 3072 section must
    take the residual tier at recall@10 >= 0.99 (>= 0.95 probing at
    nprobe 16). The line's figures and
    the bench's log are printed; returns its extras, value and seconds."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_SECS=BENCH_SECS, **env_extra)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "semcode_tpu_torch.bench"],
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        fail(f"bench {label} outlived its {timeout} s timeout:\n"
             f"{(exc.stderr or b'')[-3000:]}")
    wall_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("[bench"):
            log(f"[bench] {label} {line}")
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if not lines:
        fail(f"bench {label} printed no line (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    log(f"[bench] {label} last line: {lines[-1]}")
    out = json.loads(lines[-1])
    ex = out["extras"]
    if proc.returncode != 0 or ex.get("stage") != "done":
        fail(f"bench {label} exited {proc.returncode} at stage {ex.get('stage')}:\n"
             f"{proc.stderr[-3000:]}")
    if ex["failed"] or ex["skipped"]:
        fail(f"bench {label}: failed {ex['failed']}, skipped {ex['skipped']}")
    floors = BENCH_FLOORS
    if env_extra.get("BENCH_HIGHDIM") != "0":
        floors += (("d3072_recall_at_10", 0.99),
                   ("d3072_recall_at_10_probing16", 0.95))
        if ex.get("d3072_rescore_tier") != "residual":
            fail(f"bench {label}: the 1M x 3072 index took the "
                 f"{ex.get('d3072_rescore_tier')} tier, not residual")
    for key, least in floors:
        if not ex.get(key, -1) >= least:
            fail(f"bench {label}: {key} {ex.get(key)} < {least}")
    if ex.get("filtered_hits_all_match") is not True:
        fail(f"bench {label}: a filtered hit lies outside the allowed tag")
    if ex.get("under_ingest_rows") != 5120:
        fail(f"bench {label}: the writer wrote {ex.get('under_ingest_rows')} of 5120 rows")
    log(f"[bench] {label}: {out['value']} QPS (vs_baseline {out['vs_baseline']}), "
        f"launches {ex['kernel_launches']}, in {wall_s:.1f} s")
    return {"value": out["value"], "vs_baseline": out["vs_baseline"],
            "extras": ex, "wall_s": wall_s}


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import semcode_tpu_torch  # noqa: F401 - fails outside a checkout
    from semcode_tpu_torch.embeddings.native import get_native
    from semcode_tpu_torch.ops import dot_max, ivf_scan, scan_top2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}; {card}")

    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        # every CUDA library prints ptxas's registers, shared memory, spills
        top2_lib = pool.submit(scan_top2.build_library, True)
        probes = {kind: pool.submit(lib.build, True)
                  for kind, lib in scan_top2.PROBE_LIBRARIES.items()}
        ivf_lib = pool.submit(ivf_scan.build_library, True)
        ivf_probes = {kind: pool.submit(lib.build, True)
                      for kind, lib in ivf_scan.PROBE_LIBRARIES.items()}
        dot_lib = pool.submit(dot_max.build_library, True)
        native = pool.submit(get_native)
        scan_top2._library.get(top2_lib.result())
        for kind, lib in probes.items():
            scan_top2.PROBE_LIBRARIES[kind].get(lib.result())
        ivf_scan._library.get(ivf_lib.result())
        for kind, lib in ivf_probes.items():
            ivf_scan.PROBE_LIBRARIES[kind].get(lib.result())
        dot_max._library.get(dot_lib.result())
        if native.result() is None:
            fail("the native featurizer did not build")
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")

    worst = check_kernel()
    worst_ivf = check_ivf_kernel()
    check_dot_max()
    with tempfile.TemporaryDirectory(prefix="semcode_smoke_") as tmp:
        e2e = main_path(Path(tmp))
        ivf_e2e = ivf_store(Path(tmp), e2e["mrr_xla"])
        bf16_e2e = bf16_store(Path(tmp))
        api = api_ingest_and_query(Path(tmp), e2e["mrr"])
        encoder = encoder_model_phase()
        hybrid = hybrid_main_path(Path(tmp))
        hybrid_api = api_ingest_and_query(Path(tmp), hybrid["mrr"],
                                          provider="tpu-hybrid")
        decoder = decoder_model_phase()
        lm_e2e = lm_pipeline_phase(e2e.pop("pipeline"))
        lm_api = api_lm_phase(Path(tmp))
        training = training_phase(Path(tmp))
        sharded_training = sharded_training_phase(training)
    heldout = heldout_phase()
    api_legs = api_slo()
    api_kernel = api_kernel_shape()
    scale = scale_phase()
    topk = topk_phase()
    ivf_scale = ivf_scale_phase()
    with tempfile.TemporaryDirectory(prefix="semcode_shard_") as tmp:
        sharded = sharded_store_phase(Path(tmp), e2e["mrr"])
        dcn = dcn_phase(Path(tmp), sharded)
    sharded_scale = sharded_scale_phase(scale)
    sharded_ivf = sharded_ivf_phase(ivf_scale)
    gc.collect()
    torch.cuda.empty_cache()  # the workers' room on the card
    with tempfile.TemporaryDirectory(prefix="semcode_split_") as tmp:
        split = split_phase(Path(tmp), sharded_scale, sharded_ivf)
    gc.collect()
    torch.cuda.empty_cache()  # the bench's room on the card
    bench_auto = bench_phase("11a", {}, BENCH_TIMEOUT_S)
    bench_pallas = bench_phase("11b", {"BENCH_SCAN_IMPL": "pallas", "BENCH_HIGHDIM": "0",
                                       "BENCH_API": "0"}, BENCH_PALLAS_TIMEOUT_S)
    sharded.pop("paths")
    sharded_scale.pop("ids")
    sharded_ivf.pop("ids")

    def kernel_record(name, source, replaces, launches, kern, worst_err=0.0, **extra):
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": max(worst_err, kern["max_abs_err"])}
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            rec[key] = kern[key]
        rec["matched"] = True
        rec.update(extra)
        if launches < 1:
            fail(f"{name} was not launched on its path")
        return rec

    top2_src = ("semcode_tpu_torch/ops/csrc/top2_scan.cu",
                "semcode_tpu/ops/scan_kernel2.py:161")
    ivf_src = ("semcode_tpu_torch/ops/csrc/ivf_scan.cu", "semcode_tpu/ops/kernels.py:247")
    dot_src = ("semcode_tpu_torch/ops/csrc/dot_max.cu", "tools/dot_pallas.py:52")
    records = []
    # top2_scan: int8 on the main path (phase 3), bf16 on phase 3c's store,
    # f32 on phase 4's f32 index; each with Q=8 and its measurement builds
    # the int8 record adds the served path (phase 5): launches behind
    # /query and behind the SLO leg, and the kernel at its shape
    api_extra = {
        "api_launches": api["launches"],
        "api_slo_launches": api_legs["pallas"]["launches"],
        # phase 6: the 768-d tpu-hybrid store in process and behind /query
        "hybrid_launches": hybrid["launches"],
        "hybrid_api_launches": hybrid_api["launches"],
        # phase 8d: the store of the encoder trained in 8a
        "train_serve_launches": training["serve"]["launches"],
        # phase 9: launched once per shard of a 4-shard store, in process
        # (9a, its /query, 9b) and across two processes (9d); the shard
        # counts the stores report
        "shards": sharded["shards"],
        "sharded_scale_shards": sharded_scale["shards"],
        "sharded_launches": sharded["launches"],
        "sharded_api_launches": sharded["http_launches"],
        "sharded_scale_launches": sharded_scale["launches"],
        "dcn_launches": dcn["launches"],
        # phase 9e: two processes holding 2 shards each of 9b's index
        "split_launches": split["flat"]["launches"],
        # phase 10d: the dry run's index half (its indexes' default routes)
        "dryrun_launches": sharded_training["dryrun"]["launches"]["top2_scan"],
        # phase 11b: the bench with BENCH_SCAN_IMPL=pallas
        "bench_launches": bench_pallas["extras"]["kernel_launches"]["top2_scan"],
        **{f"api_{key}": api_kernel[key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    for storage, launches, timed, extra in (
        ("int8", e2e["launches"], {"kernel": scale["kernel"],
                                   "kernel_q8": scale["kernel_q8"]}, api_extra),
        ("bfloat16", bf16_e2e["launches"], scale["bfloat16"], {}),
        ("float32", scale["float32"]["launches"], scale["float32"], {}),
    ):
        kern = timed["kernel"]
        records.append(kernel_record(
            f"top2_scan[{storage}]", *top2_src, launches, kern,
            max(worst, api_kernel["max_abs_err"]) if extra else worst,
            ms_q8=timed["kernel_q8"]["ms"], bound_ms_q8=timed["kernel_q8"]["bound_ms"],
            products_ms=kern["products_ms"], selection_ms=kern["selection_ms"],
            **extra))
    if api["launches"] < 1:
        fail("top2_scan was not launched behind /query")
    if records[0]["bench_launches"] < 1:
        fail("top2_scan was not launched in the bench's run with BENCH_SCAN_IMPL=pallas")
    ik = ivf_scale["kernel"]
    if bench_auto["extras"]["kernel_launches"]["ivf_scan"] < 1:
        fail("ivf_scan was not launched in the bench's run as shipped")
    records.append(kernel_record(
        "ivf_scan[int8]", *ivf_src, ik["launches"], ik, worst_ivf,
        # the scan kernel alone, the bookkeeping kernels and the scan's two
        # measurement builds
        kernel_ms=ik["kernel_ms"], prep_ms=ik["prep_ms"],
        scatter_ms=ik["scatter_ms"], merge_ms=ik["merge_ms"],
        products_ms=ik["products_ms"], selection_ms=ik["selection_ms"],
        producer_wait=ik["producer_wait"],
        # phase 9c: one probe search over 4 shards, once per shard
        shards=sharded_ivf["shards"], sharded_launches=sharded_ivf["launches"],
        split_launches=split["ivf"]["launches"],
        dryrun_launches=sharded_training["dryrun"]["launches"]["ivf_scan"],
        # phase 11a: the bench as shipped
        bench_launches=bench_auto["extras"]["kernel_launches"]["ivf_scan"]))
    for storage in ("bfloat16", "float32"):
        leg = ivf_scale[storage]
        lk = leg["kernel"]
        records.append(kernel_record(
            f"ivf_scan[{storage}]", *ivf_src, leg["launches"], lk, worst_ivf,
            kernel_ms=lk["kernel_ms"], products_ms=lk["products_ms"],
            selection_ms=lk["selection_ms"], registers=lk["registers"],
            local_bytes=lk["local_bytes"], producer_wait=lk["producer_wait"]))
    records.append(kernel_record(
        "scan_topk[int8]", "semcode_tpu_torch/ops/csrc/top2_scan.cu",
        "none (the JAX exact route's XLA dot + top_k)", ivf_scale["topk_launches"],
        topk["d384_q512"], smoke_launches=topk["smoke_launches"],
        ms_q8=topk["d384_q8"]["ms"],
        bound_ms_q8=topk["d384_q8"]["bound_ms"], ms_d3072=topk["d3072_q256"]["ms"],
        bound_ms_d3072=topk["d3072_q256"]["bound_ms"],
        library_ms_d3072=topk["d3072_q256"]["library_ms"],
        registers=topk["registers"], local_bytes=topk["local_bytes"]))
    dk = scale["dot_max"]
    for mode in ("s32", "bf16"):
        records.append(kernel_record(f"dot_max[{mode}]", *dot_src,
                                     dk[mode]["launches"], dk[mode],
                                     rtile=dk[mode]["rtile"]))
    summary = {
        "e2e": e2e,
        "ivf_e2e": ivf_e2e,
        "bf16_e2e": bf16_e2e,
        "api": api,
        "api_slo": api_legs,
        "api_kernel": api_kernel,
        "encoder": encoder,
        "hybrid_e2e": hybrid,
        "hybrid_api": hybrid_api,
        "heldout": heldout,
        "decoder": decoder,
        "lm_e2e": lm_e2e,
        "lm_api": lm_api,
        "training": training,
        "sharded_training": {k: v for k, v in sharded_training.items() if k != "dryrun"},
        "dryrun": sharded_training["dryrun"],
        "scale": {k: v for k, v in scale.items() if k not in ("kernel", "dot_max")},
        "topk": topk,
        "dot_max": dk,
        "ivf_scale": {k: v for k, v in ivf_scale.items() if k != "kernel"},
        "sharded": sharded,
        "dcn": dcn,
        "sharded_scale": sharded_scale,
        "sharded_ivf": sharded_ivf,
        "split": split,
        "bench": {"11a": bench_auto, "11b": bench_pallas},
    }
    log(f"[summary] {json.dumps(summary)}")
    log(f"[time] chip_smoke ran {time.perf_counter() - t_start:.1f} s after the "
        "card check")
    print(json.dumps({"kernels": records}), flush=True)
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
    if sys.argv[1:2] == ["--dcn-worker"]:
        raise SystemExit(dcn_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--split-worker"]:
        raise SystemExit(split_worker(int(sys.argv[2]), sys.argv[3]))
    raise SystemExit(main())
