// IVF probing scan: masked top-k of each query against the clusters it
// probes, for Hopper (sm_90a).
//
// Replaces semcode_tpu/ops/kernels.py::ivf_scan_shard (Pallas, TPU). For
// every (query q, probed cluster c) pair it computes, over the cluster's
// cmax slots,
//     int8:       score = (float(raw) * qsc[q]) * scales[c][slot],
//                 raw = qq[q] . data[c][slot]   (s8 x s8 -> s32, exact)
//     bf16 / f32: score = q[q] . data[c][slot]  (f32 query, f32 products)
// masks slots whose id is < 0, and returns each query's top-k (k <= 64) over
// all its pairs, ordered by (score desc, cluster asc, slot asc); a query with
// fewer than k valid slots gets -3e38 / -1 in its tail.
//
// What bounds it on an H100: at the main path's shape (1M x 384 int8, nlist
// 1024, cmax 2176, Q=512, nprobe 32, clusters ~45% full) the function must
// read the ids of every slot of the probed clusters and the row and scale
// (388 bytes) of every valid one, ~0.40 GB: 0.12 ms at 3.35 TB/s, against
// 2.7e10 useful int8 operations (0.014 ms); bf16 rows make it ~0.78 GB
// (0.23 ms) and f32 rows ~1.54 GB (0.46 ms), against 1.2e10 useful f32
// operations (0.18 ms on the CUDA cores). So the design streams the probed
// clusters, each only up to its last valid 128-slot chunk (a layout packs a
// cluster's rows at the front of its block), and hides the top-k selection
// under the stream.
//
// Four kernels, launched in order on one stream with no host sync:
// 1. ivf_prep (one block): the probe table (repeats and out-of-range probes
//    skipped), each valid (query, probe) pair's rank in its cluster's bucket
//    by atomics on global counters (the order inside a bucket varies from
//    run to run; no result depends on it), an exclusive scan over the
//    clusters, and the tile list: each cluster's pairs cut into tiles of up
//    to 64 (int8), 20 (bf16) or 32 (f32) queries, in cluster order.
// 2. ivf_scatter: each pair into its bucket and its query row into a
//    pair-ordered buffer (int8: the quantized row; bf16: the f32 row's three
//    bf16 parts; f32: the row), so that a tile's queries are contiguous rows
//    for TMA; the first pair of each bucket finds the cluster's last
//    128-slot chunk that holds a valid id.
// 3. the scan (ivf_scan_s8, ivf_scan_bf16, ivf_scan_f32: one body, section
//    3): persistent warp-specialised CTAs walk the tile list (CTA b takes
//    tiles b, b + grid, ..., so the tiles of one cluster run together and
//    re-read it from L2). A producer warp streams 128-byte depth chunks of
//    each 128-row chunk of the cluster, up to its last valid one, and of the
//    tile's gathered query rows, by TMA (128-byte swizzle) into an mbarrier
//    ring; a second producer warp loads each row chunk's ids (and int8
//    scales) with coalesced loads. int8: two consumer warpgroups each run
//    wgmma m64n64k32 s8 on half of every chunk's rows, with the queries as M
//    and the rows as N, then the epilogue, unfused as the reference computes
//    it; a small tile's queries are spread over the four warps of M (warp
//    w's rows hold queries w*m .. w*m + m - 1, m = ceil(nq / 4)), so each
//    warp filters a share. bf16: the same with one wgmma m64n64k16 a 16 of
//    depth on the rows as stored, the f32 query as three exact bf16 parts in
//    M; f32: the consumers' eight warps run register-tiled f32 FMAs on the
//    CUDA cores from the same stages. The selection is the same for every
//    storage: every query keeps its k-th (score, slot) as a threshold; a
//    score that beats it is appended to the query's candidate buffer in
//    shared memory (a share of one pool, up to 384 entries). Before a chunk
//    could overflow a buffer, and at the cluster's end, one warp selects the
//    buffer's k best exactly (a
//    histogram of the scores finds the k-th's bin, whose entries are ranked
//    by (score, slot)) and raises the threshold; the consumer warps share
//    these selects, and a final 64-key bitonic sort orders each pair's list.
//    Each select also publishes its k-th score as a bound on the query's
//    final k-th (atomicMax per query): the query's pairs scanned later
//    filter against it too, so their buffers stay small. Ties at a bound
//    pass, so the merged top-k is exact and the same whichever CTA publishes
//    first; only the per-pair lists, which nothing returns, shorten.
// 4. ivf_merge: one warp per query merges its sorted per-pair lists by
//    (score desc, cluster asc, list position asc); skipped probes are empty.
//
// Plain C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launches; the caller allocates every buffer, owns the
// stream and chooses the launch geometry (ops/ivf_scan.ivf_geometry), which
// is checked here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// Measurement builds of the scan, every storage (ops/ivf_scan.PROBE_LIBRARIES,
// timed by chip_smoke.py): -DIVF_PROBE=1 keeps the ring and the products and
// skips the selection; -DIVF_PROBE=2 keeps the ring and runs the selection on
// synthetic scores (a hash of (pair, slot)) with no products; their outputs
// are meaningless. -DIVF_PROBE=3 is the whole scan with clock64 phase
// timers: each consumer warp adds its cycles in each phase (PHASE below)
// and the TMA producer its cycles waiting for a free stage to
// g_phase[storage], which semcode_ivf_phases reads and clears.
#ifndef IVF_PROBE
#define IVF_PROBE 0
#endif

#if IVF_PROBE == 3
// phases: 0 products (with the waits for full stages), 1 merges, 2 the wait
// for the chunk's ids, 3 offer, 4 the consumers' barrier after it, 5 tile
// start and end (state, final selects, sorts, output); 6 the consumers'
// total; 7 the producer's wait for free stages, 8 its total
constexpr int kPhases = 9;
__device__ unsigned long long g_phase[3][kPhases];
#define PHASE_CLOCK long long phase_t = clock64(), phase_0 = phase_t
#define PHASE(k)                                  \
  do {                                            \
    const long long phase_n = clock64();          \
    phase[k] += phase_n - phase_t;                \
    phase_t = phase_n;                            \
  } while (0)
#else
#define PHASE_CLOCK
#define PHASE(k) do {} while (0)
#endif

namespace {

using namespace hopper;

constexpr int kMaxK = 64;
constexpr int kMaxProbe = 128;
constexpr int kRowChunk = 128;   // cluster slots per streamed chunk: wgmma N
constexpr int kParts = 3;        // bf16 storage: the f32 query's bf16 parts hi, mid, lo
constexpr float kNeg = -3.0e38f;
constexpr int kNoSlot = 0x7fffffff;

// (score, slot) ordering: higher score first, then lower slot
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

struct Tile {
  int cluster, pos0, nq, pad;
};

// ---------------------------------------------------------------------------
// 1-2. pair bookkeeping: probe table, buckets, tiles, gathered query rows
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 1024;
constexpr int kGatherRows = 8;        // pairs per scatter block (a warp each)

// One block. ptab[q][j] = the probe, or -1 when it is out of range or repeats
// an earlier probe of q; prank = each valid pair's rank in its cluster's
// bucket; count[c] = the bucket's first position (buckets in cluster order;
// the counters are global, any nlist fits); tiles[t] = (cluster, first pair
// position, pair count); hdr = (tiles, valid pairs); qthr = no query bound
// yet (the int8 scan's).
template <typename P>
__global__ void __launch_bounds__(kPrepThreads, 1)
ivf_prep(const P* __restrict__ probes, int nq, int nprobe, int nlist,
         int tile_q, int* __restrict__ ptab, int* __restrict__ prank,
         int* __restrict__ count, Tile* __restrict__ tiles,
         int* __restrict__ hdr, int* __restrict__ qthr) {
  __shared__ int s_part[2][32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int c = tid; c < nlist; c += kPrepThreads) count[c] = 0;
  for (int q = tid; q < nq; q += kPrepThreads) qthr[q] = INT_MIN;  // no bound yet
  __syncthreads();

  // the probe table and each valid pair's rank in its bucket: a warp a
  // query, the next query's probes loaded while this one is processed
  constexpr int kStep = kPrepThreads / 32;
  long long next[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    next[m] = warp < nq && j < nprobe ? (long long)probes[(size_t)warp * nprobe + j] : -1;
  }
  for (int q = warp; q < nq; q += kStep) {
    int p[4];
    bool keep[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const long long v = next[m];
      keep[m] = v >= 0 && v < nlist;
      p[m] = keep[m] ? (int)v : -1 - m;  // no two skipped entries match
      const int j = lane + 32 * m;
      next[m] = q + kStep < nq && j < nprobe
                    ? (long long)probes[(size_t)(q + kStep) * nprobe + j] : -1;
    }
    // a repeat of an earlier probe is skipped: lower lanes of the same
    // register by match_any, earlier registers lane by lane
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (32 * m >= nprobe) break;  // warp-uniform
      const unsigned same = __match_any_sync(0xffffffffu, p[m]);
      if (same & ((1u << lane) - 1)) keep[m] = false;
#pragma unroll
      for (int m2 = 0; m2 < m; ++m2) {
        for (int src = 0; src < 32; ++src) {
          if (__shfl_sync(0xffffffffu, p[m2], src) == p[m]) keep[m] = false;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = lane + 32 * m;
      if (j < nprobe) {
        const int f = q * nprobe + j;
        ptab[f] = keep[m] ? p[m] : -1;
        if (keep[m]) prank[f] = atomicAdd(&count[p[m]], 1);
      }
    }
  }
  __syncthreads();

  // exclusive scan of the pair and tile counts over the clusters: each
  // thread owns a contiguous run of clusters
  const int per = (nlist + kPrepThreads - 1) / kPrepThreads;
  const int c0 = min(nlist, tid * per), c1 = min(nlist, c0 + per);
  int np = 0, nt = 0;
  for (int c = c0; c < c1; ++c) {
    const int n = __ldcg(count + c);  // from L2, where the atomics landed
    np += n;
    nt += (n + tile_q - 1) / tile_q;
  }
  int ip = np, it = nt;  // inclusive within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ip, off);
    const int b = __shfl_up_sync(0xffffffffu, it, off);
    if (lane >= off) { ip += a; it += b; }
  }
  if (lane == 31) { s_part[0][warp] = ip; s_part[1][warp] = it; }
  __syncthreads();
  if (warp == 0) {
    int a = s_part[0][lane], b = s_part[1][lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, a, off);
      const int y = __shfl_up_sync(0xffffffffu, b, off);
      if (lane >= off) { a += x; b += y; }
    }
    s_part[0][lane] = a;
    s_part[1][lane] = b;
  }
  __syncthreads();
  int pbase = ip - np + (warp ? s_part[0][warp - 1] : 0);
  int tbase = it - nt + (warp ? s_part[1][warp - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    const int n = __ldcg(count + c);
    count[c] = pbase;  // the bucket's first position
    for (int t = 0; t * tile_q < n; ++t)
      tiles[tbase++] = Tile{c, pbase + t * tile_q, min(tile_q, n - t * tile_q), 0};
    pbase += n;
  }
  if (tid == 0) {
    hdr[0] = s_part[1][31];
    hdr[1] = s_part[0][31];
  }
}

// Each valid pair f into its bucket, pair_at[start[c] + rank] = f, and its
// query row (row f / nprobe of qsrc) into qbuf at the same position, by
// `qform`: 0 none; 1 int8 rows as they are; 2 f32 rows as three bf16 parts
// hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid) (each residual
// exact in f32, so hi + mid + lo == q), part p at row 3 pos + p; 3 f32 rows
// as they are. A warp a pair. With ids, the bucket's first pair
// also writes nchunk[c]: the 128-slot chunks of cluster c up to its last
// valid slot (0: none). A layout packs each cluster's rows at the front of
// its block, so the scan streams no empty tail.
__global__ void __launch_bounds__(32 * kGatherRows)
ivf_scatter(const int* __restrict__ ptab, const int* __restrict__ prank,
            const int* __restrict__ start, int n_pairs, int nprobe,
            int* __restrict__ pair_at, int qform, const uint8_t* __restrict__ qsrc,
            int d, uint8_t* __restrict__ qbuf, const int* __restrict__ ids, int cmax,
            int* __restrict__ nchunk) {
  const int f = blockIdx.x * kGatherRows + threadIdx.x / 32;
  if (f >= n_pairs) return;
  const int c = ptab[f];
  if (c < 0) return;
  const int rank = prank[f];
  const int pos = start[c] + rank;
  const int lane = threadIdx.x % 32;
  if (lane == 0) pair_at[pos] = f;
  if (ids != nullptr && rank == 0) {
    // from the cluster's end, four chunks (16 loads a lane) at a time
    const int* cid = ids + (size_t)c * cmax;
    int last = 0;  // warp-uniform
    for (int j1 = cmax / kRowChunk; j1 > 0 && last == 0; j1 -= 4) {
      int mx[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j1 - 1 - u;
        mx[u] = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j >= 0) mx[u] = max(mx[u], cid[j * kRowChunk + 32 * i + lane]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (last == 0 && __any_sync(0xffffffffu, mx[u] >= 0)) last = j1 - u;
    }
    if (lane == 0) nchunk[c] = last;
  }
  if (qform == 0) return;
  const size_t row = f / nprobe;
  if (qform == 2) {
    // eight values a lane-step: two float4 in, one int4 out per part
    const float4* src = reinterpret_cast<const float4*>(qsrc) + row * d / 4;
    for (int i = lane; i < d / 8; i += 32) {
      const float4 a = src[2 * i], b = src[2 * i + 1];
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      uint32_t part[kParts][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float r0 = v[2 * j], r1 = v[2 * j + 1];
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          const uint32_t h = f32x2_to_bf16x2(r0, r1);
          part[p][j] = h;
          r0 -= __uint_as_float(h << 16);  // exact: the residual of a rounding
          r1 -= __uint_as_float(h & 0xffff0000u);
        }
      }
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        int4* dst = reinterpret_cast<int4*>(qbuf) + ((size_t)kParts * pos + p) * d / 8;
        dst[i] = make_int4(part[p][0], part[p][1], part[p][2], part[p][3]);
      }
    }
    return;
  }
  const int esize = qform == 1 ? 1 : 4;
  const int4* src = reinterpret_cast<const int4*>(qsrc + row * d * esize);
  int4* dst = reinterpret_cast<int4*>(qbuf + (size_t)pos * d * esize);
  for (int i = lane; i < d * esize / 16; i += 32) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// 3. the scan: TMA ring + products + threshold-filtered candidate buffers
// ---------------------------------------------------------------------------
//
// One kernel body for every storage (scan_body<S>: S = 0 int8, 1 bf16, 2
// f32). The ring, the way the two consumer warpgroups share each row chunk,
// the candidate buffers, the exact selects, the published bounds and the
// final sort are the same; only the product stage and the query operand
// differ:
//   int8: the quantized query rows, spread over the four warps of M (warp
//         w's 16 rows hold queries w*m .. w*m + m - 1, m = ceil(nq / 4));
//         consumer c runs wgmma m64n64k32 s8 -> s32 on rows [64c, 64c + 64)
//         of every chunk with the queries as M and the rows as N, then the
//         reference's unfused f32 epilogue (query scale, row scale).
//   bf16: the f32 query split by scatter into three bf16 parts, hi =
//         bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid), which sum to
//         q exactly, written as three consecutive rows; with tiles of up to
//         20 queries (m <= 5), warp w's 16 M rows hold part p of its query l
//         at row 3l + p, so one wgmma m64n64k16 bf16 -> f32 a 16 of depth
//         reads the rows as TMA stored them (no conversion stage) and sums
//         every part at once; shuffles bring query l's three sums to lane
//         l, which adds hi + (mid + lo). A bf16 x bf16 product is exact in
//         f32, so a score sums the exact products of the f32 query and the
//         row, each part in its own accumulator row. Its row chunk takes
//         twice int8's stages, so two stages of products stay in flight.
//   f32:  exact f32 FMAs on the CUDA cores from the same ring (32 values of
//         depth a stage; tiles of up to 32 queries): consumer warp w (of 8)
//         takes rows 16w .. 16w + 15 of the chunk, lane l (b = l / 4, t = l
//         % 4) the rows 16w + t + 4i (i < 4) and the queries b + 8j (j <
//         ceil(nq / 8)). Only the order of the sum differs from the plain
//         version. The shared-memory loads that feed the FMAs, not the
//         stream, set its pace (PERF.md).
// The tiles' candidate pools leave room for 5 int8 stages of 24 KB, 7 bf16
// stages of 24 KB or 8 f32 stages of 20 KB. The epilogue's ids (and int8
// scales) arrive by bulk copies, up to four chunks ahead of the consumers.

constexpr int kQTile = 64;       // queries per int8 tile: wgmma M
constexpr int kBQueries = 20;    // queries per bf16 tile: 3 parts of 5 fill a warp's 16 M rows
constexpr int kFQueries = 32;    // queries per f32 tile
constexpr int kDepth = 128;      // bytes of depth per stage: one swizzle atom row
constexpr int kRowBytes = kRowChunk * kDepth;
constexpr int kQBytes = kQTile * kDepth;  // one 64-row M operand
constexpr int kStageBytes = kRowBytes + kQBytes;  // int8 and bf16
constexpr int kQBox = 16;        // int8/bf16 query rows per TMA box: one consumer warp's M rows
constexpr int kFBox = 8;         // f32 query rows per TMA box
constexpr int kPool = kQTile * 192;      // candidate entries of an int8 tile's queries
constexpr int kBPool = kBQueries * 192;  // of a bf16 tile's
constexpr int kFPool = kFQueries * 192;  // of an f32 tile's
constexpr int kCapMax = 384;     // candidate entries of one query
constexpr int kEpiSlots = 4;     // row chunks of ids/scales in flight
constexpr int kEpiBytes = kRowChunk * 8;
constexpr int kMiscBytes = 6144; // per-query state, barriers, select histograms
constexpr int kSmemAlign = 1024; // 128-byte swizzle atoms
constexpr int kSmemLimit = 232448;
constexpr int kScanThreads = 384;  // two consumer warpgroups + producer warpgroup
constexpr int kHalf = kRowChunk / 2;  // chunk rows of one consumer: wgmma N
constexpr int kBins = 128;       // histogram bins of one warp's select

__host__ __device__ constexpr int stage_bytes(int s) {
  return kRowBytes + (s == 2 ? kFQueries * kDepth : kQBytes);
}
__host__ __device__ constexpr int pool_entries(int s) {
  return s == 0 ? kPool : s == 1 ? kBPool : kFPool;
}
constexpr int smem_bytes_for(int s, int stages) {
  return kSmemAlign + stages * stage_bytes(s) + pool_entries(s) * 8 +
         kEpiSlots * kEpiBytes + kMiscBytes;
}
constexpr int max_stages(int s) {
  return (kSmemLimit - smem_bytes_for(s, 0)) / stage_bytes(s);
}

// a query's capacity is at least the pool / the tile, room for k and a chunk
static_assert(kPool / kQTile >= kMaxK + kRowChunk && kBPool / kBQueries >= kMaxK + kRowChunk &&
                  kFPool / kFQueries >= kMaxK + kRowChunk,
              "a chunk must fit after a merge");
static_assert(kParts * ((kBQueries + 3) / 4) <= kQBox, "a warp's query parts fit its M rows");
static_assert(max_stages(0) >= 3 && max_stages(1) >= 3 && max_stages(2) >= 3, "ring depth");
static_assert(6 * kQTile * 4 + 8 * kBins * 4 + (2 * max_stages(2) + 2 * kEpiSlots) * 8 <=
                  kMiscBytes,
              "per-query state, histograms and barriers");

// The consumer warpgroups' own barrier (id 1; id 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// consumer_sync that also tells every consumer thread whether any had `pred`
__device__ __forceinline__ bool consumer_any(bool pred) {
  int out;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, 256, p;\n"
      "selp.b32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(out) : "r"((int)pred) : "memory");
  return out != 0;
}

struct ScanArgs {
  const int* ids;        // (nlist * cmax,)
  const float* scales;   // (nlist * cmax,), int8 only
  const float* qsc;      // (Q,), int8 only
  const int* pair_at;    // pair of each bucket position
  const Tile* tiles;
  const int* hdr;
  const int* nchunk;     // (nlist,): row chunks of each cluster to stream
  float* out_s;          // (Q * nprobe, k): each pair's sorted list
  int* out_i;
  int* qthr;             // (Q,): each query's published bound, ordered bits
  int cmax, d, nprobe, k, stages;
};

// A float's bits as an int that orders as the float does (for atomicMax).
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// Per-query state of the tile being scanned, in shared memory, indexed by
// the query's state row: for int8 its M row (warp w's rows 16w + l hold the
// tile's queries w*m + l, m = ceil(nq / 4), so the queries of a small tile
// spread over the four consumer warps); for bf16/f32 warpgroup wg's row of
// tile query i is 16 wg + i, one buffer for each warpgroup.
struct QState {
  int* cnt;       // entries in the candidate buffer
  float* thr_s;   // the threshold: the k-th entry after the last merge
  int* thr_i;
  int* pair;      // q * nprobe + j of the row's query; -1: no query
  float* qsc;
  int* boff;      // the row's buffer: entries [boff, boff + cap) of the pool
};

// Bitonic sort of 64 (score, slot) keys held by a warp (element i * 32 +
// lane in register i), best first.
__device__ __forceinline__ void sort64(float (&s)[2], int (&r)[2], int lane) {
#pragma unroll
  for (int ls = 1; ls <= 6; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls, st = 1 << lt;
      if (st == 32) {
        // elements lane and lane + 32: one descending pair in register
        const bool swap = better(s[1], r[1], s[0], r[0]);
        const float ts = swap ? s[1] : s[0];
        const int tr = swap ? r[1] : r[0];
        s[1] = swap ? s[0] : s[1];
        r[1] = swap ? r[0] : r[1];
        s[0] = ts;
        r[0] = tr;
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float os = __shfl_xor_sync(0xffffffffu, s[i], st);
          const int orr = __shfl_xor_sync(0xffffffffu, r[i], st);
          const bool lower = (lane & st) == 0;
          const bool desc = ((i * 32 + lane) & size) == 0;
          const bool ob = better(os, orr, s[i], r[i]);
          if (lower == desc ? ob : !ob) { s[i] = os; r[i] = orr; }
        }
      }
    }
  }
}

// One warp keeps the best `keep` of buffer qb's n entries (keep < n <= 32 E),
// compacted in place to qb[0, keep) in no order, and returns the worst kept
// entry (the keep-th best) on every lane. Exact: a histogram over [min, max]
// of the scores (a bin never holds a better score than an earlier bin) finds
// the bin of the keep-th entry; the entries of that bin are ranked among
// themselves by (score, slot).
template <int E>
__device__ __forceinline__ void select_top(uint2* qb, int n, int keep, int* hist,
                                           int lane, float& ws, int& wr) {
  float s[E];
  int r[E];
  float hi = -INFINITY, lo = INFINITY;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = i * 32 + lane;
    const uint2 v = e < n ? qb[e] : make_uint2(0xff800000u, (unsigned)kNoSlot);
    s[i] = __uint_as_float(v.x);
    r[i] = (int)v.y;
    if (e < n) { hi = fmaxf(hi, s[i]); lo = fminf(lo, s[i]); }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  }
  const float scale = hi > lo ? (float)kBins / (hi - lo) : 0.f;
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) hist[j * 32 + lane] = 0;
  __syncwarp();
  int bin[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    // monotone in the score: (hi - s) and the product round monotonically
    bin[i] = s[i] >= hi ? 0 : min(kBins - 1, __float2int_rz((hi - s[i]) * scale));
    if (i * 32 + lane < n) atomicAdd(&hist[bin[i]], 1);
  }
  __syncwarp();
  // the first bin whose running count reaches keep: lane l scans bins 4l..4l+3
  int c[4], sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) { c[j] = hist[lane * 4 + j]; sum += c[j]; }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += x;
  }
  int cum = incl - sum, kbin = -1, above = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kbin < 0 && cum + c[j] >= keep) { kbin = lane * 4 + j; above = cum; }
    cum += c[j];
  }
  const int owner = __ffs(__ballot_sync(0xffffffffu, kbin >= 0)) - 1;
  kbin = __shfl_sync(0xffffffffu, kbin, owner);
  above = __shfl_sync(0xffffffffu, above, owner);
  const int need = keep - above;  // entries taken from the keep-th entry's bin
  // rank the entries of that bin among themselves
  int rank[E];
#pragma unroll
  for (int i = 0; i < E; ++i) rank[i] = 0;
#pragma unroll
  for (int ii = 0; ii < E; ++ii) {
    unsigned m = __ballot_sync(0xffffffffu, ii * 32 + lane < n && bin[ii] == kbin);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float os = __shfl_sync(0xffffffffu, s[ii], src);
      const int orr = __shfl_sync(0xffffffffu, r[ii], src);
#pragma unroll
      for (int i = 0; i < E; ++i) rank[i] += better(os, orr, s[i], r[i]);
    }
  }
  // compact the kept entries and find the worst of them
  bool kept[E];
  int at[E], base = 0;
  ws = INFINITY;
  wr = -1;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool valid = i * 32 + lane < n;
    kept[i] = valid && (bin[i] < kbin || (bin[i] == kbin && rank[i] < need));
    const unsigned m = __ballot_sync(0xffffffffu, kept[i]);
    at[i] = base + __popc(m & below);
    base += __popc(m);
    if (kept[i] && (wr < 0 || better(ws, wr, s[i], r[i]))) { ws = s[i]; wr = r[i]; }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (kept[i]) qb[at[i]] = make_uint2(__float_as_uint(s[i]), (unsigned)r[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, ws, off);
    const int orr = __shfl_xor_sync(0xffffffffu, wr, off);
    if (orr >= 0 && (wr < 0 || better(ws, wr, os, orr))) { ws = os; wr = orr; }
  }
  __syncwarp();
}

__device__ __forceinline__ void select_any(uint2* qb, int n, int keep, int* hist,
                                           int lane, float& ws, int& wr) {
  if (n <= 192) select_top<6>(qb, n, keep, hist, lane, ws, wr);
  else select_top<kCapMax / 32>(qb, n, keep, hist, lane, ws, wr);
}

// State row q's buffer could overflow with the next chunk: keep its k best,
// raise its threshold to the k-th, and publish the k-th's score as a bound
// for the query's other pairs.
__device__ __forceinline__ void merge_query(uint2* buf, int* hist, const QState& st,
                                            int q, const ScanArgs& p, int lane) {
  float ws;
  int wr;
  select_any(buf + st.boff[q], st.cnt[q], p.k, hist, lane, ws, wr);
  if (lane == 0) {
    st.thr_s[q] = ws;
    st.thr_i[q] = wr;
    st.cnt[q] = p.k;
    atomicMax(p.qthr + st.pair[q] / p.nprobe, ordered(ws));
  }
  __syncwarp();
}

// The cluster's end: row q's k best, sorted, out to its pair's list (ids
// from the slots; entries past the valid count -3e38 / -1).
__device__ __forceinline__ void finish_query(uint2* buf, int* hist, const QState& st,
                                             int q, const ScanArgs& p, const int* cids,
                                             int lane) {
  uint2* qb = buf + st.boff[q];
  int n = st.cnt[q];
  const bool full = n >= p.k;
  if (n > p.k) {
    float ws;
    int wr;
    select_any(qb, n, p.k, hist, lane, ws, wr);
    n = p.k;
  }
  float s[2];
  int r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = i * 32 + lane;
    const uint2 v = e < n ? qb[e] : make_uint2(0xff800000u, (unsigned)kNoSlot);
    s[i] = __uint_as_float(v.x);
    r[i] = (int)v.y;
  }
  sort64(s, r, lane);
  if (full) {  // the k-th entry bounds the query's final k-th from below
    const int hi = (p.k - 1) >= 32;
    const float ks = __shfl_sync(0xffffffffu, hi ? s[1] : s[0], (p.k - 1) & 31);
    if (lane == 0) atomicMax(p.qthr + st.pair[q] / p.nprobe, ordered(ks));
  }
  const size_t o = (size_t)st.pair[q] * p.k;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = i * 32 + lane;
    if (e < p.k) {
      const bool ok = e < n;
      p.out_s[o + e] = ok ? s[i] : kNeg;
      p.out_i[o + e] = ok ? cids[r[i]] : -1;
    }
  }
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu; x ^= x >> 16;
  return x;
}

// The measurement build's synthetic raw score of (pair, slot) (IVF_PROBE 2).
__device__ __forceinline__ int synthetic(int pair, int slot) {
  return (int)(mix32(pair * 40503u + slot) >> 16) - 32768;
}

// The scores s[b] (slots slot(b)) of state row q that pass (bit b of
// `pass`) go to its buffer. A quad's four threads share the row: the quad's
// count reserves room in the buffer (other warps append to it too) and two
// shuffles give each thread its offset. Called by the whole warp. Returns
// whether the buffer could overflow with the next chunk: it holds at most
// cap - 128 entries before a chunk, and a chunk adds at most 128.
template <int N, typename Slot>
__device__ __forceinline__ bool append_quad(uint2* buf, const QState& st, int q,
                                            bool live, uint32_t pass,
                                            const float (&s)[N], Slot slot, int t,
                                            int cap) {
  const int mine = live ? __popc(pass) : 0;
  int incl = mine;
  const int up1 = __shfl_up_sync(0xffffffffu, incl, 1, 4);
  if (t >= 1) incl += up1;
  const int up2 = __shfl_up_sync(0xffffffffu, incl, 2, 4);
  if (t >= 2) incl += up2;
  const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
  int base = 0;
  if (t == 0 && total > 0) base = atomicAdd(&st.cnt[q], total);
  base = __shfl_sync(0xffffffffu, base, 0, 4);
  if (mine) {
    uint2* dst = buf + st.boff[q] + base + incl - mine;
#pragma unroll
    for (int b = 0; b < N; ++b)
      if ((pass >> b) & 1) *dst++ = make_uint2(__float_as_uint(s[b]), (unsigned)slot(b));
  }
  return total > 0 && base + total > cap - kRowChunk;
}

// The row's threshold, raised to the published bound of its query: another
// pair of the query has k entries at or above it, so a score below it cannot
// reach the query's top k (ties at it still pass).
__device__ __forceinline__ void threshold(const QState& st, int q, int bound,
                                          float& ts, int& ti) {
  ts = st.thr_s[q];
  ti = st.thr_i[q];
  if (bound != INT_MIN && unordered(bound) > ts) {
    ts = unordered(bound);
    ti = kNoSlot;
  }
}

// Tile query i's state row: for int8 and bf16 its M row (queries spread over
// the four consumer warps, m = ceil(nq / 4) each), for f32 i.
template <int S>
__device__ __forceinline__ int state_row(int i, int m) {
  return S == 2 ? i : (i / m) * 16 + i % m;
}

// int8 and bf16: offer one consumer's 64 rows of a chunk (rows row0 + 8j +
// 2t + c) for M rows warp*16 + g and + 8 (`halves` bit i: this warp has live
// rows g + 8i), from the accumulator: element acc[4j + 2i + c] is M row
// warp*16 + g + 8i, chunk row 8j + 2t + c (g = lane / 4, t = lane % 4).
// int8 scores are (raw * qsc) * scale, unfused as the reference computes
// them; bf16 scores are the accumulator (after combine_parts). `bound` holds
// the rows' published query bounds. Returns whether a buffer this thread
// appended to could overflow with the next chunk.
template <typename T>
__device__ __forceinline__ bool offer_chunk(const T (&acc)[32], uint32_t valid,
                                            const float (&sc)[16], uint2* buf,
                                            const QState& st, const int (&bound)[2],
                                            int cap, int row0, int warp, int lane,
                                            int halves) {
  constexpr bool kInt8 = std::is_same<T, int>::value;
  const int g = lane / 4, t = lane % 4;
  bool flagged = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!((halves >> i) & 1)) continue;  // warp-uniform
    const int q = warp * 16 + g + 8 * i;
    const int pair = st.pair[q];
    const float qs = st.qsc[q];
    float ts;
    int ti;
    threshold(st, q, bound[i], ts, ti);
    float s[16];
    uint32_t pass = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int slot = row0 + 8 * j + 2 * t + c;
        float v;
        if constexpr (kInt8) {
          const int raw = IVF_PROBE == 2 ? synthetic(pair, slot) : acc[4 * j + 2 * i + c];
          v = __fmul_rn(__fmul_rn(__int2float_rn(raw), qs), sc[2 * j + c]);
        } else {
          v = IVF_PROBE == 2 ? __int2float_rn(synthetic(pair, slot)) : acc[4 * j + 2 * i + c];
        }
        s[2 * j + c] = v;
        if (((valid >> (2 * j + c)) & 1) && better(v, slot, ts, ti))
          pass |= 1u << (2 * j + c);
      }
    }
    flagged |= append_quad(buf, st, q, pair >= 0, pass, s,
                           [&](int b) { return row0 + 8 * (b >> 1) + 2 * t + (b & 1); },
                           t, cap);
  }
  return flagged;
}

// bf16: M row 16w + 3l + p of the accumulator holds part p of the warp's
// query l (lane (g, t) holds M rows g and g + 8: acc[4j + c] and acc[4j + 2 +
// c]); lane (l, t) gets query l's hi + (mid + lo) in acc[4j + c]. Lanes past
// the warp's queries get values that nothing reads.
__device__ __forceinline__ void combine_parts(float (&acc)[32], int lane) {
  const int g = lane / 4, t = lane % 4;
  int src[kParts];
  bool upper[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const int r = (kParts * g + p) & 15;
    src[p] = (r & 7) * 4 + t;
    upper[p] = r >= 8;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float h0 = acc[4 * j + c], h1 = acc[4 * j + 2 + c];
      float part[kParts];
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const float v0 = __shfl_sync(0xffffffffu, h0, src[p]);
        const float v1 = __shfl_sync(0xffffffffu, h1, src[p]);
        part[p] = upper[p] ? v1 : v0;
      }
      acc[4 * j + c] = __fadd_rn(part[0], __fadd_rn(part[1], part[2]));
    }
  }
}

// f32: lane (b, t) of consumer warp w scores queries b + 8j (j < QJ) against
// chunk rows 16w + t + 4i (i < 4): acc[j][i]. One 32-value depth stage:
// every shared load of a warp reads distinct swizzle columns (one wavefront
// a quarter warp) and feeds 4 QJ (rows) or 16 (queries) FMAs.
template <int QJ>
__device__ __forceinline__ void ffma_stage(const uint8_t* stage, int w, int t, int b,
                                           float (&acc)[4][4]) {
  const uint32_t rows = smem_u32(stage), qs = smem_u32(stage + kRowBytes);
#pragma unroll
  for (int c = 0; c < kDepth / 16; ++c) {
    float4 rv[4], qv[QJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t a = rows + sw128_offset(16 * w + t + 4 * i, c);
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(rv[i].x), "=f"(rv[i].y), "=f"(rv[i].z), "=f"(rv[i].w) : "r"(a));
    }
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const uint32_t a = qs + sw128_offset(b + 8 * j, c);
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(qv[j].x), "=f"(qv[j].y), "=f"(qv[j].z), "=f"(qv[j].w) : "r"(a));
    }
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[j][i] = fmaf(qv[j].x, rv[i].x, acc[j][i]);
        acc[j][i] = fmaf(qv[j].y, rv[i].y, acc[j][i]);
        acc[j][i] = fmaf(qv[j].z, rv[i].z, acc[j][i]);
        acc[j][i] = fmaf(qv[j].w, rv[i].w, acc[j][i]);
      }
    }
  }
}

// f32: offer this lane's scores (see ffma_stage): query b + 8j is state row
// b + 8j; `valid` bit i: chunk row 16w + t + 4i holds an id.
__device__ __forceinline__ bool offer_ffma(const float (&acc)[4][4], int qj,
                                           uint32_t valid, uint2* buf, const QState& st,
                                           const int (&bound)[4], int cap, int row0,
                                           int w, int lane) {
  const int b = lane / 4, t = lane % 4;
  bool flagged = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= qj) break;  // warp-uniform
    const int q = b + 8 * j;
    const int pair = st.pair[q];
    float ts;
    int ti;
    threshold(st, q, bound[j], ts, ti);
    float s[4];
    uint32_t pass = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int slot = row0 + 16 * w + t + 4 * i;
      s[i] = IVF_PROBE == 2 ? __int2float_rn(synthetic(pair, slot)) : acc[j][i];
      if (((valid >> i) & 1) && better(s[i], slot, ts, ti)) pass |= 1u << i;
    }
    flagged |= append_quad(buf, st, q, pair >= 0, pass, s,
                           [&](int i) { return row0 + 16 * w + t + 4 * i; }, t, cap);
  }
  return flagged;
}

template <int S>
__device__ __forceinline__ void scan_body(const CUtensorMap* rows_map,
                                          const CUtensorMap* q_map, const ScanArgs& p) {
  constexpr int kStage = stage_bytes(S);
  constexpr int kElems = S == 0 ? kDepth : S == 1 ? kDepth / 2 : kDepth / 4;  // a stage's depth
  constexpr int kLag = S == 1 ? 2 : 1;  // wgmma stages in flight past the newest
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
      ~uintptr_t(kSmemAlign - 1));
  const int stages = p.stages;
  // stage s: rows [0, 16K), then the tile's queries: int8 and bf16 one
  // 64-row M operand (8K, four 16-row boxes), f32 32 rows of 32 values
  uint2* buf = reinterpret_cast<uint2*>(smem + stages * kStage);
  int* epi = reinterpret_cast<int*>(smem + stages * kStage + pool_entries(S) * 8);
  int* misc = epi + kEpiSlots * kEpiBytes / 4;
  const QState st{misc, reinterpret_cast<float*>(misc + kQTile), misc + 2 * kQTile,
                  misc + 3 * kQTile, reinterpret_cast<float*>(misc + 4 * kQTile),
                  misc + 5 * kQTile};
  int* hist_all = misc + 6 * kQTile;  // a select histogram per consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(hist_all + 8 * kBins);
  uint64_t* empty = full + stages;
  uint64_t* epi_full = empty + stages;
  uint64_t* epi_empty = epi_full + kEpiSlots;
  const int n_tiles = p.hdr[0];
  const int n_k = p.d / kElems;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    for (int e = 0; e < kEpiSlots; ++e) {
      mbar_init(epi_full + e, 1);
      mbar_init(epi_empty + e, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = (threadIdx.x - 256) / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
#if IVF_PROBE == 3
      long long waited = 0, begun = clock64();
#endif
      int pos = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = p.tiles[t];
        const int row_base = tl.cluster * p.cmax;
        const int m = (tl.nq + 3) / 4;  // queries of each consumer warp (wgmma)
        // the query boxes of each stage: int8 and bf16 four of 16 rows at
        // the warps' M rows (bf16: a query's three parts are three rows);
        // f32 ceil(nq / 8) of 8 rows, the tile's queries in order
        const int nbox = (tl.nq + kFBox - 1) / kFBox;
        const int bytes = S == 2 ? kRowBytes + nbox * kFBox * kDepth : kStageBytes;
        const int n_rc = p.nchunk[tl.cluster];
        for (int rc = 0; rc < n_rc; ++rc) {
          for (int kc = 0; kc < n_k; ++kc, ++pos) {
            const int s = pos % stages;
#if IVF_PROBE == 3
            const long long w0 = clock64();
            mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
            waited += clock64() - w0;
#else
            mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
#endif
            mbar_expect_tx(full + s, bytes);
            uint8_t* dst = smem + s * kStage;
            tma_load(dst, rows_map, full + s, kc * kElems, row_base + rc * kRowChunk);
            if constexpr (S == 2) {
              for (int b = 0; b < nbox; ++b)
                tma_load(dst + kRowBytes + b * kFBox * kDepth, q_map, full + s,
                         kc * kElems, tl.pos0 + b * kFBox);
            } else {
              for (int w = 0; w < 4; ++w)
                tma_load(dst + kRowBytes + w * kQBox * kDepth, q_map, full + s,
                         kc * kElems, (S == 1 ? kParts : 1) * (tl.pos0 + w * m));
            }
          }
        }
      }
#if IVF_PROBE == 3
      atomicAdd(&g_phase[S][7], (unsigned long long)waited);
      atomicAdd(&g_phase[S][8], (unsigned long long)(clock64() - begun));
#endif
    } else if (warp == 1 && lane == 0) {
      // ids (and int8 scales) of each row chunk, by bulk copies into the
      // epilogue slots, up to kEpiSlots chunks ahead of the consumers
      int n = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = p.tiles[t];
        const size_t row_base = (size_t)tl.cluster * p.cmax;
        const int n_rc = p.nchunk[tl.cluster];
        for (int rc = 0; rc < n_rc; ++rc, ++n) {
          const int e = n % kEpiSlots;
          mbar_wait(epi_empty + e, ((n / kEpiSlots) & 1) ^ 1);
          int* dst = epi + e * (kEpiBytes / 4);
          const size_t slot = row_base + rc * kRowChunk;
          mbar_expect_tx(epi_full + e, (S == 0 ? 2 : 1) * kRowChunk * 4);
          bulk_load(dst, p.ids + slot, kRowChunk * 4, epi_full + e);
          if (S == 0) bulk_load(dst + kRowChunk, p.scales + slot, kRowChunk * 4, epi_full + e);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: every row chunk of the tile's cluster, for
  // all the tile's queries; int8/bf16: consumer c takes rows [64c, 64c + 64)
  // by wgmma; f32: warp w (of 8) rows [16w, 16w + 16) by FMAs ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x, lane = tid % 32;
  const int cw = tid / 128, warp = (tid / 32) % 4, gw = tid / 32;
  const int t4 = lane % 4;
  int* hist = hist_all + gw * kBins;
  using Acc = typename std::conditional<S == 0, int, float>::type;
  Acc acc[32];       // int8 / bf16: the wgmma accumulator
  float facc[4][4];  // f32
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  int pos = 0, n = 0;
#if IVF_PROBE == 3
  long long phase[6] = {0, 0, 0, 0, 0, 0};
#endif
  PHASE_CLOCK;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = p.tiles[t];
    const int nq = tl.nq, m = (nq + 3) / 4;
    const int qj = (nq + 7) / 8;  // f32: query sets of 8
    const int n_rc = p.nchunk[tl.cluster];  // chunks past it hold no valid slot
    // a query's buffer: as much of the pool as the tile's queries leave
    const int cap = min(kCapMax, (pool_entries(S) / nq) & ~31);
    const int* cids = p.ids + (size_t)tl.cluster * p.cmax;
    if (tid < kQTile) {
      int i;
      bool live;
      if (S == 2) {
        i = tid;
        live = i < nq;
      } else {
        const int l = tid % 16;
        i = (tid / 16) * m + l;
        live = l < m && i < nq;
      }
      const int pr = live ? p.pair_at[tl.pos0 + i] : -1;
      st.cnt[tid] = 0;
      st.thr_s[tid] = kNeg;  // every valid score beats (-3e38, no slot)
      st.thr_i[tid] = kNoSlot;
      st.pair[tid] = pr;
      st.qsc[tid] = S == 0 && live ? p.qsc[pr / p.nprobe] : 0.f;
      st.boff[tid] = live ? i * cap : 0;
    }
    // wgmma: this warp's live rows, g for the first m_w (half 0), g + 8 past 8
    const int m_w = max(0, min(m, nq - warp * m));
    const int halves = (m_w > 0 ? 1 : 0) | (m_w > 8 ? 2 : 0);
    bool pending = false;  // some buffer must merge before the next chunk
    consumer_sync();
    PHASE(5);
    for (int rc = 0; rc < n_rc; ++rc, ++n) {
      // the bounds other CTAs published for this thread's state rows, read
      // from L2 while the products run
      int bound[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (S != 2 && i == 2) break;
        const int q = S == 2 ? lane / 4 + 8 * i : warp * 16 + lane / 4 + 8 * i;
        const int pr = st.pair[q];
        bound[i] = pr >= 0 ? __ldcg(p.qthr + pr / p.nprobe) : INT_MIN;
      }
      if constexpr (S == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) facc[j][i] = 0.f;
        for (int kc = 0; kc < n_k; ++kc) {
          const int at = pos + kc, s = at % stages;
          mbar_wait(full + s, (at / stages) & 1);
          if (IVF_PROBE != 2) {
            const uint8_t* stage = smem + s * kStage;
            switch (qj) {  // warp-uniform
              case 1: ffma_stage<1>(stage, gw, t4, lane / 4, facc); break;
              case 2: ffma_stage<2>(stage, gw, t4, lane / 4, facc); break;
              case 3: ffma_stage<3>(stage, gw, t4, lane / 4, facc); break;
              default: ffma_stage<4>(stage, gw, t4, lane / 4, facc); break;
            }
          }
          mbar_arrive(empty + s);
        }
      } else {
        for (int kc = 0; kc < n_k; ++kc) {
          const int at = pos + kc, s = at % stages;
          mbar_wait(full + s, (at / stages) & 1);
          if (IVF_PROBE != 2) {
            const uint8_t* stage = smem + s * kStage;
            const uint64_t a = sw128_desc(stage + kRowBytes);
            const uint64_t b = sw128_desc(stage + cw * kHalf * kDepth);
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kDepth / 32; ++kk)
              wgmma_step(acc, a + 2 * kk, b + 2 * kk, (kc | kk) != 0);
            wgmma_commit();
            // at most kLag depth chunks' products in flight: int8 the one
            // just issued, bf16 (twice the chunks a row chunk) one more
            wgmma_wait<kLag>();
            fence_acc(acc);
          }
          if (kc >= kLag) mbar_arrive(empty + (at - kLag) % stages);
        }
        if (IVF_PROBE != 2) {
          wgmma_wait<0>();
          fence_acc(acc);
        }
        for (int kc = max(0, n_k - kLag); kc < n_k; ++kc)
          mbar_arrive(empty + (pos + kc) % stages);
        if constexpr (S == 1) {
          if (IVF_PROBE != 2) combine_parts(acc, lane);
        }
      }
      pos += n_k;
      PHASE(0);

      if (pending) {
        // the merges of the buffers that could overflow, spread over the
        // eight consumer warps, while the ring refills
        for (int i = gw; i < nq; i += 8) {
          const int q = state_row<S>(i, m);
          if (st.cnt[q] > cap - kRowChunk) merge_query(buf, hist, st, q, p, lane);
        }
        consumer_sync();
      }
      PHASE(1);
      const int e = n % kEpiSlots;
      mbar_wait(epi_full + e, (n / kEpiSlots) & 1);
      PHASE(2);
      bool flagged = false;
      if (IVF_PROBE != 1) {
        const int* eid = epi + e * (kEpiBytes / 4);
        if constexpr (S == 2) {
          uint32_t valid = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            valid |= (uint32_t)(eid[16 * gw + t4 + 4 * i] >= 0) << i;
          if (__any_sync(0xffffffffu, valid != 0))
            flagged = offer_ffma(facc, qj, valid, buf, st, bound, cap, rc * kRowChunk,
                                 gw, lane);
        } else {
          // this thread's rows 64c + 8j + 2t + cc: valid bits (and scales)
          eid += cw * kHalf;
          const float* esc = reinterpret_cast<const float*>(eid + kRowChunk);
          uint32_t valid = 0;
          float sc[16];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int2 id2 = *reinterpret_cast<const int2*>(eid + 8 * j + 2 * t4);
            valid |= (uint32_t)(id2.x >= 0) << (2 * j);
            valid |= (uint32_t)(id2.y >= 0) << (2 * j + 1);
            if constexpr (S == 0) {
              const float2 s2 = *reinterpret_cast<const float2*>(esc + 8 * j + 2 * t4);
              sc[2 * j] = s2.x;
              sc[2 * j + 1] = s2.y;
            }
          }
          // rows of empty slots (the cluster's unfilled tail) offer nothing
          const int bnd[2] = {bound[0], bound[1]};
          if (__any_sync(0xffffffffu, valid != 0))
            flagged = offer_chunk(acc, valid, sc, buf, st, bnd, cap,
                                  rc * kRowChunk + cw * kHalf, warp, lane, halves);
        }
      }
      mbar_arrive(epi_empty + e);
      PHASE(3);
      pending = consumer_any(flagged);
      PHASE(4);
    }
    // the cluster's end: every query's final merge, written to its pair
    if (IVF_PROBE != 1) {
      for (int i = gw; i < nq; i += 8)
        finish_query(buf, hist, st, state_row<S>(i, m), p, cids, lane);
    }
    consumer_sync();
    PHASE(5);
  }
#if IVF_PROBE == 3
  if (lane == 0) {
    for (int i = 0; i < 6; ++i) atomicAdd(&g_phase[S][i], (unsigned long long)phase[i]);
    atomicAdd(&g_phase[S][6], (unsigned long long)(phase_t - phase_0));
  }
#endif
}

__global__ void __launch_bounds__(kScanThreads, 1)
ivf_scan_s8(const __grid_constant__ CUtensorMap rows_map,
            const __grid_constant__ CUtensorMap q_map, const ScanArgs p) {
  scan_body<0>(&rows_map, &q_map, p);
}

__global__ void __launch_bounds__(kScanThreads, 1)
ivf_scan_bf16(const __grid_constant__ CUtensorMap rows_map,
              const __grid_constant__ CUtensorMap q_map, const ScanArgs p) {
  scan_body<1>(&rows_map, &q_map, p);
}

__global__ void __launch_bounds__(kScanThreads, 1)
ivf_scan_f32(const __grid_constant__ CUtensorMap rows_map,
             const __grid_constant__ CUtensorMap q_map, const ScanArgs p) {
  scan_body<2>(&rows_map, &q_map, p);
}

// ---------------------------------------------------------------------------
// 4. merge: each query's per-pair lists -> its top k
// ---------------------------------------------------------------------------

constexpr int kMergeSmemMax = 49152;

// One warp per query: its lists' scores staged in shared memory, lane l
// holding the heads of lists l, l + 32, l + 64 and l + 96; each output is the
// warp's arg-max by (score desc, cluster asc) (a list's own entries come in
// its order, so list position breaks no tie between lists).
__global__ void ivf_merge(const float* __restrict__ part_s,
                          const int* __restrict__ part_i,
                          const int* __restrict__ ptab, float* __restrict__ out_s,
                          int* __restrict__ out_i, int nq, int nprobe, int k) {
  extern __shared__ float msm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * (blockDim.x / 32) + warp;
  if (q >= nq) return;
  float* sc = msm + (size_t)warp * nprobe * k;
  const size_t base = (size_t)q * nprobe;
  // every list's scores (a skipped probe's are never read): loads in flight
#pragma unroll 16
  for (int x = lane; x < nprobe * k; x += 32) sc[x] = part_s[base * k + x];
  int cl[4], at[4];
  float head[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    cl[m] = j < nprobe ? ptab[base + j] : -1;
    at[m] = 0;
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m)
    head[m] = cl[m] >= 0 ? sc[(lane + 32 * m) * k] : -INFINITY;

  // a list's key: cluster * 128 + list (clusters are distinct among a
  // query's lists and below 2^24, as nlist * cmax < 2^31 with cmax >= 128)
  int key[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) key[m] = cl[m] * kMaxProbe + lane + 32 * m;
  float out0 = kNeg, out1 = kNeg;
  int id0 = -1, id1 = -1;
  for (int r = 0; r < k; ++r) {
    float bs = -INFINITY;
    int bk = kNoSlot;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (head[m] > -INFINITY && better(head[m], key[m], bs, bk)) {
        bs = head[m];
        bk = key[m];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      if (better(os, ok, bs, bk)) { bs = os; bk = ok; }
    }
    if (bk == kNoSlot) break;  // every list is exhausted: the tail stays empty
    const int bj = bk % kMaxProbe;
    // the winner's position in its list, from the lane that holds it
    const int owner = bj & 31, wm = bj >> 5;
    int wp = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m == wm) wp = at[m];
    wp = __shfl_sync(0xffffffffu, wp, owner);
    if (r == lane || r == lane + 32) {
      const bool ok = bs > kNeg;
      const int id = ok ? part_i[(base + bj) * k + wp] : -1;
      if (r == lane) { out0 = ok ? bs : kNeg; id0 = id; }
      else { out1 = ok ? bs : kNeg; id1 = id; }
    }
    if (lane == owner) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (m == wm) {
          at[m] += 1;
          head[m] = at[m] < k ? sc[bj * k + at[m]] : -INFINITY;
        }
      }
    }
  }
  const size_t o = (size_t)q * k;
  if (lane < k) { out_s[o + lane] = out0; out_i[o + lane] = id0; }
  if (lane + 32 < k) { out_s[o + lane + 32] = out1; out_i[o + lane + 32] = id1; }
}

// Raise kernel K's dynamic shared-memory limit to `bytes`, once per device.
template <auto K>
cudaError_t raise_smem_once(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// Pair bookkeeping: ivf_prep (one block), then ivf_scatter on
// `gather_blocks` blocks. probes: (nq, nprobe) int32 (probes64 = 0) or
// int64; tile_q: queries per tile (64 for the int8 scan, 20 for bf16, 32
// for f32; any up to 64); count: nlist ints. qform (see ivf_scatter): how the (nq, d) query
// rows qsrc go into qbuf in pair order (0: not at all); with ids ((nlist,
// cmax) int32) each probed cluster's chunk count goes to nchunk (nlist ints).
extern "C" int semcode_ivf_prep(const void* probes, int probes64, int nq,
                                int nprobe, int nlist, int tile_q, int* ptab,
                                int* prank, int* pair_at, int* count,
                                void* tiles, int* hdr, int* qthr, int qform,
                                const void* qsrc, int d, void* qbuf,
                                const int* ids, int cmax, int* nchunk,
                                int gather_blocks, void* stream) {
  if (nq <= 0 || nprobe <= 0 || nprobe > kMaxProbe || nlist <= 0 ||
      tile_q <= 0 || tile_q > kQTile ||
      (long long)nq * nprobe * kParts > 0x7fffffffLL || qform < 0 || qform > 3 ||
      (qform != 0 && (d <= 0 || d % 128 != 0 || qsrc == nullptr || qbuf == nullptr ||
                      (reinterpret_cast<uintptr_t>(qsrc) |
                       reinterpret_cast<uintptr_t>(qbuf)) % 16)) ||
      (ids != nullptr && (cmax <= 0 || cmax % kRowChunk != 0 || nchunk == nullptr)) ||
      gather_blocks <= 0 ||
      (long long)gather_blocks * kGatherRows < (long long)nq * nprobe)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Tile* t = static_cast<Tile*>(tiles);
  if (probes64)
    ivf_prep<long long><<<1, kPrepThreads, 0, s>>>(
        static_cast<const long long*>(probes), nq, nprobe, nlist, tile_q, ptab,
        prank, count, t, hdr, qthr);
  else
    ivf_prep<int><<<1, kPrepThreads, 0, s>>>(
        static_cast<const int*>(probes), nq, nprobe, nlist, tile_q, ptab,
        prank, count, t, hdr, qthr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ivf_scatter<<<gather_blocks, 32 * kGatherRows, 0, s>>>(
      ptab, prank, count, nq * nprobe, nprobe, pair_at, qform,
      static_cast<const uint8_t*>(qsrc), d, static_cast<uint8_t*>(qbuf), ids, cmax,
      nchunk);
  return cudaGetLastError();
}

// The scan of every tile, each cluster up to its nchunk (from the prep with
// ids), as `grid` persistent CTAs with `stages` ring stages and exactly
// smem_bytes_for(storage, stages) bytes of shared memory. storage 0 (int8),
// 1 (bf16) or 2 (f32) rows in `data`; `queries` is the prep's pair-ordered
// query buffer of its qform 1, 2 or 3 (n_pairs = nq * nprobe rows, three
// rows a pair for bf16); scales and qsc are read for int8 only. Tiles hold
// at most 64 (int8), 20 (bf16) or 32 (f32) queries.
extern "C" int semcode_ivf_scan(const void* data, const int* ids,
                                const float* scales, const void* queries,
                                const float* qsc, const int* pair_at,
                                const void* tiles, const int* hdr,
                                const int* nchunk, float* out_s, int* out_i,
                                int* qthr, int nlist, int cmax, int d,
                                int n_pairs, int nprobe, int k, int storage,
                                int grid, int stages, int smem_bytes,
                                void* stream) {
  if (nlist <= 0 || cmax <= 0 || cmax % kRowChunk != 0 || d <= 0 ||
      d % 128 != 0 || nprobe <= 0 || nprobe > kMaxProbe || k <= 0 ||
      k > kMaxK || n_pairs <= 0 || grid <= 0 || storage < 0 || storage > 2 ||
      (long long)nlist * cmax > 0x7fffffffLL ||
      (long long)n_pairs * kParts > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (stages < 2 || stages > max_stages(storage) ||
      smem_bytes != smem_bytes_for(storage, stages) ||
      (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(queries) |
       reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(scales)) % 16 ||
      (storage == 0 && (scales == nullptr || qsc == nullptr)))
    return cudaErrorInvalidValue;
  const CUtensorMapDataType type = storage == 0 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : storage == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // the query buffer: int8 boxes of 16 rows; bf16 three rows a pair (its
  // parts), boxes of 16 rows; f32 boxes of 8
  const long long q_rows = storage == 1 ? (long long)kParts * n_pairs : n_pairs;
  CUtensorMap rows_map, q_map;
  if (!tile_map(&rows_map, type, data, d, (long long)nlist * cmax, kRowChunk) ||
      !tile_map(&q_map, type, queries, d, q_rows, storage == 2 ? kFBox : kQBox))
    return cudaErrorInvalidValue;
  const ScanArgs args{ids, scales, qsc, pair_at, static_cast<const Tile*>(tiles),
                      hdr, nchunk, out_s, out_i, qthr, cmax, d, nprobe, k, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (storage) {
    case 0:
      err = raise_smem_once<ivf_scan_s8>(kSmemLimit);
      if (err != cudaSuccess) return err;
      ivf_scan_s8<<<grid, kScanThreads, smem_bytes, s>>>(rows_map, q_map, args);
      break;
    case 1:
      err = raise_smem_once<ivf_scan_bf16>(kSmemLimit);
      if (err != cudaSuccess) return err;
      ivf_scan_bf16<<<grid, kScanThreads, smem_bytes, s>>>(rows_map, q_map, args);
      break;
    default:
      err = raise_smem_once<ivf_scan_f32>(kSmemLimit);
      if (err != cudaSuccess) return err;
      ivf_scan_f32<<<grid, kScanThreads, smem_bytes, s>>>(rows_map, q_map, args);
      break;
  }
  return cudaGetLastError();
}

// The scan kernel of `storage`: its registers a thread and local memory
// (spills) a thread, from the loaded module (attrs[0], attrs[1]).
extern "C" int semcode_ivf_scan_attributes(int storage, int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = storage == 0   ? cudaFuncGetAttributes(&a, ivf_scan_s8)
                    : storage == 1 ? cudaFuncGetAttributes(&a, ivf_scan_bf16)
                    : storage == 2 ? cudaFuncGetAttributes(&a, ivf_scan_f32)
                                   : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  return cudaSuccess;
}

// The phase build's cycle counts of `storage` (kPhases of them, see PHASE)
// since the last read, into out; other builds refuse.
extern "C" int semcode_ivf_phases(int storage, unsigned long long* out) {
#if IVF_PROBE == 3
  if (storage < 0 || storage > 2) return cudaErrorInvalidValue;
  unsigned long long all[3][kPhases];
  cudaError_t err = cudaMemcpyFromSymbol(all, g_phase, sizeof(all));
  if (err != cudaSuccess) return err;
  for (int i = 0; i < kPhases; ++i) out[i] = all[storage][i];
  static const unsigned long long zero[3][kPhases] = {};
  return cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
#else
  (void)storage;
  (void)out;
  return cudaErrorInvalidValue;
#endif
}

// Each query's per-pair lists (n_pairs, k) -> (nq, k), `warps` queries per
// block of `warps` * 32 threads with smem_bytes = warps * nprobe * k * 4.
extern "C" int semcode_ivf_merge(const float* part_s, const int* part_i,
                                 const int* ptab, float* out_s, int* out_i,
                                 int nq, int nprobe, int k, int warps,
                                 int smem_bytes, void* stream) {
  if (nq <= 0 || nprobe <= 0 || nprobe > kMaxProbe || k <= 0 || k > kMaxK ||
      warps <= 0 || warps > 32 || smem_bytes != warps * nprobe * k * 4 ||
      smem_bytes > kMergeSmemMax)
    return cudaErrorInvalidValue;
  const int blocks = (nq + warps - 1) / warps;
  ivf_merge<<<blocks, 32 * warps, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      part_s, part_i, ptab, out_s, out_i, nq, nprobe, k);
  return cudaGetLastError();
}
