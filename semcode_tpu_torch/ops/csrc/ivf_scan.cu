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
// 2.7e10 useful int8 operations (0.014 ms). So the design streams the probed
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
//    to 64 (int8) or 32 (float) queries, in cluster order.
// 2. ivf_scatter: each pair into its bucket and, for int8, its quantized
//    query row into a pair-ordered buffer, so that a tile's queries are
//    contiguous rows for TMA; the first pair of each bucket finds the
//    cluster's last 128-slot chunk that holds a valid id.
// 3. the scan. int8 (ivf_scan_s8): persistent warp-specialised CTAs walk the
//    tile list (CTA b takes tiles b, b + grid, ..., so the tiles of one
//    cluster run together and re-read it from L2). A producer warp streams
//    128-byte depth chunks of each 128-row chunk of the cluster, up to its
//    last valid one, and of the tile's query rows in four 16-row boxes, by
//    TMA (128-byte swizzle) into an
//    mbarrier ring; a second producer warp loads each row chunk's ids and
//    scales with coalesced loads. Two consumer warpgroups each run wgmma
//    m64n64k32 s8 on half of the chunk's rows, with the queries as M and the
//    rows as N, then the epilogue, unfused as the reference computes it. A
//    small tile's queries are spread over the four warps of M (warp w's rows
//    hold queries w*m .. w*m + m - 1, m = ceil(nq / 4)), so each warp filters
//    a share. Selection: every query keeps its k-th (score, slot) as a
//    threshold; a score that beats it is appended to the query's candidate
//    buffer in shared memory (a share of one pool, up to 384 entries). Before
//    a chunk could overflow a buffer, and at the cluster's end, one warp
//    selects the buffer's k best exactly (a histogram of the scores finds the
//    k-th's bin, whose entries are ranked by (score, slot)) and raises the
//    threshold; the eight consumer warps share these selects, and a final
//    64-key bitonic sort orders each pair's list. Each select also publishes
//    its k-th score as a bound on the query's final k-th (atomicMax per
//    query): the query's pairs scanned later filter against it too, so their
//    buffers stay small. Ties at a bound pass, so the merged top-k is exact
//    and the same whichever CTA publishes first; only the per-pair lists,
//    which nothing returns, shorten. bf16/f32 (ivf_scan_f): one
//    block of 256 threads per tile of 32 queries, the f32 dot on the CUDA
//    cores (the reference scores float rows against the f32 query) and a
//    per-query top-k list in registers; its redesign on hopper.cuh's TMA
//    ring and bf16 conversion stage is still to come.
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

#include "hopper.cuh"

// Measurement builds of the int8 scan (ops/ivf_scan.PROBE_LIBRARIES, timed by
// chip_smoke.py): -DIVF_PROBE=1 keeps the ring and the products and skips
// the selection; -DIVF_PROBE=2 keeps the ring and runs the selection on
// synthetic scores (a hash of (pair, slot)) with no products. Their outputs
// are meaningless.
#ifndef IVF_PROBE
#define IVF_PROBE 0
#endif

namespace {

using namespace hopper;

constexpr int kMaxK = 64;
constexpr int kMaxProbe = 128;
constexpr int kRowChunk = 128;   // cluster slots per streamed chunk: wgmma N
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

// Each valid pair f into its bucket, pair_at[start[c] + rank] = f, and with
// qq (int8 storage) its quantized query row into qbuf at the same position:
// a warp a pair. With ids, the bucket's first pair also writes nchunk[c]:
// the 128-slot chunks of cluster c up to its last valid slot (0: none). A
// layout packs each cluster's rows at the front of its block, so the scan
// streams no empty tail.
__global__ void __launch_bounds__(32 * kGatherRows)
ivf_scatter(const int* __restrict__ ptab, const int* __restrict__ prank,
            const int* __restrict__ start, int n_pairs, int nprobe,
            int* __restrict__ pair_at, const uint8_t* __restrict__ qq, int d,
            uint8_t* __restrict__ qbuf, const int* __restrict__ ids, int cmax,
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
  if (qq == nullptr) return;
  const int4* src = reinterpret_cast<const int4*>(qq + (size_t)(f / nprobe) * d);
  int4* dst = reinterpret_cast<int4*>(qbuf + (size_t)pos * d);
  for (int i = lane; i < d / 16; i += 32) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// 3a. int8 scan: TMA ring + wgmma + threshold-filtered candidate buffers
// ---------------------------------------------------------------------------

constexpr int kQTile = 64;       // queries per tile: wgmma M
constexpr int kDepth = 128;      // bytes of depth per stage: one swizzle atom row
constexpr int kRowBytes = kRowChunk * kDepth;
constexpr int kQBytes = kQTile * kDepth;
constexpr int kStageBytes = kRowBytes + kQBytes;
constexpr int kQBox = 16;        // query rows per TMA box: one consumer warp's M rows
constexpr int kPool = kQTile * 192;  // candidate entries of a tile's queries
constexpr int kCapMax = 384;     // candidate entries of one query
constexpr int kBufBytes = kPool * 8;
constexpr int kEpiSlots = 4;     // row chunks of ids/scales in flight
constexpr int kEpiBytes = kRowChunk * 8;
constexpr int kMiscBytes = 6144; // per-query state, barriers, select histograms
constexpr int kSmemAlign = 1024; // 128-byte swizzle atoms
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages =
    (kSmemLimit - kSmemAlign - kBufBytes - kEpiSlots * kEpiBytes - kMiscBytes) /
    kStageBytes;
constexpr int kS8Threads = 384;  // two consumer warpgroups + producer warpgroup
constexpr int kHalf = kRowChunk / 2;  // chunk rows of one consumer: wgmma N

constexpr int smem_bytes_for(int stages) {
  return kSmemAlign + stages * kStageBytes + kBufBytes + kEpiSlots * kEpiBytes +
         kMiscBytes;
}

// a query's capacity is at least kPool / kQTile, room for k and a chunk
static_assert(kPool / kQTile >= kMaxK + kRowChunk, "a chunk must fit after a merge");
static_assert(6 * kQTile * 4 + 8 * 128 * 4 + (2 * kMaxStages + 2 * kEpiSlots) * 8 <=
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

struct S8Args {
  const int* ids;        // (nlist * cmax,)
  const float* scales;   // (nlist * cmax,)
  const float* qsc;      // (Q,)
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
// the query's M row: warp w's rows 16w + l hold the tile's queries w*m + l
// (m = ceil(nq / 4)), so the queries of a small tile spread over the four
// consumer warps.
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

constexpr int kBins = 128;  // histogram bins of one warp's select

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

// Row q's buffer could overflow with the next chunk: keep its k best, raise
// its threshold to the k-th, and publish the k-th's score as a bound for the
// query's other pairs.
__device__ __forceinline__ void merge_query(uint2* buf, int* hist, const QState& st,
                                            int q, const S8Args& p, int lane) {
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
                                             int q, const S8Args& p, const int* cids,
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

// Offer one consumer's 64 rows of a chunk (rows row0 + 8j + 2t + c) for M
// rows warp*16 + g and + 8 to their buffers (`halves` bit i: this warp has
// live rows g + 8i). The accumulator element acc[4j + 2i + c] is M row
// warp*16 + g + 8i, chunk row 8j + 2t + c (g = lane / 4, t = lane % 4). A
// quad's four threads share a query: the quad's count reserves room in the
// buffer (the other consumer appends to it too) and two shuffles give each
// thread its offset. `bound` holds the rows' published query bounds (see
// merge_query). A buffer holds at most cap - 128 entries before a
// chunk, so the chunk always fits. Returns whether a buffer this thread
// appended to could overflow with the next chunk.
__device__ __forceinline__ bool offer_chunk(const int (&acc)[32], uint32_t valid,
                                            const float (&sc)[16], uint2* buf,
                                            const QState& st, const int (&bound)[2],
                                            int cap, int row0, int warp, int lane,
                                            int halves) {
  const int g = lane / 4, t = lane % 4;
  bool flagged = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!((halves >> i) & 1)) continue;  // warp-uniform
    const int q = warp * 16 + g + 8 * i;
    const int pair = st.pair[q];
    const bool live = pair >= 0;
    const float qs = st.qsc[q];
    float ts = st.thr_s[q];
    int ti = st.thr_i[q];
    // another pair of the query has k entries at or above `bound`: a score
    // below it cannot reach the query's top k (ties at it still pass)
    if (bound[i] != INT_MIN && unordered(bound[i]) > ts) {
      ts = unordered(bound[i]);
      ti = kNoSlot;
    }
    float s[16];
    uint32_t pass = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int slot = row0 + 8 * j + 2 * t + c;
        int raw = acc[4 * j + 2 * i + c];
        if (IVF_PROBE == 2) raw = (int)(mix32(pair * 40503u + slot) >> 16) - 32768;
        const float v = __fmul_rn(__fmul_rn(__int2float_rn(raw), qs), sc[2 * j + c]);
        s[2 * j + c] = v;
        if (((valid >> (2 * j + c)) & 1) && better(v, slot, ts, ti))
          pass |= 1u << (2 * j + c);
      }
    }
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
      for (int b = 0; b < 16; ++b) {
        if ((pass >> b) & 1) {
          const int slot = row0 + 8 * (b >> 1) + 2 * t + (b & 1);
          *dst++ = make_uint2(__float_as_uint(s[b]), (unsigned)slot);
        }
      }
    }
    flagged |= total > 0 && base + total > cap - kRowChunk;
  }
  return flagged;
}

__global__ void __launch_bounds__(kS8Threads, 1)
ivf_scan_s8(const __grid_constant__ CUtensorMap rows_map,
            const __grid_constant__ CUtensorMap q_map, const S8Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
      ~uintptr_t(kSmemAlign - 1));
  const int stages = p.stages;
  // stage s: rows [0, 16K), the tile's queries [16K, 24K) in four 16-row boxes
  uint2* buf = reinterpret_cast<uint2*>(smem + stages * kStageBytes);
  int* epi = reinterpret_cast<int*>(smem + stages * kStageBytes + kBufBytes);
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
  const int n_k = p.d / kDepth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    for (int e = 0; e < kEpiSlots; ++e) {
      mbar_init(epi_full + e, 32);
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
      int pos = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = p.tiles[t];
        const int row_base = tl.cluster * p.cmax;
        const int m = (tl.nq + 3) / 4;  // queries of each consumer warp
        const int n_rc = p.nchunk[tl.cluster];
        for (int rc = 0; rc < n_rc; ++rc) {
          for (int kc = 0; kc < n_k; ++kc, ++pos) {
            const int s = pos % stages;
            mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
            mbar_expect_tx(full + s, kStageBytes);
            uint8_t* dst = smem + s * kStageBytes;
            tma_load(dst, &rows_map, full + s, kc * kDepth, row_base + rc * kRowChunk);
            for (int w = 0; w < 4; ++w)
              tma_load(dst + kRowBytes + w * kQBox * kDepth, &q_map, full + s,
                       kc * kDepth, tl.pos0 + w * m);
          }
        }
      }
    } else if (warp == 1) {
      // ids and scales of each row chunk; all eight loads in flight before
      // the slot is claimed
      int n = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = p.tiles[t];
        const size_t row_base = (size_t)tl.cluster * p.cmax;
        const int n_rc = p.nchunk[tl.cluster];
        for (int rc = 0; rc < n_rc; ++rc, ++n) {
          int id[4];
          float sc[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const size_t slot = row_base + rc * kRowChunk + 32 * i + lane;
            id[i] = p.ids[slot];
            sc[i] = p.scales[slot];
          }
          const int e = n % kEpiSlots;
          mbar_wait(epi_empty + e, ((n / kEpiSlots) & 1) ^ 1);
          int* dst = epi + e * (kEpiBytes / 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dst[32 * i + lane] = id[i];
            dst[kRowChunk + 32 * i + lane] = __float_as_int(sc[i]);
          }
          mbar_arrive(epi_full + e);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: consumer c takes rows [64c, 64c + 64) of each
  // chunk for all the tile's queries ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x, lane = tid % 32;
  const int cw = tid / 128, warp = (tid / 32) % 4, gw = tid / 32;
  const int t4 = lane % 4;
  int* hist = hist_all + gw * kBins;
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  int pos = 0, n = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = p.tiles[t];
    const int nq = tl.nq, m = (nq + 3) / 4;
    const int n_rc = p.nchunk[tl.cluster];  // chunks past it hold no valid slot
    // a query's buffer: as much of the pool as the tile's queries leave
    const int cap = min(kCapMax, (kPool / nq) & ~31);
    const int* cids = p.ids + (size_t)tl.cluster * p.cmax;
    if (tid < kQTile) {
      const int l = tid % 16, i = (tid / 16) * m + l;
      const bool live = l < m && i < nq;
      const int pr = live ? p.pair_at[tl.pos0 + i] : -1;
      st.cnt[tid] = 0;
      st.thr_s[tid] = kNeg;  // every valid score beats (-3e38, no slot)
      st.thr_i[tid] = kNoSlot;
      st.pair[tid] = pr;
      st.qsc[tid] = live ? p.qsc[pr / p.nprobe] : 0.f;
      st.boff[tid] = live ? i * cap : 0;
    }
    // this warp's live rows: g for the first m_w (half 0), g + 8 past 8
    const int m_w = max(0, min(m, nq - warp * m));
    const int halves = (m_w > 0 ? 1 : 0) | (m_w > 8 ? 2 : 0);
    bool pending = false;  // some buffer must merge before the next chunk
    consumer_sync();
    for (int rc = 0; rc < n_rc; ++rc, ++n) {
      // the bounds other CTAs published for this thread's two rows, read
      // from L2 while the products run
      int bound[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pr = st.pair[warp * 16 + lane / 4 + 8 * i];
        bound[i] = pr >= 0 ? __ldcg(p.qthr + pr / p.nprobe) : INT_MIN;
      }
      for (int kc = 0; kc < n_k; ++kc) {
        const int at = pos + kc, s = at % stages;
        mbar_wait(full + s, (at / stages) & 1);
        if (IVF_PROBE != 2) {
          const uint8_t* stage = smem + s * kStageBytes;
          const uint64_t a = sw128_desc(stage + kRowBytes);
          const uint64_t b = sw128_desc(stage + cw * kHalf * kDepth);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kDepth / 32; ++kk)
            wgmma_step(acc, a + 2 * kk, b + 2 * kk, (kc | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous depth chunk's products are done
          fence_acc(acc);
        }
        if (kc > 0) mbar_arrive(empty + (at - 1) % stages);
      }
      if (IVF_PROBE != 2) {
        wgmma_wait<0>();
        fence_acc(acc);
      }
      mbar_arrive(empty + (pos + n_k - 1) % stages);
      pos += n_k;

      if (pending) {
        // the merges of the buffers that could overflow, spread over the
        // eight consumer warps, while the ring refills
        for (int i = gw; i < nq; i += 8) {
          const int q = (i / m) * 16 + i % m;  // tile query i's M row
          if (st.cnt[q] > cap - kRowChunk) merge_query(buf, hist, st, q, p, lane);
        }
        consumer_sync();
      }
      const int e = n % kEpiSlots;
      mbar_wait(epi_full + e, (n / kEpiSlots) & 1);
      bool flagged = false;
      if (IVF_PROBE != 1) {
        // this thread's rows 64c + 8j + 2t + cc: valid bits and scales
        const int* eid = epi + e * (kEpiBytes / 4) + cw * kHalf;
        const float* esc = reinterpret_cast<const float*>(eid + kRowChunk);
        uint32_t valid = 0;
        float sc[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 id2 = *reinterpret_cast<const int2*>(eid + 8 * j + 2 * t4);
          const float2 s2 = *reinterpret_cast<const float2*>(esc + 8 * j + 2 * t4);
          valid |= (uint32_t)(id2.x >= 0) << (2 * j);
          valid |= (uint32_t)(id2.y >= 0) << (2 * j + 1);
          sc[2 * j] = s2.x;
          sc[2 * j + 1] = s2.y;
        }
        // rows of empty slots (the cluster's unfilled tail) offer nothing
        if (__any_sync(0xffffffffu, valid != 0))
          flagged = offer_chunk(acc, valid, sc, buf, st, bound, cap,
                                rc * kRowChunk + cw * kHalf, warp, lane, halves);
      }
      mbar_arrive(epi_empty + e);
      pending = consumer_any(flagged);
    }
    // the cluster's end: every query's final merge, written to its pair
    if (IVF_PROBE != 1) {
      for (int i = gw; i < nq; i += 8)
        finish_query(buf, hist, st, (i / m) * 16 + i % m, p, cids, lane);
    }
    consumer_sync();
  }
}

// ---------------------------------------------------------------------------
// 3b. bf16/f32 scan: CUDA-core f32 dot, top-k in registers
// ---------------------------------------------------------------------------

constexpr int kFQueries = 32;         // probing queries per block
constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;
constexpr int kQPerWarp = kFQueries / kFWarps;
constexpr int kFDepth = 32;           // depth values staged per step
constexpr int kFStride = kFDepth + 1; // padded smem row (floats)

struct StageF32 {
  float rows[kRowChunk * kFStride];
  float queries[kFQueries * kFStride];
};

// One query's sorted top-k list, two entries per lane: positions lane and
// lane + 32. Entries past the list's fill hold (kNeg, kNoSlot).
struct TopK {
  float s0, s1;
  int r0, r1;
};

__device__ __forceinline__ void topk_init(TopK& e) {
  e.s0 = e.s1 = kNeg;
  e.r0 = e.r1 = kNoSlot;
}

// the k-th best entry (position k - 1), on every lane
__device__ __forceinline__ void topk_kth(const TopK& e, int k, float& ks,
                                         int& kr) {
  const int src = (k - 1) & 31;
  const bool hi = (k - 1) >= 32;
  ks = __shfl_sync(0xffffffffu, hi ? e.s1 : e.s0, src);
  kr = __shfl_sync(0xffffffffu, hi ? e.r1 : e.r0, src);
}

// Insert (bs, br), known to beat the k-th entry, keeping the list sorted.
__device__ __forceinline__ void topk_insert(TopK& e, int k, float bs, int br,
                                            int lane) {
  const bool b0 = lane < k && better(e.s0, e.r0, bs, br);
  const bool b1 = lane + 32 < k && better(e.s1, e.r1, bs, br);
  const int pos = __popc(__ballot_sync(0xffffffffu, b0)) +
                  __popc(__ballot_sync(0xffffffffu, b1));
  const float up0s = __shfl_up_sync(0xffffffffu, e.s0, 1);
  const int up0r = __shfl_up_sync(0xffffffffu, e.r0, 1);
  const float up1s = __shfl_up_sync(0xffffffffu, e.s1, 1);
  const int up1r = __shfl_up_sync(0xffffffffu, e.r1, 1);
  const float last0s = __shfl_sync(0xffffffffu, e.s0, 31);
  const int last0r = __shfl_sync(0xffffffffu, e.r0, 31);
  if (lane == pos) {
    e.s0 = bs; e.r0 = br;
  } else if (lane > pos) {
    e.s0 = up0s; e.r0 = up0r;
  }
  if (lane + 32 == pos) {
    e.s1 = bs; e.r1 = br;
  } else if (lane + 32 > pos) {
    e.s1 = lane == 0 ? last0s : up1s;
    e.r1 = lane == 0 ? last0r : up1r;
  }
}

// Offer one lane-distributed chunk of candidates (cand[j] scores slot
// slot0 + lane + 32 j; kNeg = masked) to a query's list.
__device__ __forceinline__ void topk_offer(TopK& e, int k, const float (&cand)[4],
                                           int slot0, int lane) {
  float ks;
  int kr;
  topk_kth(e, k, ks, kr);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float cs = cand[j];
    const int cr = slot0 + lane + 32 * j;
    unsigned mask = __ballot_sync(0xffffffffu, cs > kNeg && better(cs, cr, ks, kr));
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const float bs = __shfl_sync(0xffffffffu, cs, src);
      const int br = __shfl_sync(0xffffffffu, cr, src);
      if (!better(bs, br, ks, kr)) continue;  // the k-th rose meanwhile
      topk_insert(e, k, bs, br, lane);
      topk_kth(e, k, ks, kr);
    }
  }
}

// Stage kRowChunk rows x kFDepth depth values as f32 (bf16 widened exactly).
template <int STORAGE>
__device__ __forceinline__ void stage_rows_f(float* dst, const uint8_t* rows,
                                             int d, int chunk) {
  const int per_row = kFDepth / 4;  // groups of 4 values
  for (int i = threadIdx.x; i < kRowChunk * per_row; i += kFThreads) {
    const int r = i / per_row, c = i % per_row;
    const size_t off = (size_t)r * d + (size_t)chunk * kFDepth + c * 4;
    float4 v;
    if (STORAGE == 2) {
      v = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(rows) + off);
    } else {
      // four bf16 values; a bf16 is the top half of the f32 it widens to
      const uint2 raw = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const uint16_t*>(rows) + off);
      v = make_float4(__uint_as_float(raw.x << 16),
                      __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16),
                      __uint_as_float(raw.y & 0xffff0000u));
    }
    float* o = dst + r * kFStride + c * 4;
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
}

__device__ __forceinline__ void stage_queries_f(float* dst, const float* q,
                                                const int* qrow, int nq_tile,
                                                int d, int chunk) {
  const int per_row = kFDepth / 4;
  for (int i = threadIdx.x; i < kFQueries * per_row; i += kFThreads) {
    const int r = i / per_row, c = i % per_row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nq_tile) {
      v = *reinterpret_cast<const float4*>(q + (size_t)qrow[r] * d +
                                           (size_t)chunk * kFDepth + c * 4);
    }
    float* o = dst + r * kFStride + c * 4;
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
}

// One block per tile (the grid is the tile bound; surplus blocks exit).
template <int STORAGE>
__global__ void __launch_bounds__(kFThreads)
ivf_scan_f(const uint8_t* __restrict__ data,   // (nlist, cmax, d)
           const int* __restrict__ ids,        // (nlist, cmax)
           const float* __restrict__ queries,  // (Q, d) f32
           const int* __restrict__ pair_at, const Tile* __restrict__ tiles,
           const int* __restrict__ hdr, const int* __restrict__ nchunk,
           float* __restrict__ out_s, int* __restrict__ out_i, int cmax, int d,
           int nprobe, int k) {
  __shared__ __align__(16) StageF32 smem;
  __shared__ int s_rowid[kRowChunk];
  __shared__ int s_pair[kFQueries];
  __shared__ int s_qrow[kFQueries];

  if ((int)blockIdx.x >= hdr[0]) return;
  const Tile tl = tiles[blockIdx.x];
  const int c = tl.cluster, nq_tile = tl.nq;
  if (threadIdx.x < kFQueries) {
    const int i = threadIdx.x;
    const int f = i < nq_tile ? pair_at[tl.pos0 + i] : 0;
    s_pair[i] = f;
    s_qrow[i] = f / nprobe;
  }
  __syncthreads();  // the pairs are read below even when no chunk is streamed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int esize = STORAGE == 1 ? 2 : 4;
  const uint8_t* cluster = data + (size_t)c * cmax * d * esize;

  TopK lists[kQPerWarp];
#pragma unroll
  for (int qi = 0; qi < kQPerWarp; ++qi) topk_init(lists[qi]);

  const int rows_end = nchunk[c] * kRowChunk;  // past it no slot is valid
  for (int row0 = 0; row0 < rows_end; row0 += kRowChunk) {
    __syncthreads();  // the previous chunk's readers of s_rowid are done
    if (threadIdx.x < kRowChunk)
      s_rowid[threadIdx.x] = ids[(size_t)c * cmax + row0 + threadIdx.x];
    const uint8_t* rows = cluster + (size_t)row0 * d * esize;
    // thread (warp, lane): queries warp*4 .. +3 x rows lane + 32 j, the
    // selection's own layout, so scores go straight to the lists
    float acc[kQPerWarp][4];
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[qi][j] = 0.f;
    for (int chunk = 0; chunk < d / kFDepth; ++chunk) {
      __syncthreads();
      stage_rows_f<STORAGE>(smem.rows, rows, d, chunk);
      stage_queries_f(smem.queries, queries, s_qrow, nq_tile, d, chunk);
      __syncthreads();
      float part[kQPerWarp][4];
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[qi][j] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kFDepth; ++kk) {
        float rv[4], qv[kQPerWarp];
#pragma unroll
        for (int j = 0; j < 4; ++j) rv[j] = smem.rows[(lane + 32 * j) * kFStride + kk];
#pragma unroll
        for (int qi = 0; qi < kQPerWarp; ++qi)
          qv[qi] = smem.queries[(warp * kQPerWarp + qi) * kFStride + kk];
#pragma unroll
        for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[qi][j] = fmaf(qv[qi], rv[j], part[qi][j]);
      }
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[qi][j] += part[qi][j];
    }
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      float cand[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cand[j] = s_rowid[lane + 32 * j] >= 0 ? acc[qi][j] : kNeg;
      if (warp * kQPerWarp + qi < nq_tile)  // warp-uniform
        topk_offer(lists[qi], k, cand, row0, lane);
    }
  }

  // write each pair's list: ids come from the slot, empty entries -3e38/-1
  const int* cids = ids + (size_t)c * cmax;
#pragma unroll
  for (int qi = 0; qi < kQPerWarp; ++qi) {
    const int i = warp * kQPerWarp + qi;
    if (i >= nq_tile) continue;
    const size_t o = (size_t)s_pair[i] * k;
    const TopK& e = lists[qi];
    if (lane < k) {
      const bool ok = e.s0 > kNeg;
      out_s[o + lane] = ok ? e.s0 : kNeg;
      out_i[o + lane] = ok ? cids[e.r0] : -1;
    }
    if (lane + 32 < k) {
      const bool ok = e.s1 > kNeg;
      out_s[o + lane + 32] = ok ? e.s1 : kNeg;
      out_i[o + lane + 32] = ok ? cids[e.r1] : -1;
    }
  }
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
// int64; tile_q: queries per tile (64 for the int8 scan, 32 for float);
// count: nlist ints. With qq (int8 storage) the quantized query rows are
// gathered into qbuf in pair order; with ids ((nlist, cmax) int32) each
// probed cluster's chunk count goes to nchunk (nlist ints).
extern "C" int semcode_ivf_prep(const void* probes, int probes64, int nq,
                                int nprobe, int nlist, int tile_q, int* ptab,
                                int* prank, int* pair_at, int* count,
                                void* tiles, int* hdr, int* qthr,
                                const void* qq, int d, void* qbuf,
                                const int* ids, int cmax, int* nchunk,
                                int gather_blocks, void* stream) {
  if (nq <= 0 || nprobe <= 0 || nprobe > kMaxProbe || nlist <= 0 ||
      (tile_q != kQTile && tile_q != kFQueries) ||
      (long long)nq * nprobe > 0x7fffffffLL ||
      (qq != nullptr && (d <= 0 || d % 128 != 0 || qbuf == nullptr)) ||
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
      ptab, prank, count, nq * nprobe, nprobe, pair_at,
      static_cast<const uint8_t*>(qq), d, static_cast<uint8_t*>(qbuf), ids, cmax,
      nchunk);
  return cudaGetLastError();
}

// The scan of every tile, each cluster up to its nchunk (from the prep
// with ids). storage 0 (int8): `queries` is the gathered (n_pairs, d) int8
// buffer, launched as `grid` persistent CTAs with `stages` ring stages and
// exactly smem_for(stages) bytes of shared memory; storage 1 (bf16) / 2
// (f32): `queries` is the (Q, d) f32 query, launched as `grid` blocks (the
// tile bound).
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
      k > kMaxK || n_pairs <= 0 || grid <= 0 ||
      (long long)nlist * cmax > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tile* t = static_cast<const Tile*>(tiles);
  if (storage == 0) {
    if (stages < 2 || stages > kMaxStages || smem_bytes != smem_bytes_for(stages) ||
        (reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(queries)) % 16)
      return cudaErrorInvalidValue;
    CUtensorMap rows_map, q_map;
    if (!tile_map(&rows_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, data, d,
                  (long long)nlist * cmax, kRowChunk) ||
        !tile_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, queries, d, n_pairs, kQBox))
      return cudaErrorInvalidValue;
    cudaError_t err = raise_smem_once<ivf_scan_s8>(kSmemLimit);
    if (err != cudaSuccess) return err;
    const S8Args args{ids, scales, qsc, pair_at, t, hdr, nchunk, out_s, out_i,
                      qthr, cmax, d, nprobe, k, stages};
    ivf_scan_s8<<<grid, kS8Threads, smem_bytes, s>>>(rows_map, q_map, args);
    return cudaGetLastError();
  }
  const uint8_t* rows = static_cast<const uint8_t*>(data);
  const float* q = static_cast<const float*>(queries);
  switch (storage) {
    case 1:
      ivf_scan_f<1><<<grid, kFThreads, 0, s>>>(rows, ids, q, pair_at, t, hdr,
                                               nchunk, out_s, out_i, cmax, d,
                                               nprobe, k);
      break;
    case 2:
      ivf_scan_f<2><<<grid, kFThreads, 0, s>>>(rows, ids, q, pair_at, t, hdr,
                                               nchunk, out_s, out_i, cmax, d,
                                               nprobe, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
