// Fused exact scan with a per-128-row top-2 epilogue, for Hopper (sm_90a).
//
// Replaces semcode_tpu/ops/scan_kernel2.py::top2_scan_shard (Pallas, TPU).
// Computes, for every query q and row r < Rs,
//     score = ((float(raw) * qsc[q]) * mult[r]) + add[r],   raw = qq[q] . vecs[r]
// (int8 storage: s8 x s8 -> s32 on the tensor cores, exact; bf16 or f32
// storage: rows rounded to bf16, bf16 x bf16 products summed in f32), masks
// rows >= Rs to -3e38, and writes each 128-row block's top-2 (score,
// shard-local row), ties to the lowest row, as
//     bmax[q][blk] / brow[q][blk]        the block's first,
//     bmax[q][nb + blk] / brow[q][nb+blk] its runner-up,   nb = ceil(Rs/128).
// An all-sentinel block emits lane 0 in both slots (the TPU kernel's rule).
//
// What bounds it on an H100: at the main path's shape (1,000,064 x 384 int8
// rows, Q=512) the dot is 3.93e11 int8 operations, 0.199 ms at 1,979 TOP/s,
// against 392 MB of rows and 64 MB of output, 0.136 ms at 3.35 TB/s:
// operations bound it. bf16 rows do the same operations at the 989 TFLOP/s
// bf16 rate, 0.398 ms (0.84 GB of rows and output take 0.25 ms); f32 rows
// are 1.54 GB, ~0.48 ms, so bytes bound them. The selection is larger on the
// CUDA cores: for each of the 5.1e8 scores (a conversion for int8), two
// multiplies and an add kept unfused for bit-exact int8, then two compares
// and six selects of a branch-free top-2 update, so it has to run beside the
// tensor cores, not after them. On one H100 (chip_smoke.py's measurement
// builds) the int8 products and pipeline alone run at the bound and the
// selection alone takes the whole kernel's time: the selection bounds int8
// and bf16 rows, and the rounding to bf16 bounds f32 rows.
//
// Design (top2_scan_kernel<STORAGE>, one for int8, bf16 and f32 rows):
// persistent warp-specialised CTAs of three warpgroups. A work item is 256
// rows x 2 query tiles of 64. The producer warpgroup's first warp streams
// 128-byte depth chunks of the row tile and of both query tiles by TMA
// (128-byte swizzle, rows past Rs and queries past Q zero-filled) into a
// ring of mbarrier-guarded stages: 128 int8 values or 64 bf16 values a row.
// f32 rows go by TMA as stored, 32 values a row, into a ring of two raw
// stages, and the producer's warps 2-3 round each pair of raw stages to bf16
// (round to nearest even, as the TPU kernel casts them, scan_kernel2.py:130)
// into the operand stage with hopper.cuh's to_bf16, the conversion stage
// dot_max.cu shares. The producer's second warp loads the tile's mult/add
// with coalesced loads (rows past Rs get add = -3e38). Each consumer
// warpgroup owns one query tile of the item and runs wgmma m64n256 (int8:
// k32 s8 -> s32; bf16/f32: k16 bf16 -> f32) with the queries as M and the
// rows as N, both K-major from shared memory, so every thread holds 2
// queries x 64 rows of scores in registers: a block's top-2 is an in-thread
// scan over 32 values in row order, then two shuffle rounds across the 4
// threads of a quad. No score reaches shared memory. For int8 and bf16 rows
// the two consumers take turns at the tensor cores (ping-pong, an mbarrier
// pair), so one's selection runs while the other's products do; while an
// item's depth fits in the ring (int8 d <= 512, bf16 d <= 256) the row chunk
// of a stage serves both before it is released, halving the rows' L2 reads;
// deeper items load the row tile once for each consumer, since the second
// consumer starts only after the first has read the whole depth. For f32
// rows the rounding bounds the kernel (two converter warps beside selecting
// consumers), so the consumers read each rounded chunk together, without
// turns, and every row chunk is rounded once per item. The grid is
// min(#SMs, items); item u is (row tile u / pairs, query pair u % pairs) and
// CTA b walks b, b + grid, ...: the CTAs that share a row tile run together
// and re-read it from L2.
//
// scan_topk_s8 + scan_topk_merge: the same stream over int8 rows with an
// exact top-w epilogue (1 <= w <= 64) in place of the block top-2. It
// replaces no TPU kernel: the JAX exact route leaves the product and top_k
// to XLA, whose port (index/scan._select_xla) writes the (Q, Rs) score
// matrix, builds int64 keys from it in seven elementwise passes and runs a
// radix top-k (39 ms against this kernel's 2.1 ms at 1M x 384 and Q 512 on
// one H100) to keep 32 entries a query. It computes, for every query q, the
// best w rows by
//     score = valid[r] ? s : -3e38,  s = (float(raw) * qsc[q]) * scale[r]
//     (l2: 2 * s - norm[r]),  raw = qq[q] . vecs[r]  (s8 x s8 -> s32)
// with the unfused f32 operations of the matrix route, ordered by the
// score's IEEE total order descending (-0 below +0, as that route's keys
// order them), ties to the lowest row; fewer than w live rows leave the
// lowest masked rows at -3e38 in the tail. What bounds it on an H100: at
// d 3072 (1M rows, Q 256) the 3.07 GB of rows, 0.92 ms at 3.35 TB/s,
// against 1.6e12 operations (0.8 ms); at d 384 (Q 512) the products
// (0.2 ms) and, beside them on the CUDA cores, the epilogue, the mask and
// the test of each of 5.1e8 scores, as for top2_scan.
// Design: grid = lists x query pairs, so each CTA keeps one query pair over
// all its work items and carries each query's best w across its row tiles
// (item u's pair is u % pairs = b % pairs). The consumers read each row
// chunk together, without turns: the selection outlasts the products, and
// the rows are read from L2 once a CTA at any depth (at d 3072 those reads
// bound it). Each query keeps a threshold, the w-th (key, row) of its
// candidates, in registers of the quad that owns its accumulator row. A
// score that could beat it, and the query's bound that other CTAs publish
// (atomicMax of their w-th key; ties at the bound pass, so the answer does
// not depend on which CTA publishes first), is appended with its exact key
// to the query's buffer in shared memory, 32 rows of the query an offer
// round; the test is a float compare that keeps ties. A buffer that a
// round's entries would overflow is first cut to its w best by one warp (a
// histogram over the keys finds the w-th's bin, whose entries are ranked
// exactly), which raises the threshold, and the round's entries are
// filtered again: a cut every cap - w appends. The quad alone writes its
// queries' buffers, so no CTA-wide barrier is needed. After its last item
// each CTA writes each query's w best, sorted, as one list; scan_topk_merge
// (a warp a query) merges the lists by (key desc, row asc) into the (Q, w)
// scores and int64 rows.
//
// Plain C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launches; the caller allocates the outputs, owns the
// stream, and chooses the launch geometry (ops/scan_top2.scan_geometry,
// topk_geometry), which is checked here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// Measurement builds of the kernel (ops/scan_top2.PROBE_LIBRARIES, timed by
// chip_smoke.py for every storage): -DTOP2_PROBE=1 skips the selection (products and
// pipeline alone), -DTOP2_PROBE=2 skips the products (pipeline and selection
// alone, on zero accumulators). Their outputs are meaningless.
#ifndef TOP2_PROBE
#define TOP2_PROBE 0
#endif

namespace {

using namespace hopper;

constexpr float kNeg = -3.0e38f;

// (score, row) ordering: higher score first, then lower row
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Merge another thread's (n1, j1, n2, j2) top-2 into ours.
__device__ __forceinline__ void merge_top2(float& m1, int& i1, float& m2,
                                           int& i2, float n1, int j1, float n2,
                                           int j2) {
  if (better(n1, j1, m1, i1)) {
    // the other list's first wins; runner-up is the better of our first and
    // its second
    if (better(m1, i1, n2, j2)) { m2 = m1; i2 = i1; } else { m2 = n2; i2 = j2; }
    m1 = n1; i1 = j1;
  } else if (better(n1, j1, m2, i2)) {
    m2 = n1; i2 = j1;
  }
}

// The TPU kernel picks the runner-up after overwriting the first's lane with
// the sentinel: when nothing beats the sentinel, the runner-up is the
// sentinel at the lowest lane holding it.
__device__ __forceinline__ void sentinel_rule(int i1, float& m2, int& i2) {
  if (!(m2 > kNeg)) {
    i2 = (m2 == kNeg) ? min(i1, i2) : i1;
    m2 = kNeg;
  }
}

// ---------------------------------------------------------------------------
// TMA ring + wgmma + in-register top-2, persistent ping-pong, every storage
// ---------------------------------------------------------------------------

constexpr int kRowTile = 256;    // rows per work item: wgmma N, two top-2 blocks
constexpr int kQueryTile = 64;   // queries per consumer warpgroup: wgmma M
constexpr int kChunk = 128;      // bytes of operand depth per stage: one swizzle atom row
constexpr int kRowChunkBytes = kRowTile * kChunk;
constexpr int kQueryChunkBytes = kQueryTile * kChunk;
constexpr int kStageBytes = kRowChunkBytes + 2 * kQueryChunkBytes;
constexpr int kRawStages = 2;    // f32 row stages (32 values a row) in flight
constexpr int kRawBytes = kRowTile * kChunk;
constexpr int kEpiBytes = kRowTile * 8;  // mult and add of one row tile
constexpr int kEpiSlots = 4;             // row tiles of mult/add in flight
constexpr int kBarrierBytes = 256;
constexpr int kSmemAlign = 1024;         // 128-byte swizzle atoms
constexpr int kSmemLimit = 232448;       // a block's dynamic shared memory
constexpr int kThreads = 384;            // 2 consumer warpgroups + producer
constexpr int kConvThreads = 64;         // producer warps 2-3: f32 -> bf16

// storage 0 int8, 1 bf16, 2 f32: the f32 kernel adds the raw ring
__host__ __device__ constexpr int raw_bytes(int storage) {
  return storage == 2 ? kRawStages * kRawBytes : 0;
}
constexpr int smem_bytes_for(int storage, int stages) {
  return kSmemAlign + stages * kStageBytes + raw_bytes(storage) +
         kEpiSlots * kEpiBytes + kBarrierBytes;
}
constexpr int max_stages(int storage) {
  return (kSmemLimit - smem_bytes_for(storage, 0)) / kStageBytes;
}

// scan_topk: candidate buffers of the CTA's 128 queries, each room for w
// rounded up to 32 and one offer round; validity words and a select
// histogram per consumer warp beside the mult/add slots
constexpr int kMaxWidth = 64;       // widest selection
constexpr int kRoundRows = 32;      // rows of one query an offer round appends at most
constexpr int kCtaQueries = 2 * kQueryTile;
constexpr int kMaskWords = kRowTile / 32;  // validity words of one row tile
constexpr int kMaskBytes = kEpiSlots * kMaskWords * 4;
constexpr int kBins = 128;          // histogram bins of one warp's select
constexpr int kHistBytes = 8 * kBins * 4;
constexpr int kMaxLists = 256;      // CTAs per query pair
constexpr int kNoRow = 0x7fffffff;

__host__ __device__ constexpr int topk_cap(int w) {
  return (w + 31) / 32 * 32 + kRoundRows;
}
constexpr int topk_smem_bytes(int w, int stages) {
  return kSmemAlign + stages * kStageBytes + kEpiSlots * kEpiBytes + kMaskBytes +
         kHistBytes + kCtaQueries * topk_cap(w) * 8 + kBarrierBytes;
}
constexpr int topk_max_stages(int w) {
  return (kSmemLimit - topk_smem_bytes(w, 0)) / kStageBytes;
}
static_assert(topk_max_stages(32) >= 3 && topk_max_stages(kMaxWidth) >= 2, "ring depth");

struct Args {
  const float* mult;
  const float* add;
  const float* qsc;
  float* bmax;
  int* brow;
  // scan_topk: row scales, norms (l2), liveness; each CTA's lists; bounds
  const float* scale;
  const float* norm;
  const uint8_t* valid;
  int* part_key;
  int* part_row;
  unsigned* qbound;
  int rs, d, nq, stages, n_qtiles, n_qpairs, n_units;
  int w, cap, lists;
};

// the accumulator as the epilogue reads it: s32 converted, f32 as summed
__device__ __forceinline__ float raw_score(int raw) { return __int2float_rn(raw); }
__device__ __forceinline__ float raw_score(float raw) { return raw; }

// One consumer warpgroup's selection for its 64 queries x 256 rows: the
// accumulator element d[4j + 2i + c] is query warp*16 + g + 8i, tile row
// 8j + 2t + c (g = lane / 4, t = lane % 4).
template <typename Acc>
__device__ __forceinline__ void select_top2(const Acc (&acc)[128],
                                            const float4* __restrict__ epi,
                                            const Args& p, int row0, int q0,
                                            int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int nb = (p.rs + 127) / 128;
  float qs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + warp * 16 + g + 8 * i;
    qs[i] = q < p.nq ? p.qsc[q] : 0.f;
  }
  float m1[2][2], m2[2][2];  // [query i][block b]
  int i1[2][2], i2[2][2];    // block rows, less this thread's 2t
  // the four (query, block) lists advance together: four independent
  // chains of branch-free updates
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    float4 ma[2];  // {mult, mult, add, add} of block rows 8jj + 2t, + 1
#pragma unroll
    for (int b = 0; b < 2; ++b) ma[b] = epi[4 * (16 * b + jj) + t];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = __fadd_rn(
              __fmul_rn(__fmul_rn(raw_score(acc[4 * (16 * b + jj) + 2 * i + c]),
                                  qs[i]),
                        c ? ma[b].y : ma[b].x),
              c ? ma[b].w : ma[b].z);
          const int r = 8 * jj + c;
          float& a1 = m1[i][b];
          float& a2 = m2[i][b];
          int& r1 = i1[i][b];
          int& r2 = i2[i][b];
          if (jj == 0 && c == 0) {
            // the runner-up is replaced by the next value: 31 more follow
            a1 = s; r1 = r;
            a2 = __int_as_float(0xff800000); r2 = r;
          } else {
            // rows arrive in increasing order: a tie keeps the earlier row
            const bool gt1 = s > a1, gt2 = s > a2;
            a2 = gt1 ? a1 : (gt2 ? s : a2);
            r2 = gt1 ? r1 : (gt2 ? r : r2);
            a1 = gt1 ? s : a1;
            r1 = gt1 ? r : r1;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float a1 = m1[i][b], a2 = m2[i][b];
      int r1 = i1[i][b] + 2 * t, r2 = i2[i][b] + 2 * t;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float n1 = __shfl_xor_sync(0xffffffffu, a1, off);
        const int j1 = __shfl_xor_sync(0xffffffffu, r1, off);
        const float n2 = __shfl_xor_sync(0xffffffffu, a2, off);
        const int j2 = __shfl_xor_sync(0xffffffffu, r2, off);
        merge_top2(a1, r1, a2, r2, n1, j1, n2, j2);
      }
      sentinel_rule(r1, a2, r2);
      // every thread of the quad holds the result: each writes one value
      const int q = q0 + warp * 16 + g + 8 * i;
      const int blk = row0 / 128 + b;
      if (q < p.nq && blk < nb) {
        const size_t o = (size_t)q * (2 * nb);
        const int base = row0 + 128 * b;
        if (t == 0) p.bmax[o + blk] = a1;
        else if (t == 1) p.brow[o + blk] = base + r1;
        else if (t == 2) p.bmax[o + nb + blk] = a2;
        else p.brow[o + nb + blk] = base + r2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// scan_topk: exact top-w selection by (key desc, row asc)
// ---------------------------------------------------------------------------

// A float's bits as an int that orders as the IEEE total order does (-0
// below +0): the order of the matrix route's int64 keys.
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int o) {
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// (key, row) ordering: higher key first, then lower row
__device__ __forceinline__ bool kbetter(int a, int i, int b, int j) {
  return a > b || (a == b && i < j);
}

// One warp keeps the best `keep` of buffer qb's n entries (keep < n <= 32 E),
// compacted in place to qb[0, keep) in no order, and returns the worst kept
// entry (the keep-th best) on every lane. Exact: a histogram of the keys'
// distance below the largest, cut to 128 bins by a shift (a bin never holds
// a better key than an earlier bin), finds the bin of the keep-th entry;
// the entries of that bin are ranked among themselves by (key, row).
template <int E>
__device__ __forceinline__ void select_keys(int2* qb, int n, int keep, int* hist,
                                            int lane, int& wk, int& wr) {
  int s[E], r[E];
  int hi = INT_MIN, lo = INT_MAX;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = i * 32 + lane;
    const int2 v = e < n ? qb[e] : make_int2(INT_MIN, kNoRow);
    s[i] = v.x;
    r[i] = v.y;
    if (e < n) { hi = max(hi, s[i]); lo = min(lo, s[i]); }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  }
  // (hi - key) < 2^bits: shifted by bits - 7, it is below 128
  const unsigned range = (unsigned)hi - (unsigned)lo;
  const int shift = max(0, 25 - __clz(range));
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) hist[j * 32 + lane] = 0;
  __syncwarp();
  int bin[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    bin[i] = (int)(((unsigned)hi - (unsigned)s[i]) >> shift);
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
      const int os = __shfl_sync(0xffffffffu, s[ii], src);
      const int orr = __shfl_sync(0xffffffffu, r[ii], src);
#pragma unroll
      for (int i = 0; i < E; ++i) rank[i] += kbetter(os, orr, s[i], r[i]);
    }
  }
  // compact the kept entries and find the worst of them
  bool kept[E];
  int at[E], base = 0;
  wk = INT_MAX;
  wr = -1;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool valid = i * 32 + lane < n;
    kept[i] = valid && (bin[i] < kbin || (bin[i] == kbin && rank[i] < need));
    const unsigned m = __ballot_sync(0xffffffffu, kept[i]);
    at[i] = base + __popc(m & below);
    base += __popc(m);
    if (kept[i] && (wr < 0 || kbetter(wk, wr, s[i], r[i]))) { wk = s[i]; wr = r[i]; }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (kept[i]) qb[at[i]] = make_int2(s[i], r[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_xor_sync(0xffffffffu, wk, off);
    const int orr = __shfl_xor_sync(0xffffffffu, wr, off);
    if (orr >= 0 && (wr < 0 || kbetter(wk, wr, os, orr))) { wk = os; wr = orr; }
  }
  __syncwarp();
}

// Not inlined: the offer rounds call it from 16 places, rarely; one copy
// keeps their unrolled code small. Returns the keep-th (key, row) by value,
// so no stack slot (local memory, with little L1 beside the ring) is used.
__device__ __noinline__ int2 select_any(int2* qb, int n, int keep, int* hist, int lane) {
  int wk, wr;
  if (n <= 64) select_keys<2>(qb, n, keep, hist, lane, wk, wr);
  else select_keys<topk_cap(kMaxWidth) / 32>(qb, n, keep, hist, lane, wk, wr);
  return make_int2(wk, wr);
}

// Bitonic sort of 64 (key, row) entries held by a warp (entry i * 32 +
// lane in register i), best first.
__device__ __forceinline__ void sort64(int (&k)[2], int (&r)[2], int lane) {
#pragma unroll
  for (int ls = 1; ls <= 6; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls, st = 1 << lt;
      if (st == 32) {
        // entries lane and lane + 32: one descending pair in register
        const bool swap = kbetter(k[1], r[1], k[0], r[0]);
        const int tk = swap ? k[1] : k[0];
        const int tr = swap ? r[1] : r[0];
        k[1] = swap ? k[0] : k[1];
        r[1] = swap ? r[0] : r[1];
        k[0] = tk;
        r[0] = tr;
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ok = __shfl_xor_sync(0xffffffffu, k[i], st);
          const int orr = __shfl_xor_sync(0xffffffffu, r[i], st);
          const bool lower = (lane & st) == 0;
          const bool desc = ((i * 32 + lane) & size) == 0;
          const bool ob = kbetter(ok, orr, k[i], r[i]);
          if (lower == desc ? ob : !ob) { k[i] = ok; r[i] = orr; }
        }
      }
    }
  }
}

// A consumer thread's two queries (accumulator rows g and g + 8 of its
// warp), the same over every item of the CTA: the threshold (the w-th
// (key, row) after the buffer's last cut), the buffer's count (the same in
// the four threads of the quad), the query's scale and published bound.
// A query past Q keeps the threshold (INT_MAX, -1), which nothing beats.
struct TopkState {
  int thr_k[2], thr_r[2], cnt[2], bnd[2];
  float qs[2];
};

// scan_topk's epilogue of one consumer warpgroup's 64 queries x 256 rows:
// 8 offer rounds of 32 rows a query (accumulator column blocks 4r .. 4r + 3).
// A round's passing entries go to the query's buffer; a buffer they would
// overflow is first cut to its w best (raising the threshold, publishing the
// w-th key as the query's bound), and its quad filters them again. So a cut
// comes once every cap - w appends, not every round. The buffers of warp
// `warp`'s queries start at slot slot0 + 16 warp.
//
// The limit an entry must beat is the larger of the query's bound (keys at
// it pass) and its threshold. The hot test is a float compare that keeps
// every entry that could beat it (ties, -0 against +0 and NaN included:
// entries appended in excess only take room), and only appended entries get
// their exact total-order keys, which the cuts rank.
template <bool L2>
__device__ __forceinline__ void offer_topk(const int (&acc)[128],
                                           const float4* __restrict__ epi,
                                           const uint32_t* __restrict__ mask,
                                           int2* cbuf, int* hist, TopkState& st,
                                           const Args& p, int row0, int q0, int slot0,
                                           int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int nexist = p.rs - row0;  // rows of the tile below Rs
  // {scale, scale, norm, norm} of tile rows 8j + 2t, + 1 at epi[4j + t],
  // read where used: few registers stay free beside the accumulator
  const float2* en = reinterpret_cast<const float2*>(epi);
#pragma unroll
  for (int r = 0; r < kRowTile / kRoundRows; ++r) {
    // liveness of this thread's rows 32r + 8jj + 2t + c at bit 8jj + c
    const uint32_t vw = mask[r] >> (2 * t);
    // bit 2jj + c: the row lies below Rs (all but in the last tile's tail)
    uint32_t exist = 0xff;
    if (nexist < kRoundRows * (r + 1)) {  // warp-uniform
      exist = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        exist |= (uint32_t)(kRoundRows * r + 8 * (b >> 1) + 2 * t + (b & 1) < nexist) << b;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the start's (INT_MIN, no row) lets all pass; a query past Q, none
      const int lim_k = max(st.bnd[i], st.thr_k[i]);
      const float lim = lim_k == INT_MIN ? -INFINITY
                        : lim_k == INT_MAX ? INFINITY : unordered(lim_k);
      // masked rows, which all tie at -3e38, by the exact rule: after a
      // threshold row, which lies in an earlier round, only a greater key
      // passes; at a bound or at no row, an equal key too
      const int kneg = ordered(kNeg);
      const bool neg_pass = kneg > lim_k ||
          (kneg == lim_k && (st.bnd[i] > st.thr_k[i] ||
                             st.thr_r[i] >= row0 + kRoundRows * (r + 1)));
      float v[8];
      uint32_t pass = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * r + jj;
        const float2 sc = en[2 * (4 * j + t)];
        float2 nm;
        if (L2) nm = en[2 * (4 * j + t) + 1];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * i + c]), st.qs[i]),
                              c ? sc.y : sc.x);
          if (L2) x = __fsub_rn(__fmul_rn(2.f, x), c ? nm.y : nm.x);
          const bool live = (vw >> (8 * jj + c)) & 1;
          v[2 * jj + c] = live ? x : kNeg;
          if (live ? !(x < lim) : neg_pass) pass |= 1u << (2 * jj + c);
        }
      }
      pass &= exist;
      if (!__any_sync(0xffffffffu, pass != 0)) continue;  // warp-uniform
      // the quad's passing entries, counted in lane order
      int mine = __popc(pass), incl, total;
      auto count = [&]() {
        incl = mine;
        const int up1 = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (t >= 1) incl += up1;
        const int up2 = __shfl_up_sync(0xffffffffu, incl, 2, 4);
        if (t >= 2) incl += up2;
        total = __shfl_sync(0xffffffffu, incl, 3, 4);
      };
      count();
      unsigned m = __ballot_sync(0xffffffffu, t == 0 && st.cnt[i] + total > p.cap);
      if (m) {  // warp-uniform
        bool cut = false;
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const int gq = src / 4, qr = warp * 16 + gq + 8 * i;
          const int n = __shfl_sync(0xffffffffu, st.cnt[i], src);
          const int2 kr = select_any(cbuf + (slot0 + qr) * p.cap, n, p.w, hist, lane);
          if (g == gq) {
            st.thr_k[i] = kr.x;
            st.thr_r[i] = kr.y;
            st.cnt[i] = p.w;
            cut = true;
          }
          if (lane == 0) atomicMax(p.qbound + q0 + qr, (unsigned)kr.x ^ 0x80000000u);
        }
        // against the raised threshold
        if (cut) {
          const float tl = unordered(st.thr_k[i]);
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (v[b] < tl) pass &= ~(1u << b);
        }
        mine = __popc(pass);
        count();
      }
      int2* dst = cbuf + (slot0 + warp * 16 + g + 8 * i) * p.cap + st.cnt[i] + incl - mine;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if ((pass >> b) & 1)
          *dst++ = make_int2(ordered(v[b]), row0 + 8 * (4 * r + (b >> 1)) + 2 * t + (b & 1));
      st.cnt[i] += total;
      __syncwarp();
    }
  }
}

// After the CTA's last item: each of the warp's live queries' w best,
// sorted, to its list `list` (entries past the buffer's count: INT_MIN /
// kNoRow, below every score).
__device__ __forceinline__ void finish_topk(int2* cbuf, int* hist, const TopkState& st,
                                            const Args& p, int q0, int slot0, int list,
                                            int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int gq = 0; gq < 8; ++gq) {
      const int qr = warp * 16 + gq + 8 * i;
      if (q0 + qr >= p.nq) continue;  // warp-uniform
      int2* qb = cbuf + (slot0 + qr) * p.cap;
      int n = __shfl_sync(0xffffffffu, st.cnt[i], gq * 4);
      if (n > p.w) {
        select_any(qb, n, p.w, hist, lane);
        n = p.w;
      }
      int k[2], r[2];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int e = ii * 32 + lane;
        const int2 v = e < n ? qb[e] : make_int2(INT_MIN, kNoRow);
        k[ii] = v.x;
        r[ii] = v.y;
      }
      sort64(k, r, lane);
      const size_t o = ((size_t)(q0 + qr) * p.lists + list) * p.w;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int e = ii * 32 + lane;
        if (e < p.w) {
          p.part_key[o + e] = k[ii];
          p.part_row[o + e] = r[ii];
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA ring + wgmma + in-register epilogue, persistent ping-pong, every storage
// ---------------------------------------------------------------------------

// top2_scan_kernel<STORAGE> (TOPK false) and scan_topk_s8 (STORAGE 0, TOPK):
// one stream; the epilogue loads, the per-item selection and the shared
// memory past the mult/add slots differ.
template <int STORAGE, bool TOPK, bool L2 = false>
__device__ __forceinline__ void scan_body(const CUtensorMap* rows_map,
                                          const CUtensorMap* q_map, const Args& p) {
  static_assert(!TOPK || STORAGE == 0, "scan_topk reads int8 rows");
  using Acc = typename std::conditional<STORAGE == 0, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset into the shared array, so the compiler keeps every
  // pointer below in the shared window (LDS/STS)
  uint8_t* smem = smem_raw + (kSmemAlign - smem_u32(smem_raw) % kSmemAlign) % kSmemAlign;
  const int stages = p.stages;
  // stage s: rows [0, 32K), query tile 0 [32K, 40K), query tile 1 [40K, 48K)
  uint8_t* raw = smem + stages * kStageBytes;  // f32: kRawStages row stages
  float4* epi = reinterpret_cast<float4*>(raw + raw_bytes(STORAGE));
  uint8_t* past_epi = reinterpret_cast<uint8_t*>(epi) + kEpiSlots * kEpiBytes;
  // scan_topk: validity words of each slot, histograms, candidate buffers
  uint32_t* mask = reinterpret_cast<uint32_t*>(past_epi);
  int* hist_all = reinterpret_cast<int*>(past_epi + kMaskBytes);
  int2* cbuf = reinterpret_cast<int2*>(past_epi + kMaskBytes + kHistBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      TOPK ? past_epi + kMaskBytes + kHistBytes + kCtaQueries * p.cap * 8 : past_epi);
  uint64_t* empty = full + stages;
  uint64_t* epi_full = empty + stages;
  uint64_t* epi_empty = epi_full + kEpiSlots;
  uint64_t* turn = epi_empty + kEpiSlots;  // turn[c]: consumer c's turn
  uint64_t* raw_full = turn + 2;
  uint64_t* raw_empty = raw_full + kRawStages;
  // operand chunks of 128 bytes: 128 int8 or 64 bf16 values of depth
  const int n_k = STORAGE == 0 ? p.d / kChunk : p.d / (kChunk / 2);
  // int8/bf16: the consumers take turns at the tensor cores (ping-pong).
  // While an item's depth fits in the ring, one load of each row chunk
  // serves both (consumer 1 reads it while consumer 0 selects); deeper items
  // load the row tile once for each consumer. f32: the conversion bounds
  // the kernel, so the consumers read each converted chunk together, with
  // no turns, and every row chunk is rounded once per item.
  // scan_topk: no turns, both consumers reading each row chunk together
  // (its selection outlasts the products, so a turn would only wait; and
  // rows deeper than the ring are read from L2 once, not once a consumer)
  constexpr bool kTurns = STORAGE != 2 && !TOPK;
  const bool share = !kTurns || n_k <= stages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // f32: the queries' TMA bytes and every converter thread's rows
      mbar_init(full + s, STORAGE == 2 ? 1 + kConvThreads : 1);
      mbar_init(empty + s, share ? 256 : 128);
    }
    for (int e = 0; e < kEpiSlots; ++e) {
      mbar_init(epi_full + e, 32);
      mbar_init(epi_empty + e, 256);
    }
    mbar_init(turn, 128);
    mbar_init(turn + 1, 128);
    for (int r = 0; r < kRawStages; ++r) {
      mbar_init(raw_full + r, 1);
      mbar_init(raw_empty + r, kConvThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      // TMA: each position's row chunk (f32: into two raw stages, converted
      // by warps 2-3) and its live query tiles
      // ring positions in the order the consumers read them: per item, one
      // pass of n_k chunks for both consumers (share), or one pass for each
      // live consumer
      int pos = 0, rpos = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int row0 = (u / p.n_qpairs) * kRowTile;
        const int qt0 = 2 * (u % p.n_qpairs);
        const int n_live = qt0 + 1 < p.n_qtiles ? 2 : 1;
        const int nq_tiles = share ? n_live : 1;
        for (int pass = 0; pass < (share ? 1 : n_live); ++pass) {
          for (int k = 0; k < n_k; ++k, ++pos) {
            if (STORAGE == 2) {
              for (int h = 0; h < 2; ++h, ++rpos) {
                const int r = rpos % kRawStages;
                mbar_wait(raw_empty + r, ((rpos / kRawStages) & 1) ^ 1);
                mbar_expect_tx(raw_full + r, kRawBytes);
                tma_load(raw + r * kRawBytes, rows_map, raw_full + r,
                         k * 64 + h * 32, row0);
              }
            }
            const int s = pos % stages;
            mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
            mbar_expect_tx(full + s, (STORAGE == 2 ? 0 : kRowChunkBytes) +
                                         nq_tiles * kQueryChunkBytes);
            uint8_t* st = smem + s * kStageBytes;
            // element coordinates of the chunk: 128 int8 or 64 bf16 values
            const int kx = STORAGE == 0 ? k * kChunk : k * (kChunk / 2);
            if (STORAGE != 2) tma_load(st, rows_map, full + s, kx, row0);
            for (int c = pass; c < pass + nq_tiles; ++c)
              tma_load(st + kRowChunkBytes + c * kQueryChunkBytes, q_map,
                       full + s, kx, (qt0 + c) * kQueryTile);
          }
        }
      }
    } else if (warp == 1) {
      // top2: mult/add of each item's row tile, interleaved {m, m, a, a} per
      // row pair; rows past Rs get mult 0 and add -3e38, so their zero-filled
      // products score exactly the sentinel. scan_topk: {scale, scale, norm,
      // norm} and a validity word of every 32 rows
      int n = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x, ++n) {
        const int row0 = (u / p.n_qpairs) * kRowTile;
        // all 16 loads in flight before the slot is claimed: one memory
        // round trip per item
        constexpr int kPer = kRowTile / 32;
        float m[kPer], a[kPer];
        bool v[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int row = row0 + 32 * i + lane;
          if constexpr (TOPK) {
            m[i] = row < p.rs ? p.scale[row] : 0.f;
            a[i] = L2 && row < p.rs ? p.norm[row] : 0.f;
            v[i] = row < p.rs && p.valid[row] != 0;
          } else {
            m[i] = row < p.rs ? p.mult[row] : 0.f;
            a[i] = row < p.rs ? p.add[row] : kNeg;
          }
        }
        const int e = n % kEpiSlots;
        mbar_wait(epi_empty + e, ((n / kEpiSlots) & 1) ^ 1);
        float* dst = reinterpret_cast<float*>(epi + e * (kRowTile / 2));
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = 32 * i + lane;
          dst[(r >> 1) * 4 + (r & 1)] = m[i];
          dst[(r >> 1) * 4 + 2 + (r & 1)] = a[i];
          if constexpr (TOPK) {
            const unsigned bits = __ballot_sync(0xffffffffu, v[i]);
            if (lane == 0) mask[e * kMaskWords + i] = bits;
          }
        }
        mbar_arrive(epi_full + e);
      }
    } else if (STORAGE == 2 && warp >= 2) {
      // warps 2-3: round each position's two f32 row stages to bf16 into
      // the operand stage (hopper.cuh's to_bf16), then publish it
      const int ct = threadIdx.x - 256 - 64;
      // the producer's positions: every item's passes of n_k chunks
      int positions = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x)
        positions += (share || 2 * (u % p.n_qpairs) + 1 >= p.n_qtiles ? 1 : 2) * n_k;
      for (int pos = 0; pos < positions; ++pos) {
        const int s = pos % stages;
        mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
        for (int h = 0; h < 2; ++h) {
          const int rpos = 2 * pos + h, r = rpos % kRawStages;
          mbar_wait(raw_full + r, (rpos / kRawStages) & 1);
          to_bf16<float, kConvThreads>(smem + s * kStageBytes, raw + r * kRawBytes,
                                       kRowTile, h, ct);
          mbar_arrive(raw_empty + r);
        }
        fence_proxy_async();
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
    // scan_topk: the CTA's query pair is the same on every item (the grid
    // is a multiple of the pairs), so each query's state lives across items
    TopkState st;
    const int tq0 = (2 * (blockIdx.x % p.n_qpairs) + c) * kQueryTile;
    if constexpr (TOPK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tq0 + warp * 16 + lane / 4 + 8 * i;
        const bool live = q < p.nq;
        st.qs[i] = live ? p.qsc[q] : 0.f;
        // every entry beats (INT_MIN, no row); none beats (INT_MAX, -1)
        st.thr_k[i] = live ? INT_MIN : INT_MAX;
        st.thr_r[i] = live ? kNoRow : -1;
        st.cnt[i] = 0;
        st.bnd[i] = INT_MIN;
      }
    }
    int n = 0, pos = 0;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x, ++n) {
      const int row0 = (u / p.n_qpairs) * kRowTile;
      const int qt0 = 2 * (u % p.n_qpairs);
      const int q0 = (qt0 + c) * kQueryTile;
      const bool live = q0 < p.nq;
      const bool live1 = qt0 + 1 < p.n_qtiles;
      if constexpr (TOPK) {
        // the bounds other CTAs published, read from L2 under the products
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = q0 + warp * 16 + lane / 4 + 8 * i;
          if (q < p.nq) st.bnd[i] = (int)(__ldcg(p.qbound + q) ^ 0x80000000u);
        }
      }
      // a consumer that reads a stage also multiplies it, even when its
      // query tile lies past Q (zero-filled, selection skipped): a wgmma
      // under a branch is serialised by the compiler
      // this consumer's ring positions for the item: the shared pass (read
      // even when its query tile is past Q, to release the stages), or its
      // own pass, which exists only when it is live
      const bool reads = share || live;
      const int first = share ? pos : pos + c * n_k;
      pos += share ? n_k : (live1 ? 2 : 1) * n_k;
      // consumer 0 goes first on every item, then consumer 1
      if (kTurns) mbar_wait(turn + c, (n & 1) ^ (c == 0 ? 1 : 0));
      for (int k = 0; reads && k < n_k; ++k) {
        const int at = first + k, s = at % stages;
        mbar_wait(full + s, (at / stages) & 1);
        if (TOP2_PROBE != 2) {
          const uint8_t* stg = smem + s * kStageBytes;
          const uint64_t a = sw128_desc(stg + kRowChunkBytes + c * kQueryChunkBytes);
          const uint64_t b = sw128_desc(stg);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 32; ++kk)
            wgmma_step(acc, a + 2 * kk, b + 2 * kk, (k | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's products are done
          fence_acc(acc);
        }
        if (k > 0) mbar_arrive(empty + (at - 1) % stages);
      }
      if (kTurns) mbar_arrive(turn + (1 - c));
      wgmma_wait<0>();
      fence_acc(acc);
      if (reads) mbar_arrive(empty + (first + n_k - 1) % stages);

      const int e = n % kEpiSlots;
      mbar_wait(epi_full + e, (n / kEpiSlots) & 1);
      if (TOP2_PROBE != 1 && live && q0 + warp * 16 < p.nq) {  // warp-uniform
        if constexpr (TOPK)
          offer_topk<L2>(acc, epi + e * (kRowTile / 2), mask + e * kMaskWords, cbuf,
                     hist_all + (threadIdx.x / 32) * kBins, st, p, row0, q0, c * kQueryTile,
                     warp, lane);
        else
          select_top2(acc, epi + e * (kRowTile / 2), p, row0, q0, warp, lane);
      }
      mbar_arrive(epi_empty + e);
    }
    if constexpr (TOPK) {
      if (tq0 + warp * 16 < p.nq)  // warp-uniform
        finish_topk(cbuf, hist_all + (threadIdx.x / 32) * kBins, st, p, tq0,
                    c * kQueryTile, blockIdx.x / p.n_qpairs, warp, lane);
    }
  }
}

template <int STORAGE>
__global__ void __launch_bounds__(kThreads, 1)
top2_scan_kernel(const __grid_constant__ CUtensorMap rows_map,
                 const __grid_constant__ CUtensorMap q_map, const Args p) {
  scan_body<STORAGE, false>(&rows_map, &q_map, p);
}

// L2: scores 2 s - norm[r] (metric l2), else s (ip, cosine)
template <bool L2>
__global__ void __launch_bounds__(kThreads, 1)
scan_topk_s8(const __grid_constant__ CUtensorMap rows_map,
             const __grid_constant__ CUtensorMap q_map, const Args p) {
  scan_body<0, true, L2>(&rows_map, &q_map, p);
}

// One warp a query: its `lists` sorted lists of w staged in shared memory,
// lane l holding the heads of lists l, l + 32, ...; each output is the
// warp's best head by (key desc, row asc), rows being distinct across lists.
__global__ void scan_topk_merge(const int* __restrict__ part_key,
                                const int* __restrict__ part_row,
                                float* __restrict__ out_s,
                                long long* __restrict__ out_i, int nq, int lists,
                                int w) {
  extern __shared__ int2 msm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * (blockDim.x / 32) + warp;
  if (q >= nq) return;
  const int n = lists * w;
  int2* sm = msm + (size_t)warp * n;
  const size_t base = (size_t)q * n;
#pragma unroll 8
  for (int x = lane; x < n; x += 32) sm[x] = make_int2(part_key[base + x], part_row[base + x]);
  __syncwarp();
  constexpr int M = kMaxLists / 32;
  int at[M], hk[M], hr[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int l = lane + 32 * m;
    const int2 v = l < lists ? sm[l * w] : make_int2(INT_MIN, kNoRow);
    at[m] = l < lists ? 0 : w;  // a missing list counts as exhausted
    hk[m] = v.x;
    hr[m] = v.y;
  }
  int k0 = INT_MIN, r0 = kNoRow, k1 = INT_MIN, r1 = kNoRow;
  for (int e = 0; e < w; ++e) {
    int bk = INT_MIN, br = kNoRow, bl = -1;
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (at[m] < w && (bl < 0 || kbetter(hk[m], hr[m], bk, br))) {
        bk = hk[m];
        br = hr[m];
        bl = lane + 32 * m;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int orr = __shfl_xor_sync(0xffffffffu, br, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (ol >= 0 && (bl < 0 || kbetter(ok, orr, bk, br) ||
                      (ok == bk && orr == br && ol < bl))) {
        bk = ok;
        br = orr;
        bl = ol;
      }
    }
    if (e == lane) { k0 = bk; r0 = br; }
    if (e == lane + 32) { k1 = bk; r1 = br; }
    if (bl >= 0 && (bl & 31) == lane) {
      const int wm = bl >> 5;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m == wm) {
          at[m] += 1;
          if (at[m] < w) {
            const int2 v = sm[bl * w + at[m]];
            hk[m] = v.x;
            hr[m] = v.y;
          }
        }
      }
    }
  }
  const size_t o = (size_t)q * w;
  if (lane < w) { out_s[o + lane] = unordered(k0); out_i[o + lane] = r0; }
  if (lane + 32 < w) { out_s[o + lane + 32] = unordered(k1); out_i[o + lane + 32] = r1; }
}

template <int STORAGE>
cudaError_t launch(const void* vecs, const float* mult, const float* add,
                   const void* qq, const float* qsc, float* bmax, int* brow,
                   int rs, int d, int nq, int grid, int stages, int smem_bytes,
                   cudaStream_t stream) {
  const long long n_qtiles = (nq + kQueryTile - 1) / kQueryTile;
  const long long n_qpairs = (n_qtiles + 1) / 2;
  const long long units = ((long long)rs + kRowTile - 1) / kRowTile * n_qpairs;
  if (units > 0x7fffffffLL || grid < 1 || grid > units || stages < 2 ||
      stages > max_stages(STORAGE) || smem_bytes != smem_bytes_for(STORAGE, stages) ||
      (reinterpret_cast<uintptr_t>(vecs) | reinterpret_cast<uintptr_t>(qq)) % 16)
    return cudaErrorInvalidValue;
  const CUtensorMapDataType rows_type =
      STORAGE == 0 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : STORAGE == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType q_type =
      STORAGE == 0 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap rows_map, q_map;
  if (!tile_map(&rows_map, rows_type, vecs, d, rs, kRowTile) ||
      !tile_map(&q_map, q_type, qq, d, nq, kQueryTile))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      top2_scan_kernel<STORAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  Args args{};
  args.mult = mult;
  args.add = add;
  args.qsc = qsc;
  args.bmax = bmax;
  args.brow = brow;
  args.rs = rs;
  args.d = d;
  args.nq = nq;
  args.stages = stages;
  args.n_qtiles = (int)n_qtiles;
  args.n_qpairs = (int)n_qpairs;
  args.n_units = (int)units;
  top2_scan_kernel<STORAGE><<<grid, kThreads, smem_bytes, stream>>>(rows_map, q_map, args);
  return cudaGetLastError();
}

}  // namespace

// storage 0 (int8), 1 (bf16) or 2 (f32) launches top2_scan_kernel with the
// caller's geometry: `grid` persistent CTAs, `stages` ring stages and
// `smem_bytes` of dynamic shared memory (refused unless it is exactly what
// the storage and `stages` need).
extern "C" int semcode_top2_scan(const void* vecs, const float* mult,
                                 const float* add, const void* qq,
                                 const float* qsc, float* bmax, int* brow,
                                 int rs, int d, int nq, int storage, int grid,
                                 int stages, int smem_bytes, void* stream) {
  if (rs <= 0 || nq <= 0 || d <= 0 || d % 128 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch<0>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq,
                             grid, stages, smem_bytes, s);
    case 1: return launch<1>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq,
                             grid, stages, smem_bytes, s);
    case 2: return launch<2>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq,
                             grid, stages, smem_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}

// The exact top-w (1 <= w <= min(64, rs)) of int8 rows: clears the nq bounds
// in `qbound`, launches scan_topk_s8 with the caller's geometry (`grid` a
// multiple of the query pairs, at most 256 lists a pair and no more than the
// row tiles; `stages` ring stages; exactly topk_smem_bytes(w, stages) bytes)
// writing the (nq, grid / pairs, w) lists to part_key / part_row, then
// scan_topk_merge with `merge_warps` queries a block and merge_smem =
// merge_warps * lists * w * 8 bytes into out_s (nq, w) f32 and out_i (nq, w)
// int64 shard rows. `norm` is read when l2 is set.
extern "C" int semcode_scan_topk(const void* vecs, const float* scale,
                                 const uint8_t* valid, const float* norm,
                                 const void* qq, const float* qsc, int* part_key,
                                 int* part_row, unsigned* qbound, float* out_s,
                                 long long* out_i, int rs, int d, int nq, int w,
                                 int l2, int grid, int stages, int smem_bytes,
                                 int merge_warps, int merge_smem, void* stream) {
  if (rs <= 0 || nq <= 0 || d <= 0 || d % 128 != 0 || w < 1 || w > kMaxWidth ||
      w > rs || (l2 && norm == nullptr))
    return cudaErrorInvalidValue;
  const long long n_qtiles = (nq + kQueryTile - 1) / kQueryTile;
  const long long n_qpairs = (n_qtiles + 1) / 2;
  const long long n_rtiles = ((long long)rs + kRowTile - 1) / kRowTile;
  const long long units = n_rtiles * n_qpairs;
  const long long lists = grid / n_qpairs;
  if (units > 0x7fffffffLL || grid < 1 || grid % n_qpairs != 0 || lists > kMaxLists ||
      lists > n_rtiles || stages < 2 || stages > topk_max_stages(w) ||
      smem_bytes != topk_smem_bytes(w, stages) || merge_warps < 1 || merge_warps > 32 ||
      (long long)merge_smem != merge_warps * lists * w * 8 || merge_smem > kSmemLimit ||
      (reinterpret_cast<uintptr_t>(vecs) | reinterpret_cast<uintptr_t>(qq)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap rows_map, q_map;
  if (!tile_map(&rows_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, vecs, d, rs, kRowTile) ||
      !tile_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, qq, d, nq, kQueryTile))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(qbound, 0, (size_t)nq * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  auto kernel = l2 ? scan_topk_s8<true> : scan_topk_s8<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  Args args{};
  args.qsc = qsc;
  args.scale = scale;
  args.norm = norm;
  args.valid = valid;
  args.part_key = part_key;
  args.part_row = part_row;
  args.qbound = qbound;
  args.rs = rs;
  args.d = d;
  args.nq = nq;
  args.stages = stages;
  args.n_qtiles = (int)n_qtiles;
  args.n_qpairs = (int)n_qpairs;
  args.n_units = (int)units;
  args.w = w;
  args.cap = topk_cap(w);
  args.lists = (int)lists;
  kernel<<<grid, kThreads, smem_bytes, s>>>(rows_map, q_map, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             merge_smem);
  if (err != cudaSuccess) return err;
  scan_topk_merge<<<(nq + merge_warps - 1) / merge_warps, 32 * merge_warps, merge_smem, s>>>(
      part_key, part_row, out_s, out_i, nq, (int)lists, w);
  return cudaGetLastError();
}

// scan_topk_s8<false>'s registers a thread and local memory (spills) a thread, from
// the loaded module (attrs[0], attrs[1]).
extern "C" int semcode_scan_topk_attributes(int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, scan_topk_s8<false>);
  if (err != cudaSuccess) return err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  return cudaSuccess;
}
