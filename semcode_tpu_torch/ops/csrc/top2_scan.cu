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
// radix top-k (40 ms against this kernel's 1.2 ms at 1M x 384 and Q 512 on
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
// chunk together, without turns: rows deeper than the ring are read from
// L2 once a CTA at any depth (at d 3072 those reads bound it), and the
// epilogue, bound by its latency, runs faster with both consumers in it at
// once than beside the other's products (at d 384, Q 512 on one H100:
// 1.324 ms with turns against 1.316 without, both with three stages). At
// Q <= 64 the second
// consumer has no tile and reads nothing. Each query keeps a threshold, the w-th (key, row) of its
// candidates, a count and its candidate buffer in shared memory; the limit
// an entry must beat is the larger of the threshold and the query's bound.
// The epilogue (offer_topk) tests every score of the item against the
// limits at the item's start, branch-free on the FMA pipe; a lane with
// entries in a round takes their slots in the query's buffer by one
// shared-memory atomic and writes them from the scores in its registers,
// predicated, a warp vote skipping the rounds where no lane has one. Only
// a lane that finds no room (a scan's first items, then every cap - w
// appends of a query) sends the warp to the counted path, which cuts the
// buffer to its w best by one warp (a histogram over the keys finds the
// w-th's bin, whose entries are ranked exactly), raising the threshold,
// and goes on from the round that did not fit. The bounds: each CTA
// publishes the w-th key at a cut (atomicMax; ties at a bound pass, so the
// answer does not depend on which CTA publishes first) and its best key
// appended of each query; the producer's idle warps fold the least of the
// lists' best keys (lists >= w distinct entries reach it) into the
// published bounds, which each CTA reads at every item, one list CTA
// computing a query's; in a CTA's first item the least of each quad's 32
// lane-round maxima is a bound too. A query's limit rises fastest that way:
// at 1M x 384 and Q 512 the cuts fall from 7.3 a query and list to 2.0.
// What bounds the epilogue is then its per-score test and its latency: one
// H100 runs the kernel in 1.19 ms against 0.34 ms for the products and
// ring alone (2.13 ms before this design). After
// its last item each CTA writes each query's w best, sorted, as one list;
// scan_topk_merge (a warp a query) merges the lists by (key desc, row asc)
// into the (Q, w) scores and int64 rows.
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
// append rounds and cuts of each consumer warp; the consumer warps that are done
constexpr int kTallyBytes = 8 * 2 * 4 + 16;
// each query's threshold (key, row), count and best key appended
constexpr int kStateBytes = kCtaQueries * 16;
constexpr int kMaxLists = 256;      // CTAs per query pair
constexpr int kNoRow = 0x7fffffff;

__host__ __device__ constexpr int topk_cap(int w) {
  return (w + 31) / 32 * 32 + kRoundRows;
}
constexpr int topk_smem_bytes(int w, int stages) {
  return kSmemAlign + stages * kStageBytes + kEpiSlots * kEpiBytes + kMaskBytes +
         kHistBytes + kTallyBytes + kStateBytes + kCtaQueries * topk_cap(w) * 8 +
         kBarrierBytes;
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
  int* counts;      // the call's append rounds and cuts
  unsigned* best;   // (nq, lists): each CTA's best key appended of each query
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

// One warp keeps the best `keep` of buffer qb's n entries (keep <= n <= 32 E;
// each a score's float bits and its row, ranked by the score's total-order
// key), compacted in place to qb[0, keep) in no order, and returns the worst kept
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
    const int2 v = e < n ? qb[e] : make_int2(0, kNoRow);
    s[i] = e < n ? ordered(__int_as_float(v.x)) : INT_MIN;
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
    if (kept[i]) qb[at[i]] = make_int2(__float_as_int(unordered(s[i])), r[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int os = __shfl_xor_sync(0xffffffffu, wk, off);
    const int orr = __shfl_xor_sync(0xffffffffu, wr, off);
    if (orr >= 0 && (wr < 0 || kbetter(wk, wr, os, orr))) { wk = os; wr = orr; }
  }
  __syncwarp();
}

// Not inlined: called rarely, from a few places. Returns the keep-th
// (key, row) by value, so no stack slot (local memory, with little L1
// beside the ring) is used.
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

// The epilogue's f32 score of one accumulator element, as the matrix route
// computes it (unfused): (raw * qsc) * scale, for l2 2 s - norm.
template <bool L2>
__device__ __forceinline__ float topk_score(int raw, float qs, float scale, float norm) {
  const float s = __fmul_rn(__fmul_rn(__int2float_rn(raw), qs), scale);
  return L2 ? __fsub_rn(__fmul_rn(2.f, s), norm) : s;
}

// The float a limit key stands for in the tests: INT_MIN lets everything
// pass, INT_MAX nothing but NaN.
__device__ __forceinline__ float limit_float(int lim_k) {
  return lim_k == INT_MIN ? -INFINITY : lim_k == INT_MAX ? INFINITY : unordered(lim_k);
}

// 1.0 where x >= lim or either is NaN (the test !(x < lim)), else 0.0: a
// float result, so a round's pass bits add up on the FMA pipe.
__device__ __forceinline__ float geu(float x, float lim) {
  float d;
  asm("set.geu.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(x), "f"(lim));
  return d;
}

// x passed through an opaque move: scores computed again from it (the
// counted path's) are not taken from the hot test's conversions, which the
// compiler would otherwise keep (in local memory: the accumulator holds the
// registers).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// This thread's 8 accumulator elements of offer round r of query i, for a
// runtime round (one switch over the 16 (r, i): the code of the counted
// path exists once), through an opaque move.
__device__ __forceinline__ void round_raw(const int (&acc)[128], int r, int i, int (&a)[8]) {
  switch (2 * r + i) {
#define SCAN_TOPK_ROUND(R, I)                                             \
  case 2 * R + I:                                                         \
    _Pragma("unroll") for (int b = 0; b < 8; ++b)                         \
        a[b] = acc[4 * (4 * R + (b >> 1)) + 2 * I + (b & 1)];              \
    break;
    SCAN_TOPK_ROUND(0, 0) SCAN_TOPK_ROUND(0, 1) SCAN_TOPK_ROUND(1, 0) SCAN_TOPK_ROUND(1, 1)
    SCAN_TOPK_ROUND(2, 0) SCAN_TOPK_ROUND(2, 1) SCAN_TOPK_ROUND(3, 0) SCAN_TOPK_ROUND(3, 1)
    SCAN_TOPK_ROUND(4, 0) SCAN_TOPK_ROUND(4, 1) SCAN_TOPK_ROUND(5, 0) SCAN_TOPK_ROUND(5, 1)
    SCAN_TOPK_ROUND(6, 0) SCAN_TOPK_ROUND(6, 1) SCAN_TOPK_ROUND(7, 0) SCAN_TOPK_ROUND(7, 1)
#undef SCAN_TOPK_ROUND
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) a[b] = opaque(a[b]);
}

// Of a round's pass bits (bit 2jj + c: tile row 32r + 8jj + 2t + c), those
// of rows below Rs (all but in the last tile's tail).
__device__ __forceinline__ uint32_t in_rows(uint32_t bits, int nexist, int r, int t) {
  if (nexist < kRoundRows * (r + 1)) {  // warp-uniform
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (kRoundRows * r + 8 * (b >> 1) + 2 * t + (b & 1) >= nexist) bits &= ~(1u << b);
  }
  return bits;
}

// The pass bits of one round's 8 entries of a query from the hot test's sum
// of powers of two: the live rows that pass, the masked rows where `neg` is
// 0xff, no row past Rs.
__device__ __forceinline__ uint32_t round_bits(float hot, uint32_t live, uint32_t neg,
                                               int nexist, int r, int t) {
  return in_rows(((__float_as_uint(hot + 8388608.f) & live) | (neg & ~live)) & 0xffu, nexist, r, t);
}

// scan_topk's epilogue of one consumer warpgroup's 64 queries x 256 rows:
// 8 offer rounds of 32 rows a query (accumulator column blocks 4r .. 4r + 3).
// Query row qr of the CTA (slot0 + 16 warp + g + 8i for this thread's i)
// keeps its threshold at qthr[qr] (the w-th (key, row) after the buffer's
// last cut; key INT_MAX past Q, which nothing beats), its buffer at cbuf +
// qr * cap (a score's float bits and its row an entry) and the buffer's
// count at qcnt[qr], which the lanes of the quad that scores the query
// raise by atomics to take their slots. bnd[i]: the query's bound, read at
// the item's start. tally[0], tally[1] count the warp's offer rounds that
// entered the append path (a lane's 8 rows of one query) and its cuts.
//
// The limit an entry must beat is the larger of the query's bound (keys at
// it pass) and its threshold. The hot test is a float compare that keeps
// every entry that could beat it (ties, -0 against +0 and NaN included:
// entries appended in excess only take room); masked rows, which all tie at
// -3e38, pass by the exact rule (at a bound, or before the threshold's row
// where the threshold is -3e38). The cuts rank entries by their exact
// total-order keys.
//
// The hot test of every score of the item against the limits at the item's
// start runs branch-free on the FMA pipe, and a lane with entries in a
// round takes their slots by one shared-memory atomic and writes them right
// there, predicated, from the scores in its registers: no offsets to agree
// on across the quad, no warp-collective step. A lane whose slots would
// pass the buffer's end writes nothing from that round on, and notes where
// its slots began (every slot below the first such start was written). One
// warp vote an item then asks whether a lane found no room. Only then (a
// scan's first items, and every cap - w appends of a query after) the
// counted path runs: the quads that lack room are cut to their w best
// (raising the threshold, publishing the w-th key as the query's bound),
// and the lanes go on from the round that did not fit, against the current
// limit.
template <bool L2>
__device__ __forceinline__ void offer_topk(const int (&acc)[128],
                                           const float4* __restrict__ epi,
                                           const uint32_t* __restrict__ mask, int2* cbuf,
                                           int2* qthr, int* qcnt, int* qbest, int* hist,
                                           int* tally,
                                           const int (&bnd)[2], const Args& p, int row0,
                                           int q0, int slot0, bool first, int warp,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
  const int nexist = p.rs - row0;  // rows of the tile below Rs
  // {scale, scale, norm, norm} of tile rows 8j + 2t, + 1 at epi[4j + t]
  const float2* en = reinterpret_cast<const float2*>(epi);
  const int qr0 = slot0 + warp * 16 + g;  // query row of i = 0 in the CTA; i = 1: + 8
  const int kneg = ordered(kNeg);
  int skip[2], fail[2];  // the first round that found no room (8: none); where its slots began
  int beff[2];           // the bounds
  float lim[2], qs_[2];  // the limits as floats, the scales
  uint32_t neg[2], qon_[2];
  int appended = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    const uint32_t qon = q0 - slot0 + qr < p.nq ? 0xffu : 0u;
    const int thr = qthr[qr].x;
    const float qs = qon ? __ldg(p.qsc + q0 - slot0 + qr) : 0.f;
    beff[i] = bnd[i];
    if (first && p.w <= kRoundRows && nexist >= kRowTile) {  // warp-uniform
      // a CTA's first item: every entry would pass. The least of the quad's
      // 32 lane-round maxima (as keys: -0 below +0) is a key that 32 >= w
      // distinct entries reach, a bound for every CTA
      int least = INT_MAX;
#pragma unroll
      for (int r = 0; r < kRowTile / kRoundRows; ++r) {
        asm volatile("" ::: "memory");
        const uint32_t live = (mask[r] >> (8 * t)) & 0xffu;
        int most = INT_MIN;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 sc = en[2 * (4 * (4 * r + jj) + t)];
          const float2 nm = L2 ? en[2 * (4 * (4 * r + jj) + t) + 1] : make_float2(0.f, 0.f);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = topk_score<L2>(opaque(acc[4 * (4 * r + jj) + 2 * i + c]), qs,
                                           c ? sc.y : sc.x, c ? nm.y : nm.x);
            most = max(most, ordered((live >> (2 * jj + c)) & 1 ? x : kNeg));
          }
        }
        least = min(least, most);
      }
      least = min(least, __shfl_xor_sync(0xffffffffu, least, 1));
      least = min(least, __shfl_xor_sync(0xffffffffu, least, 2));
      if (qon && least > beff[i]) {
        beff[i] = least;
        // (a bound at or below -3e38 would only let the masked rows' ties pass)
        if (t == 0 && least > kneg)
          atomicMax(p.qbound + q0 - slot0 + qr, (unsigned)least ^ 0x80000000u);
      }
    }
    const int lim_k = max(beff[i], thr);
    lim[i] = limit_float(lim_k);
    // masked rows: the threshold's row lies in an earlier item
    neg[i] = kneg > lim_k || (kneg == lim_k && beff[i] > thr) ? qon : 0u;
    qon_[i] = qon;
    qs_[i] = qs;
    skip[i] = 8;
    fail[i] = p.cap;
  }
  // the hot test, a round at a time for both queries (one load of the
  // round's scales), and the appends of the rounds where a lane has an entry
  bool wput[2] = {false, false};         // the warp appended for query row i
  float top[2] = {-INFINITY, -INFINITY};  // the best score this lane appended
#pragma unroll
  for (int r = 0; r < kRowTile / kRoundRows; ++r) {
    float x[2][8];
    float pairs[2][4];  // the pass bits of entries 2jj, 2jj + 1 as 0..3
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float2 sc = en[2 * (4 * (4 * r + jj) + t)];
      const float2 nm = L2 ? en[2 * (4 * (4 * r + jj) + t) + 1] : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          x[i][2 * jj + c] = topk_score<L2>(acc[4 * (4 * r + jj) + 2 * i + c], qs_[i],
                                            c ? sc.y : sc.x, c ? nm.y : nm.x);
        pairs[i][jj] = __fmaf_rn(geu(x[i][2 * jj + 1], lim[i]), 2.f, geu(x[i][2 * jj], lim[i]));
      }
    }
    float hot[2];  // the round's pass bits as sums of powers of two
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hot[i] = __fmaf_rn(__fmaf_rn(pairs[i][3], 4.f, pairs[i][2]), 16.f,
                         __fmaf_rn(pairs[i][1], 4.f, pairs[i][0]));
    const uint32_t live_r = (mask[r] >> (8 * t)) & 0xffu;
    uint32_t put[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      put[i] = skip[i] == 8 ? round_bits(hot[i], live_r & qon_[i], neg[i], nexist, r, t) : 0u;
    if (!__any_sync(0xffffffffu, (put[0] | put[1]) != 0)) continue;  // warp-uniform: most rounds
    const int rb = row0 + kRoundRows * r + 2 * t;  // the row of bit 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = qr0 + 8 * i;
      wput[i] |= __any_sync(0xffffffffu, put[i] != 0);
      const int k = __popc(put[i]);
      const int at = k ? atomicAdd(qcnt + qr, k) : 0;
      if (at + k > p.cap) {  // no room: nothing from this round on
        skip[i] = r;
        fail[i] = at;
        put[i] = 0;
      }
      appended += put[i] != 0;
      int2* dst = cbuf + qr * p.cap + at;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const bool on = (put[i] >> b) & 1;
        const float v = (live_r >> b) & 1 ? x[i][b] : kNeg;
        if (on) {
          *dst = make_int2(__float_as_int(v), rb + 8 * (b >> 1) + (b & 1));
          top[i] = fmaxf(top[i], v);
        }
        dst += on;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (wput[i]) {  // warp-uniform: publish the list's best key of the query where it rose
      const int qr = qr0 + 8 * i;
      float tb = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 1));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, 2));
      const int key = ordered(tb);
      if (t == 0 && key > qbest[qr]) {
        qbest[qr] = key;
        p.best[(size_t)(q0 - slot0 + qr) * p.lists + blockIdx.x / p.n_qpairs] =
            (unsigned)key ^ 0x80000000u;
      }
    }
  }
  if (appended) atomicAdd(tally, appended);
  if (!__any_sync(0xffffffffu, skip[0] < 8 || skip[1] < 8)) return;  // warp-uniform
  appended = 0;

  // the counted path: cut the quads that lack room, then go on from the
  // rounds that did not fit; until every lane has appended its item
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    const uint32_t qon = q0 - slot0 + qr < p.nq ? 0xffu : 0u;
    const float qs = qon ? __ldg(p.qsc + q0 - slot0 + qr) : 0.f;
    const int q_bnd = i ? beff[1] : beff[0];
    int2* qb = cbuf + qr * p.cap;
    int from = i ? skip[1] : skip[0];
    int start = i ? fail[1] : fail[0];
    while (__any_sync(0xffffffffu, from < 8)) {  // warp-uniform
      // the buffer ends where the quad's first slots that found no room began
      int end = start, want = from < 8;
      end = min(end, __shfl_xor_sync(0xffffffffu, end, 1));
      end = min(end, __shfl_xor_sync(0xffffffffu, end, 2));
      want |= __shfl_xor_sync(0xffffffffu, want, 1);
      want |= __shfl_xor_sync(0xffffffffu, want, 2);
      __syncwarp();
      const int cnt = min(qcnt[qr], end);
      __syncwarp();
      if (t == 0) qcnt[qr] = cnt;
      // cut the quads with a lane that lacks room (those holding more than w:
      // a cut of the rest would raise nothing; they have room for a round of
      // each lane)
      unsigned m = __ballot_sync(0xffffffffu, t == 0 && want && cnt > p.w);
      __syncwarp();  // every lane's appends, before one warp reads a buffer
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int sr = qr - g + src / 4;
        const int2 kr = select_any(cbuf + sr * p.cap, __shfl_sync(0xffffffffu, cnt, src), p.w,
                                   hist, lane);
        if (lane == 0) {
          qthr[sr] = kr;
          qcnt[sr] = p.w;
          if (kr.x > kneg) atomicMax(p.qbound + q0 - slot0 + sr, (unsigned)kr.x ^ 0x80000000u);
          tally[1] += 1;
        }
      }
      __syncwarp();
      const int2 th = qthr[qr];
      const int lim_k = max(q_bnd, th.x);
      const float tl = limit_float(lim_k);
      start = p.cap;
      while (from < 8) {  // this lane's rounds from `from`, as long as they fit
        const int r = from;
        const uint32_t live = (mask[r] >> (8 * t)) & qon;
        int a[8];
        round_raw(acc, r, i, a);
        const int rb = row0 + kRoundRows * r + 2 * t;
        float v[8];
        uint32_t bits = 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 sc = en[2 * (4 * (4 * r + jj) + t)];
          const float2 nm = L2 ? en[2 * (4 * (4 * r + jj) + t) + 1] : make_float2(0.f, 0.f);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int b = 2 * jj + c;
            v[b] = topk_score<L2>(a[b], qs, c ? sc.y : sc.x, c ? nm.y : nm.x);
            // masked rows by the exact rule, the threshold's row now perhaps
            // in this item
            const bool pass = (live >> b) & 1
                ? !(v[b] < tl)
                : kneg > lim_k || (kneg == lim_k && (q_bnd > th.x || rb + 8 * jj + c < th.y));
            bits |= (uint32_t)pass << b;
          }
        }
        bits = in_rows(bits, nexist, r, t) & qon;
        const int k = __popc(bits);
        const int at = k ? atomicAdd(qcnt + qr, k) : 0;
        if (at + k > p.cap) {
          start = at;
          break;
        }
        appended += k != 0;
        int2* dst = qb + at;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if ((bits >> b) & 1)
            *dst++ = make_int2(__float_as_int((live >> b) & 1 ? v[b] : kNeg),
                               rb + 8 * (b >> 1) + (b & 1));
        ++from;
      }
    }
  }
  if (appended) atomicAdd(tally, appended);
}

// After the CTA's last item: each of the warp's live queries' w best,
// sorted, to its list `list` (entries past the buffer's count: INT_MIN /
// kNoRow, below every score).
__device__ __forceinline__ void finish_topk(int2* cbuf, const int* qcnt, int* hist,
                                            const Args& p, int q0, int slot0, int list,
                                            int warp, int lane) {
  __syncwarp();  // every lane's appends, before one warp reads a buffer
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int gq = 0; gq < 8; ++gq) {
      const int qr = warp * 16 + gq + 8 * i;
      if (q0 + qr >= p.nq) continue;  // warp-uniform
      int2* qb = cbuf + (slot0 + qr) * p.cap;
      int n = qcnt[slot0 + qr];
      if (n > p.w) {
        select_any(qb, n, p.w, hist, lane);
        n = p.w;
      }
      int k[2], r[2];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int e = ii * 32 + lane;
        const int2 v = e < n ? qb[e] : make_int2(0, kNoRow);
        k[ii] = e < n ? ordered(__int_as_float(v.x)) : INT_MIN;
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
  // scan_topk: validity words of each slot, histograms, counters, candidate buffers
  uint32_t* mask = reinterpret_cast<uint32_t*>(past_epi);
  int* hist_all = reinterpret_cast<int*>(past_epi + kMaskBytes);
  int* tally_all = reinterpret_cast<int*>(past_epi + kMaskBytes + kHistBytes);
  int2* qthr = reinterpret_cast<int2*>(past_epi + kMaskBytes + kHistBytes + kTallyBytes);
  int* qcnt = reinterpret_cast<int*>(qthr + kCtaQueries);
  int* qbest = qcnt + kCtaQueries;
  int2* cbuf = reinterpret_cast<int2*>(qbest + kCtaQueries);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      TOPK ? reinterpret_cast<uint8_t*>(cbuf + kCtaQueries * p.cap) : past_epi);
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
  // (rows deeper than the ring are read from L2 once, not once a consumer;
  // and its epilogue, bound by latency, runs faster with both consumers in
  // it at once than beside the other's products). Its pair is the same on
  // every item, so a consumer whose tile lies past Q reads nothing.
  constexpr bool kTurns = STORAGE != 2 && !TOPK;
  const bool share = !kTurns || n_k <= stages;
  const int wg = threadIdx.x / 128;
  // scan_topk: the CTA's pair has a second tile below Q (else only consumer
  // 0 reads the stages)
  bool pair2 = false;
  if constexpr (TOPK) pair2 = 2 * (blockIdx.x % p.n_qpairs) + 1 < p.n_qtiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // f32: the queries' TMA bytes and every converter thread's rows
      mbar_init(full + s, STORAGE == 2 ? 1 + kConvThreads : 1);
      if constexpr (TOPK) mbar_init(empty + s, pair2 ? 256 : 128);
      else mbar_init(empty + s, share ? 256 : 128);
    }
    for (int e = 0; e < kEpiSlots; ++e) {
      mbar_init(epi_full + e, 32);
      if constexpr (TOPK) mbar_init(epi_empty + e, pair2 ? 256 : 128);
      else mbar_init(epi_empty + e, 256);
    }
    mbar_init(turn, 128);
    mbar_init(turn + 1, 128);
    if constexpr (TOPK) tally_all[16] = 0;
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
            // row 8jj + 2t + c of the word at bit 8t + 2jj + c: byte t holds
            // quad lane t's rows in its pass-bit order
            const int at = 8 * ((lane >> 1) & 3) + 2 * (lane >> 3) + (lane & 1);
            const unsigned bits = __reduce_or_sync(0xffffffffu, (unsigned)v[i] << at);
            if (lane == 0) mask[e * kMaskWords + i] = bits;
          }
        }
        mbar_arrive(epi_full + e);
      }
    } else if (TOPK && warp >= 2 && p.lists >= p.w) {
      // warps 2-3: the pooled bounds, again and again until the consumers
      // are done. The least of the lists' best keys of a query, once every
      // list has one, is a key that lists >= w distinct entries reach, so no
      // key below it is among the w best. It goes to the published bounds,
      // which every CTA reads at each item, so one CTA of the pair computes
      // it: list l takes the pair's queries l, l + lists, ..., a thread each
      const int qi = blockIdx.x / p.n_qpairs + (threadIdx.x - 256 - 64) * p.lists;
      const int q = 2 * (blockIdx.x % p.n_qpairs) * kQueryTile + qi;
      const int done = pair2 ? 8 : 4;  // consumer warps
      // (a bound at or below -3e38 would only let the masked rows' ties pass)
      int last = ordered(kNeg);
      while (*reinterpret_cast<volatile int*>(tally_all + 16) < done) {
        if (qi < kCtaQueries && q < p.nq) {
          const unsigned* b = p.best + (size_t)q * p.lists;
          int least = INT_MAX;
          for (int l = 0; l < p.lists; l += 4) {
            int k[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              k[j] = l + j < p.lists ? (int)(__ldcg(b + l + j) ^ 0x80000000u) : INT_MAX;
#pragma unroll
            for (int j = 0; j < 4; ++j) least = min(least, k[j]);
          }
          if (least > last) {
            last = least;
            atomicMax(p.qbound + q, (unsigned)least ^ 0x80000000u);
          }
        }
        __nanosleep(5000);
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
    if constexpr (TOPK) {
      if (c == 1 && !pair2) return;
    }
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
    // scan_topk: the CTA's query pair is the same on every item (the grid
    // is a multiple of the pairs), so each query's state lives across items
    int* tally = tally_all + 2 * (threadIdx.x / 32);
    int bnd[2] = {INT_MIN, INT_MIN};
    const int tq0 = (2 * (blockIdx.x % p.n_qpairs) + c) * kQueryTile;
    if constexpr (TOPK) {
      // each query's threshold key (every entry passes INT_MIN; none but NaN
      // passes INT_MAX) and this thread's counts
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qr = warp * 16 + lane / 4 + 8 * i;
        qthr[c * kQueryTile + qr] = tq0 + qr < p.nq ? make_int2(INT_MIN, kNoRow)
                                                    : make_int2(INT_MAX, -1);
        qcnt[c * kQueryTile + qr] = 0;
        qbest[c * kQueryTile + qr] = INT_MIN;
      }
      if (lane == 0) tally[0] = tally[1] = 0;
      __syncwarp();
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
          if (q < p.nq) bnd[i] = (int)(__ldcg(p.qbound + q) ^ 0x80000000u);
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
          offer_topk<L2>(acc, epi + e * (kRowTile / 2), mask + e * kMaskWords, cbuf, qthr,
                         qcnt, qbest, hist_all + (threadIdx.x / 32) * kBins, tally, bnd, p, row0,
                         q0, c * kQueryTile, n == 0, warp, lane);
        else
          select_top2(acc, epi + e * (kRowTile / 2), p, row0, q0, warp, lane);
      }
      mbar_arrive(epi_empty + e);
    }
    if constexpr (TOPK) {
      if (lane == 0) atomicAdd(tally_all + 16, 1);  // done: the pooled bounds may stop
      if (tq0 + warp * 16 < p.nq)  // warp-uniform
        finish_topk(cbuf, qcnt, hist_all + (threadIdx.x / 32) * kBins, p, tq0,
                    c * kQueryTile, blockIdx.x / p.n_qpairs, warp, lane);
      // the counters: each warp's, once, at its end
      if (lane == 0) {
        atomicAdd(p.counts, tally[0]);
        atomicAdd(p.counts + 1, tally[1]);
      }
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

// The exact top-w (1 <= w <= min(64, rs)) of int8 rows: clears `qbound`
// (nq bounds; the call's two counters: offer rounds that entered the append
// path and cuts; then nq x lists best keys, one of each CTA for each of its
// queries), launches
// scan_topk_s8 with the caller's geometry (`grid` a multiple of the query
// pairs, at most 256 lists a pair and no more than the row tiles; `stages`
// ring stages; exactly topk_smem_bytes(w, stages) bytes) writing the (nq, grid /
// pairs, w) lists to part_key / part_row, then scan_topk_merge with
// `merge_warps` queries a block and merge_smem = merge_warps * lists * w * 8
// bytes into out_s (nq, w) f32 and out_i (nq, w) int64 shard rows. `norm`
// is read when l2 is set.
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
  cudaError_t err =
      cudaMemsetAsync(qbound, 0, (size_t)(nq + 2 + nq * lists) * sizeof(unsigned), s);
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
  args.counts = reinterpret_cast<int*>(qbound + nq);
  args.best = qbound + nq + 2;
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
