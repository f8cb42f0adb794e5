// IVF probing scan: masked top-k of each query against the clusters it
// probes, for Hopper (sm_90a).
//
// Replaces semcode_tpu/ops/kernels.py::ivf_scan_shard (Pallas, TPU). For
// every (query q, probed cluster c) pair it computes, over the cluster's
// cmax slots,
//     int8:       score = (float(raw) * qsc[q]) * scales[c][slot],
//                 raw = qq[q] . data[c][slot]   (s8 x s8 -> s32, exact)
//     bf16 / f32: score = q[q] . data[c][slot]  (f32 query, f32 products)
// masks slots whose id is < 0 and writes the pair's top-k (k <= 64) as
//     out_s[pair][0..k) descending, out_i[pair][0..k) = ids[c][slot],
// ties to the lowest slot; slots past the valid count hold -3e38 / -1.
// The wrapper orders each query's probes by cluster id, so a stable top-k
// over a query's pairs breaks ties by (cluster, slot).
//
// Design. The TPU kernel walks the union of probed clusters as a sequential
// grid with a running top-k in VMEM scratch; GPU blocks run in parallel and
// share nothing, so the work is cut cluster-major instead: the (cluster,
// query) pairs are sorted by cluster on the device (wrapper), and one block
// of 256 threads owns one cluster and a tile of up to 32 of the queries that
// probe it. The block streams the cluster in 128-row chunks - each cluster is
// read from device memory once per tile, not once per query - and keeps a
// sorted top-k per query in registers (two entries per lane, one warp per
// four queries), inserting only the candidates that beat its k-th entry.
//   int8: depth is staged 128 bytes at a time through shared memory and
//   multiplied on the tensor cores with mma.sync m16n8k32 (the tile code of
//   top2_scan.cu's first design); the epilogue is the reference's unfused f32
//   multiplies.
//   bf16 / f32: the query stays f32 (the reference scores float storage
//   against the f32 query), so the dot runs on the CUDA cores in f32, 32
//   depth values per staged step.
// The grid is an upper bound (pairs / 32 + clusters) read without a host
// sync; each block finds its tile by binary search and surplus blocks exit.
//
// Bound on an H100 at the main path's shape (1M x 384 int8, nlist 1024,
// cmax ~2.2k, Q=512, nprobe 32): each probed cluster read once is ~0.87 GB
// (0.26 ms at 3.35 TB/s) against 2.7e10 int8 ops (0.014 ms): bytes bound it.
//
// Plain C interface (loaded with ctypes): returns the cudaError_t of the
// launch; the caller allocates every buffer and owns the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;            // cluster rows per streamed chunk
constexpr int kQueries = 32;          // probing queries per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQPerWarp = kQueries / kWarps;  // queries each warp selects for
constexpr int kChunk = 128;           // int8: depth bytes staged per step
constexpr int kStride = kChunk + 16;  // int8: padded smem row stride (bytes)
constexpr int kFDepth = 32;           // float: depth values staged per step
constexpr int kFStride = kFDepth + 1; // float: padded smem row (floats)
constexpr int kScoreStride = kRows + 1;
constexpr int kMaxK = 64;
constexpr float kNeg = -3.0e38f;
constexpr int kNoSlot = 0x7fffffff;

struct StageI8 {
  uint8_t rows[kRows * kStride];
  uint8_t queries[kQueries * kStride];
};

struct StageF32 {
  float rows[kRows * kFStride];
  float queries[kQueries * kFStride];
};

union Smem {
  StageI8 i8;
  StageF32 f32;
  float scores[kQueries * kScoreStride];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (score, slot) ordering: higher score first, then lower slot
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

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

// Stage kRows cluster rows of one 128-byte int8 depth chunk.
__device__ __forceinline__ void stage_rows_i8(uint8_t* dst, const uint8_t* rows,
                                              int d, int chunk) {
  const int per_row = kChunk / 16;
  for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    const int4 v = *reinterpret_cast<const int4*>(rows + (size_t)r * d +
                                                  (size_t)chunk * kChunk + c * 16);
    *reinterpret_cast<int4*>(dst + r * kStride + c * 16) = v;
  }
}

__device__ __forceinline__ void stage_queries_i8(uint8_t* dst, const uint8_t* qq,
                                                 const int* qrow, int nq_tile,
                                                 int d, int chunk) {
  const int per_row = kChunk / 16;
  for (int i = threadIdx.x; i < kQueries * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < nq_tile) {
      v = *reinterpret_cast<const int4*>(qq + (size_t)qrow[r] * d +
                                         (size_t)chunk * kChunk + c * 16);
    }
    *reinterpret_cast<int4*>(dst + r * kStride + c * 16) = v;
  }
}

// Stage kRows rows x kFDepth depth values as f32 (bf16 widened exactly).
template <int STORAGE>
__device__ __forceinline__ void stage_rows_f(float* dst, const uint8_t* rows,
                                             int d, int chunk) {
  const int per_row = kFDepth / 4;  // groups of 4 values
  for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
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
  for (int i = threadIdx.x; i < kQueries * per_row; i += kThreads) {
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

template <int STORAGE>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const uint8_t* __restrict__ data,   // (nlist, cmax, d)
                const int* __restrict__ ids,        // (nlist, cmax)
                const float* __restrict__ scales,   // (nlist, cmax), int8 only
                const void* __restrict__ queries,   // (Q, d) int8 or f32
                const float* __restrict__ qsc,      // (Q,), int8 only
                const int* __restrict__ pairs,      // q * nprobe + j, by cluster
                const int* __restrict__ pair_start, // (nlist + 1,)
                const int* __restrict__ tile_start, // (nlist + 1,)
                float* __restrict__ out_s,          // (Q * nprobe, k)
                int* __restrict__ out_i,
                int nlist, int cmax, int d, int nprobe, int k) {
  __shared__ __align__(16) Smem smem;
  __shared__ int s_rowid[kRows];
  __shared__ float s_rowscale[kRows];
  __shared__ int s_pair[kQueries];
  __shared__ int s_qrow[kQueries];
  __shared__ float s_qsc[kQueries];
  __shared__ int s_cluster, s_p0, s_np;

  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    int c = -1;
    if (b < tile_start[nlist]) {
      int lo = 0, hi = nlist;  // largest c with tile_start[c] <= b
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (tile_start[mid] <= b) lo = mid; else hi = mid;
      }
      c = lo;
      const int p0 = pair_start[c] + (b - tile_start[c]) * kQueries;
      s_p0 = p0;
      s_np = min(kQueries, pair_start[c + 1] - p0);
    }
    s_cluster = c;
  }
  __syncthreads();
  const int c = s_cluster;
  if (c < 0) return;
  const int nq_tile = s_np;
  if (threadIdx.x < kQueries) {
    const int i = threadIdx.x;
    const int f = i < nq_tile ? pairs[s_p0 + i] : 0;
    s_pair[i] = f;
    s_qrow[i] = f / nprobe;
    s_qsc[i] = (STORAGE == 0 && i < nq_tile) ? qsc[f / nprobe] : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int esize = STORAGE == 0 ? 1 : (STORAGE == 1 ? 2 : 4);
  const uint8_t* cluster = data + (size_t)c * cmax * d * esize;

  TopK lists[kQPerWarp];
#pragma unroll
  for (int qi = 0; qi < kQPerWarp; ++qi) topk_init(lists[qi]);

  for (int row0 = 0; row0 < cmax; row0 += kRows) {
    __syncthreads();  // the previous chunk's readers of s_rowid are done
    if (threadIdx.x < kRows) {
      const size_t slot = (size_t)c * cmax + row0 + threadIdx.x;
      s_rowid[threadIdx.x] = ids[slot];
      s_rowscale[threadIdx.x] = STORAGE == 0 ? scales[slot] : 0.f;
    }
    const uint8_t* rows = cluster + (size_t)row0 * d * esize;
    float cand[kQPerWarp][4];

    if constexpr (STORAGE == 0) {
      const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
      const int m0 = warp * 16;              // this warp's rows in the chunk
      int acc[kQueries / 8][4];
#pragma unroll
      for (int n = 0; n < kQueries / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0;
      for (int chunk = 0; chunk < d / kChunk; ++chunk) {
        __syncthreads();  // previous readers of the staging buffers are done
        stage_rows_i8(smem.i8.rows, rows, d, chunk);
        stage_queries_i8(smem.i8.queries,
                         static_cast<const uint8_t*>(queries), s_qrow,
                         nq_tile, d, chunk);
        __syncthreads();
        const uint8_t* A = smem.i8.rows;
        const uint8_t* B = smem.i8.queries;
#pragma unroll
        for (int kk = 0; kk < kChunk; kk += 32) {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(A + (m0 + g) * kStride + kk + t * 4);
          a[1] = *reinterpret_cast<const uint32_t*>(A + (m0 + g + 8) * kStride + kk + t * 4);
          a[2] = *reinterpret_cast<const uint32_t*>(A + (m0 + g) * kStride + kk + 16 + t * 4);
          a[3] = *reinterpret_cast<const uint32_t*>(A + (m0 + g + 8) * kStride + kk + 16 + t * 4);
#pragma unroll
          for (int n = 0; n < kQueries / 8; ++n) {
            const uint8_t* bq = B + (n * 8 + g) * kStride + kk + t * 4;
            mma_s8(acc[n], a, *reinterpret_cast<const uint32_t*>(bq),
                   *reinterpret_cast<const uint32_t*>(bq + 16));
          }
        }
      }
      __syncthreads();  // the score tile aliases the staging buffers
      // epilogue: the reference's unfused f32 rescale, then the slot mask
      float* S = smem.scores;
#pragma unroll
      for (int n = 0; n < kQueries / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + g + (i >= 2 ? 8 : 0);
          const int q = n * 8 + t * 2 + (i & 1);
          float s = kNeg;
          if (s_rowid[r] >= 0) {
            s = __fmul_rn(__fmul_rn(__int2float_rn(acc[n][i]), s_qsc[q]),
                          s_rowscale[r]);
          }
          S[q * kScoreStride + r] = s;
        }
      }
      __syncthreads();
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cand[qi][j] = S[(warp * kQPerWarp + qi) * kScoreStride + lane + 32 * j];
    } else {
      // thread (warp, lane): queries warp*4 .. +3 x rows lane + 32 j, the
      // selection's own layout, so scores go straight to the lists
      float acc[kQPerWarp][4];
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[qi][j] = 0.f;
      for (int chunk = 0; chunk < d / kFDepth; ++chunk) {
        __syncthreads();
        stage_rows_f<STORAGE>(smem.f32.rows, rows, d, chunk);
        stage_queries_f(smem.f32.queries, static_cast<const float*>(queries),
                        s_qrow, nq_tile, d, chunk);
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
          for (int j = 0; j < 4; ++j)
            rv[j] = smem.f32.rows[(lane + 32 * j) * kFStride + kk];
#pragma unroll
          for (int qi = 0; qi < kQPerWarp; ++qi)
            qv[qi] = smem.f32.queries[(warp * kQPerWarp + qi) * kFStride + kk];
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
      for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cand[qi][j] = s_rowid[lane + 32 * j] >= 0 ? acc[qi][j] : kNeg;
    }

#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      if (warp * kQPerWarp + qi < nq_tile) {  // warp-uniform
        topk_offer(lists[qi], k, cand[qi], row0, lane);
      }
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

template <int STORAGE>
cudaError_t launch(const void* data, const int* ids, const float* scales,
                   const void* queries, const float* qsc, const int* pairs,
                   const int* pair_start, const int* tile_start, float* out_s,
                   int* out_i, int n_blocks, int nlist, int cmax, int d,
                   int nprobe, int k, cudaStream_t stream) {
  ivf_scan_kernel<STORAGE><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(data), ids, scales, queries, qsc, pairs,
      pair_start, tile_start, out_s, out_i, nlist, cmax, d, nprobe, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int semcode_ivf_scan_tile_queries() { return kQueries; }

extern "C" int semcode_ivf_scan(const void* data, const int* ids,
                                const float* scales, const void* queries,
                                const float* qsc, const int* pairs,
                                const int* pair_start, const int* tile_start,
                                float* out_s, int* out_i, int n_blocks,
                                int nlist, int cmax, int d, int nprobe, int k,
                                int storage, void* stream) {
  if (n_blocks <= 0 || nlist <= 0 || cmax <= 0 || cmax % kRows != 0 ||
      d <= 0 || d % 128 != 0 || nprobe <= 0 || k <= 0 || k > kMaxK) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch<0>(data, ids, scales, queries, qsc, pairs, pair_start,
                             tile_start, out_s, out_i, n_blocks, nlist, cmax, d,
                             nprobe, k, s);
    case 1: return launch<1>(data, ids, scales, queries, qsc, pairs, pair_start,
                             tile_start, out_s, out_i, n_blocks, nlist, cmax, d,
                             nprobe, k, s);
    case 2: return launch<2>(data, ids, scales, queries, qsc, pairs, pair_start,
                             tile_start, out_s, out_i, n_blocks, nlist, cmax, d,
                             nprobe, k, s);
    default: return cudaErrorInvalidValue;
  }
}
