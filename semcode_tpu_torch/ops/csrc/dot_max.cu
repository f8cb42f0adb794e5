// Per-query maximum of an int8 dot product over a corpus, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of tools/dot_pallas.py::make_kernel (TPU), the
// int8 GEMM rate probe. Computes, for every query i,
//     out[i] = max_r  sum_k q[i][k] * rows[r][k]          (int32, exact)
// in one of two modes:
//   mode 0 ("s32"):  s8 x s8 -> s32 on the tensor cores (wgmma k32);
//   mode 1 ("bf16"): operands widened to bf16, bf16 x bf16 products summed
//                    in f32 (wgmma k16), the sum converted to int32 before
//                    the max: the TPU tool's "bf16cast" form. Exact while
//                    every partial sum stays below 2^24, i.e. d * 127^2 <
//                    2^24 (d <= 1040) for values in [-127, 127]; the caller
//                    refuses a larger d.
//
// What bounds it on an H100 at 1M x 384 int8, Q=512 (1,000,064 rows as the
// flat index pads them): 3.93e11 operations, 0.199 ms at the 1,979 TOP/s
// int8 rate and 0.398 ms at the 989 TFLOP/s bf16 rate, against 384 MB of
// rows, 0.115 ms at 3.35 TB/s: operations bound both modes.
//
// Design: top2_scan.cu's pipeline with a maximum for an epilogue.
// Persistent warp-specialised CTAs of three warpgroups; a work item is
// ROWS rows (64, 128 or 256: the TPU tool's row-tile sweep, wgmma N) x two
// query tiles of 64 (wgmma M, one per consumer warpgroup). The producer's
// first warp streams 128-byte depth chunks (128 int8 values) of the row tile
// and the item's live query tiles by TMA (128-byte swizzle, rows past N and
// queries past Q zero-filled). In s32 mode they land in the operand ring and
// the consumers run wgmma.m64nROWSk32.s32.s8.s8 on them. In bf16 mode the
// queries come widened already (the caller casts Q x d int8 to bf16 once:
// exact, and each query tile would otherwise be widened again for every row
// tile) and go by TMA into the operand stages, 64 values a row; the row
// tile's chunks land in a raw ring of two stages, and the consumers
// themselves widen each into the row part of two operand stages with
// hopper.cuh's to_bf16, the conversion stage top2_scan.cu shares: every
// consumer thread widens its share of stage q + 1 while its wgmmas on stage
// q run, since the widening costs the SM more time than the
// wgmma.m64nROWSk16.f32.bf16.bf16 that reads it (with three producer warps
// converting, the conversion set the pace; PERF.md).
// Both consumers read every stage of an item at once (no turns: the
// epilogue is short), so a row chunk is loaded once for both query tiles
// and no depth can deadlock the ring.
// The epilogue keeps each thread's two running maxima in registers across
// the items of one query pair (rows past N masked: zero padding could beat a
// negative maximum) and folds them into the output, quad by quad, with one
// global atomicMax per query when the CTA moves to another pair or ends
// (the caller fills the output with INT32_MIN). An integer maximum does not
// depend on the order of the atomics, so the result is deterministic. The
// grid is min(#SMs, items); item u is (row tile u / pairs, query pair u %
// pairs) and CTA b walks b, b + grid, ...: the CTAs that share a row tile run
// together and re-read it from L2.
//
// Plain C interface (loaded with ctypes): returns the cudaError_t of the
// launch; the caller allocates and initialises the output, owns the stream,
// and chooses the launch geometry (ops/dot_max.dot_geometry), which is
// checked here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQueryTile = 64;      // queries per consumer warpgroup: wgmma M
constexpr int kChunk = 128;         // bytes of depth per stage row
constexpr int kThreads = 384;       // 2 consumer warpgroups + producer
constexpr int kConvThreads = 256;   // bf16 mode: both consumer warpgroups widen
constexpr int kRawStages = 2;       // bf16 mode: int8 stages before widening
constexpr int kBarrierBytes = 256;
constexpr int kSmemAlign = 1024;    // 128-byte swizzle atoms
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory
constexpr int kMaxBf16Dim = 1040;   // d * 127^2 < 2^24

// an operand stage: ROWS rows, then query tiles 0 and 1, each row 128
// bytes; a raw stage (bf16 mode): ROWS int8 rows of 128 bytes
__host__ __device__ constexpr int stage_bytes(int rows) {
  return (rows + 2 * kQueryTile) * kChunk;
}
constexpr int smem_bytes_for(int rows, int stages, int raw_stages) {
  return kSmemAlign + stages * stage_bytes(rows) + raw_stages * rows * kChunk +
         kBarrierBytes;
}

struct Args {
  int* out;
  int n, d, nq, stages, raw_stages, n_qtiles, n_qpairs, n_units;
};

__device__ __forceinline__ int to_int(int x) { return x; }
// the f32 sum holds an exact integer: rounding is the identity
__device__ __forceinline__ int to_int(float x) { return __float2int_rn(x); }

template <int MODE, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
dot_max_kernel(const __grid_constant__ CUtensorMap rows_map,
               const __grid_constant__ CUtensorMap q_map, const Args p) {
  using Acc = typename std::conditional<MODE == 0, int, float>::type;
  constexpr int kStage = stage_bytes(ROWS);
  constexpr int kRowBytes = ROWS * kChunk;
  constexpr int kQueryBytes = kQueryTile * kChunk;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
      ~uintptr_t(kSmemAlign - 1));
  const int stages = p.stages, raw_stages = p.raw_stages;
  uint8_t* raw = smem + stages * kStage;  // bf16 mode: the int8 row stages
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + raw_stages * kRowBytes);
  uint64_t* empty = full + stages;
  uint64_t* raw_full = empty + stages;
  uint64_t* raw_empty = raw_full + raw_stages;
  const int n_raw = p.d / kChunk;                   // int8 chunks of depth
  const int n_k = MODE == 0 ? n_raw : 2 * n_raw;    // operand chunks
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // bf16: the queries' TMA bytes and every converter thread's rows
      mbar_init(full + s, MODE == 0 ? 1 : 1 + kConvThreads);
      // both consumers read every stage
      mbar_init(empty + s, 256);
    }
    for (int r = 0; r < raw_stages; ++r) {
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
      // TMA: each depth chunk of the row tile and of the live query tiles,
      // into the operand ring (s32); bf16: the row chunk into the raw ring
      // and the query tiles, 64 bf16 values at a time, into the two operand
      // stages the chunk becomes
      int pos = 0, rpos = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int row0 = (u / p.n_qpairs) * ROWS;
        const int qt0 = 2 * (u % p.n_qpairs);
        const int n_live = qt0 + 1 < p.n_qtiles ? 2 : 1;
        for (int k = 0; k < n_raw; ++k) {
          if (MODE == 1) {
            const int r = rpos % raw_stages;
            mbar_wait(raw_empty + r, ((rpos / raw_stages) & 1) ^ 1);
            mbar_expect_tx(raw_full + r, kRowBytes);
            tma_load(raw + r * kRowBytes, &rows_map, raw_full + r, k * kChunk, row0);
            ++rpos;
          }
          for (int h = 0; h < (MODE == 0 ? 1 : 2); ++h, ++pos) {
            const int s = pos % stages;
            mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
            mbar_expect_tx(full + s, (MODE == 0 ? kRowBytes : 0) + n_live * kQueryBytes);
            uint8_t* st = smem + s * kStage;
            // element coordinates: 128 int8 or 64 bf16 values a chunk
            const int kx = MODE == 0 ? k * kChunk : (2 * k + h) * (kChunk / 2);
            if (MODE == 0) tma_load(st, &rows_map, full + s, kx, row0);
            for (int c = 0; c < n_live; ++c)
              tma_load(st + kRowBytes + c * kQueryBytes, &q_map, full + s, kx,
                       (qt0 + c) * kQueryTile);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    Acc acc[ROWS / 2];
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) acc[i] = Acc(0);
    // this thread's queries warp*16 + g + 8i of query tile `cur`: maxima
    // folded into the output when the tile changes or the CTA ends
    int best[2] = {INT_MIN, INT_MIN};
    int cur = -1;
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int v = best[i];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int q = cur * kQueryTile + warp * 16 + g + 8 * i;
        if (cur >= 0 && t == 0 && q < p.nq) atomicMax(p.out + q, v);
        best[i] = INT_MIN;
      }
    };
    // the CTA's items, as one stream of operand stages q: item q / n_k,
    // depth chunk q % n_k
    const int total = (p.n_units - blockIdx.x + gridDim.x - 1) / gridDim.x * n_k;
    // bf16: widen this thread's share of operand stage q's rows (chunk half
    // q % 2 of raw stage q / 2), then publish it
    auto convert = [&](int q) {
      const int rq = q / 2, r = rq % raw_stages, s = q % stages;
      mbar_wait(raw_full + r, (rq / raw_stages) & 1);
      mbar_wait(empty + s, ((q / stages) & 1) ^ 1);
      to_bf16<int8_t, kConvThreads>(smem + s * kStage, raw + r * kRowBytes, ROWS,
                                    q & 1, threadIdx.x);
      fence_proxy_async();
      mbar_arrive(full + s);
      if (q & 1) mbar_arrive(raw_empty + r);
    };
    if (MODE == 1 && total > 0) convert(0);
    for (int q = 0; q < total; ++q) {
      const int k = q % n_k;
      const int u = blockIdx.x + (q / n_k) * gridDim.x;
      const int row0 = (u / p.n_qpairs) * ROWS;
      const int qt = 2 * (u % p.n_qpairs) + c;
      if (qt != cur) {
        flush();
        cur = qt;
      }
      // a dead query tile (past Q) is multiplied all the same, on stale
      // operands, and never flushed: a wgmma under a branch is serialised
      const int s = q % stages;
      mbar_wait(full + s, (q / stages) & 1);
      const uint8_t* st = smem + s * kStage;
      const uint64_t a = sw128_desc(st + kRowBytes + c * kQueryBytes);
      const uint64_t b = sw128_desc(st);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
        wgmma_step(acc, a + 2 * kk, b + 2 * kk, (k | kk) != 0);
      wgmma_commit();
      // bf16: the next stage's rows are widened while these products run
      if (MODE == 1 && q + 1 < total) convert(q + 1);
      if (k + 1 < n_k) {
        wgmma_wait<1>();  // the previous chunk's products are done
        fence_acc(acc);
        if (k > 0) mbar_arrive(empty + (q - 1) % stages);
        continue;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (k > 0) mbar_arrive(empty + (q - 1) % stages);
      mbar_arrive(empty + s);
      // d[4j + 2i + e] is query warp*16 + g + 8i, tile row 8j + 2t + e
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = row0 + 8 * j + 2 * t + e < p.n;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int v = to_int(acc[4 * j + 2 * i + e]);
            best[i] = in ? max(best[i], v) : best[i];
          }
        }
      }
    }
    flush();
  }
}

template <int MODE, int ROWS>
cudaError_t launch(const void* rows, const void* q, int* out, int n, int d,
                   int nq, int grid, int stages, int raw_stages, int smem_bytes,
                   cudaStream_t stream) {
  const long long n_qtiles = (nq + kQueryTile - 1) / kQueryTile;
  const long long n_qpairs = (n_qtiles + 1) / 2;
  const long long units = ((long long)n + ROWS - 1) / ROWS * n_qpairs;
  // bf16: a consumer widens stage q + 1 before it releases stage q - 1
  if (units > 0x7fffffffLL || grid < 1 || grid > units || stages < (MODE == 0 ? 2 : 3) ||
      raw_stages != (MODE == 0 ? 0 : kRawStages) ||
      smem_bytes != smem_bytes_for(ROWS, stages, raw_stages) ||
      smem_bytes > kSmemLimit ||
      (reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(q)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap rows_map, q_map;
  if (!tile_map(&rows_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rows, d, n, ROWS) ||
      !tile_map(&q_map, MODE == 0 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                q, d, nq, kQueryTile))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dot_max_kernel<MODE, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const Args args{out, n, d, nq, stages, raw_stages, (int)n_qtiles,
                  (int)n_qpairs, (int)units};
  dot_max_kernel<MODE, ROWS><<<grid, kThreads, smem_bytes, stream>>>(
      rows_map, q_map, args);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_rows(const void* rows, const void* q, int* out, int n,
                        int d, int nq, int rtile, int grid, int stages,
                        int raw_stages, int smem_bytes, cudaStream_t stream) {
  switch (rtile) {
    case 64: return launch<MODE, 64>(rows, q, out, n, d, nq, grid, stages,
                                     raw_stages, smem_bytes, stream);
    case 128: return launch<MODE, 128>(rows, q, out, n, d, nq, grid, stages,
                                       raw_stages, smem_bytes, stream);
    case 256: return launch<MODE, 256>(rows, q, out, n, d, nq, grid, stages,
                                       raw_stages, smem_bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `rows` (N, d) int8; `q` (Q, d) int8 in mode 0, bf16 (the int8 queries
// widened) in mode 1. `grid` persistent CTAs, `stages` operand stages,
// `raw_stages` int8 row stages (mode 1 only) and `smem_bytes` of dynamic
// shared memory, refused unless it is exactly what the row tile and the
// stages need.
extern "C" int semcode_dot_max(const void* rows, const void* q, int* out,
                               int n, int d, int nq, int mode, int rtile,
                               int grid, int stages, int raw_stages,
                               int smem_bytes, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % kChunk != 0) return cudaErrorInvalidValue;
  if (mode == 1 && d > kMaxBf16Dim) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_rows<0>(rows, q, out, n, d, nq, rtile, grid, stages,
                                  raw_stages, smem_bytes, s);
    case 1: return launch_rows<1>(rows, q, out, n, d, nq, rtile, grid, stages,
                                  raw_stages, smem_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}
