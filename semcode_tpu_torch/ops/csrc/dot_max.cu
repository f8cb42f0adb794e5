// Per-query maximum of an int8 dot product over a corpus, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of tools/dot_pallas.py::make_kernel (TPU), the
// int8 GEMM rate probe. Computes, for every query i,
//     out[i] = max_r  sum_k q[i][k] * rows[r][k]          (int32, exact)
// in one of two modes:
//   mode 0 ("s32"):  s8 x s8 -> s32 on the tensor cores (mma m16n8k32);
//   mode 1 ("bf16"): operands widened to bf16 on the way into shared memory,
//                    bf16 x bf16 products summed in f32 (mma m16n8k16), the
//                    sum converted to int32 before the max: the TPU tool's
//                    "bf16cast" form. Exact while every partial sum stays
//                    below 2^24, i.e. d * 127^2 < 2^24 (d <= 1040) for values
//                    in [-127, 127]; the caller refuses a larger d.
//
// Design: the tiling of top2_scan.cu's first design (its bf16/f32 path), so
// that on int8 operands this kernel times that tiling's GEMM with no
// selection, the yardstick for top2_scan's int8 kernel (TMA, wgmma, selection
// in registers). One block of 256 threads (8 warps) owns ROWS rows x 64
// queries (ROWS in {64, 128, 256}: the TPU tool's row-tile sweep); the depth
// is walked in 128-byte chunks (128 int8 values, or 64 values widened to
// bf16) staged synchronously through shared memory with rows padded to 144
// bytes, and each warp runs mma.sync over its 16-row tiles and 8-query
// tiles. The epilogue masks rows past the end, reduces each query column to
// its maximum with warp shuffles and a shared-memory atomicMax, and folds the
// block's 64 maxima into the output with a global atomicMax (initialised to
// INT32_MIN by the caller). An integer maximum does not depend on the order
// of the atomics, so the result is deterministic.
//
// Bound on an H100 at 1M x 384 int8, Q=512 (1,000,064 rows as the flat
// index pads them): 3.93e11 int8 operations, 0.199 ms at 1,979 TOP/s,
// against 384 MB of rows, 0.115 ms at 3.35 TB/s: operations bound it. The
// bf16 mode does the same operations at the 989 TFLOP/s bf16 rate: 0.398 ms.
// This version uses mma.sync and synchronous staging; wgmma, TMA and a
// persistent schedule are later work.
//
// Plain C interface (loaded with ctypes): returns the cudaError_t of the
// launch; the caller allocates and initialises the output and owns the
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQueries = 64;          // queries per block
constexpr int kChunk = 128;           // bytes of depth per staged row
constexpr int kStride = kChunk + 16;  // padded smem row stride (bytes)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBf16Dim = 1040;     // d * 127^2 < 2^24

// Warp layout of a ROWS x 64 tile: WM row groups x WN query groups; each warp
// owns MT tiles of 16 rows and NT tiles of 8 queries.
template <int ROWS>
struct Tile {
  static constexpr int WM = ROWS >= 16 * kWarps ? kWarps : ROWS / 16;
  static constexpr int WN = kWarps / WM;
  static constexpr int MT = ROWS / (16 * WM);
  static constexpr int NT = kQueries / (8 * WN);
  static_assert(WM * WN == kWarps && MT * 16 * WM == ROWS &&
                    NT * 8 * WN == kQueries,
                "unsupported row tile");
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int to_int(int x) { return x; }
// the f32 sum holds an exact integer: rounding is the identity
__device__ __forceinline__ int to_int(float x) { return __float2int_rn(x); }

// the j-th int8 value of a packed word, as a float
__device__ __forceinline__ float s8_at(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xffu));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // exact for |x| <= 128
  return *reinterpret_cast<uint32_t*>(&h);
}

// Stage `count` rows (rows base.. of a (limit, d) int8 matrix) of the current
// depth chunk into shared memory; rows at or past `limit` stage as zeros.
// MODE 0: the chunk is 128 int8 values as stored. MODE 1: the chunk is 64
// int8 values, widened to bf16 (128 bytes) on the way in.
template <int MODE>
__device__ __forceinline__ void stage(uint8_t* dst, const int8_t* src,
                                      int base, int limit, int count, int d,
                                      int chunk) {
  constexpr int per_row = 8;  // 16-byte smem stores per row
  for (int i = threadIdx.x; i < count * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    int4 v = make_int4(0, 0, 0, 0);
    if (base + r < limit) {
      const int8_t* row = src + (size_t)(base + r) * d;
      if constexpr (MODE == 0) {
        v = *reinterpret_cast<const int4*>(row + (size_t)chunk * kChunk + c * 16);
      } else {
        const int2 raw =
            *reinterpret_cast<const int2*>(row + (size_t)chunk * 64 + c * 8);
        const uint32_t w0 = static_cast<uint32_t>(raw.x);
        const uint32_t w1 = static_cast<uint32_t>(raw.y);
        v.x = static_cast<int>(pack_bf16(s8_at(w0, 0), s8_at(w0, 1)));
        v.y = static_cast<int>(pack_bf16(s8_at(w0, 2), s8_at(w0, 3)));
        v.z = static_cast<int>(pack_bf16(s8_at(w1, 0), s8_at(w1, 1)));
        v.w = static_cast<int>(pack_bf16(s8_at(w1, 2), s8_at(w1, 3)));
      }
    }
    *reinterpret_cast<int4*>(dst + r * kStride + c * 16) = v;
  }
}

template <int MODE, int ROWS>
__global__ void __launch_bounds__(kThreads)
dot_max_kernel(const int8_t* __restrict__ rows, const int8_t* __restrict__ q,
               int* __restrict__ out, int n, int d, int nq, int n_qtiles) {
  using T = Tile<ROWS>;
  using Acc = typename std::conditional<MODE == 0, int, float>::type;
  __shared__ __align__(16) uint8_t rows_s[ROWS * kStride];
  __shared__ __align__(16) uint8_t q_s[kQueries * kStride];
  __shared__ int qmax_s[kQueries];

  // query tiles vary fastest, so the blocks sharing one row tile run
  // together and re-read its rows from L2 rather than device memory
  const int qtile = blockIdx.x % n_qtiles;
  const int row0 = (blockIdx.x / n_qtiles) * ROWS;
  const int q0 = qtile * kQueries;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int m_base = wm * T::MT * 16;  // this warp's first row in the tile
  const int n_base = wn * T::NT * 8;   // this warp's first query in the tile

  if (threadIdx.x < kQueries) qmax_s[threadIdx.x] = INT_MIN;

  Acc acc[T::MT][T::NT][4];
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int n8 = 0; n8 < T::NT; ++n8)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n8][i] = Acc(0);

  const int n_chunks = MODE == 0 ? d / kChunk : d / 64;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    stage<MODE>(rows_s, rows, row0, n, ROWS, d, chunk);
    stage<MODE>(q_s, q, q0, nq, kQueries, d, chunk);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      // the s8 k32 and bf16 k16 fragments read the same byte offsets
      uint32_t a[T::MT][4];
#pragma unroll
      for (int m = 0; m < T::MT; ++m) {
        const uint8_t* A = rows_s + (m_base + m * 16 + g) * kStride + kk + t * 4;
        a[m][0] = *reinterpret_cast<const uint32_t*>(A);
        a[m][1] = *reinterpret_cast<const uint32_t*>(A + 8 * kStride);
        a[m][2] = *reinterpret_cast<const uint32_t*>(A + 16);
        a[m][3] = *reinterpret_cast<const uint32_t*>(A + 8 * kStride + 16);
      }
#pragma unroll
      for (int n8 = 0; n8 < T::NT; ++n8) {
        const uint8_t* B = q_s + (n_base + n8 * 8 + g) * kStride + kk + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(B);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(B + 16);
#pragma unroll
        for (int m = 0; m < T::MT; ++m) {
          if constexpr (MODE == 0) {
            mma_s8(acc[m][n8], a[m], b0, b1);
          } else {
            mma_bf16(acc[m][n8], a[m], b0, b1);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: each thread holds rows g, g+8 of every 16-row tile for query
  // columns t*2, t*2+1 of every 8-query tile; rows past the end are masked
  // (they were staged as zeros, which could beat a negative maximum)
#pragma unroll
  for (int n8 = 0; n8 < T::NT; ++n8) {
    int best[2] = {INT_MIN, INT_MIN};
#pragma unroll
    for (int m = 0; m < T::MT; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + m_base + m * 16 + g + (i >= 2 ? 8 : 0);
        if (row < n) best[i & 1] = max(best[i & 1], to_int(acc[m][n8][i]));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)  // across g: lanes t, t+4, ...
        best[j] = max(best[j], __shfl_xor_sync(0xffffffffu, best[j], off));
    }
    if (g == 0) {
      atomicMax(&qmax_s[n_base + n8 * 8 + t * 2], best[0]);
      atomicMax(&qmax_s[n_base + n8 * 8 + t * 2 + 1], best[1]);
    }
  }
  __syncthreads();
  if (threadIdx.x < kQueries && q0 + threadIdx.x < nq)
    atomicMax(&out[q0 + threadIdx.x], qmax_s[threadIdx.x]);
}

template <int MODE, int ROWS>
cudaError_t launch(const int8_t* rows, const int8_t* q, int* out, int n, int d,
                   int nq, cudaStream_t stream) {
  const int n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long blocks = (long long)((n + ROWS - 1) / ROWS) * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dot_max_kernel<MODE, ROWS><<<(unsigned)blocks, kThreads, 0, stream>>>(
      rows, q, out, n, d, nq, n_qtiles);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_rows(const int8_t* rows, const int8_t* q, int* out, int n,
                        int d, int nq, int rtile, cudaStream_t stream) {
  switch (rtile) {
    case 64: return launch<MODE, 64>(rows, q, out, n, d, nq, stream);
    case 128: return launch<MODE, 128>(rows, q, out, n, d, nq, stream);
    case 256: return launch<MODE, 256>(rows, q, out, n, d, nq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int semcode_dot_max(const void* rows, const void* q, int* out,
                               int n, int d, int nq, int mode, int rtile,
                               void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % kChunk != 0) return cudaErrorInvalidValue;
  if (mode == 1 && d > kMaxBf16Dim) return cudaErrorInvalidValue;
  const int8_t* r = static_cast<const int8_t*>(rows);
  const int8_t* qq = static_cast<const int8_t*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_rows<0>(r, qq, out, n, d, nq, rtile, s);
    case 1: return launch_rows<1>(r, qq, out, n, d, nq, rtile, s);
    default: return cudaErrorInvalidValue;
  }
}
