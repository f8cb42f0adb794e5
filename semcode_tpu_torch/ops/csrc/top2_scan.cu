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
// Design: one block of 256 threads (8 warps) owns 128 rows x 64 queries.
// The depth dimension is walked in 128-byte chunks staged through shared
// memory (rows padded to 144 bytes so fragment loads are conflict-free);
// each warp owns 16 rows and issues mma.sync over 8 query tiles of 8. The
// epilogue writes the 128 x 64 score tile to shared memory (aliasing the
// staging buffers) and each warp reduces 8 queries to their top-2 with
// shuffles. The (Q, R) score matrix never reaches device memory.
//
// Bound on an H100 at 1M x 384 int8, Q=512: 4e11 int8 ops (0.2 ms at peak)
// over 384 MB of rows (0.11 ms): operation-bound. This version stages
// synchronously (no cp.async/TMA pipeline) and uses mma.sync, not wgmma.
//
// Plain C interface (loaded with ctypes): returns the cudaError_t of the
// launch; the caller allocates the outputs and owns the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 128;          // rows per block = one top-2 block
constexpr int kQueries = 64;        // queries per block
constexpr int kChunk = 128;         // bytes of depth staged per step
constexpr int kStride = kChunk + 16;  // padded smem row stride (bytes)
constexpr int kThreads = 256;
constexpr int kScoreStride = kRows + 1;  // padded score-tile row (floats)
constexpr float kNeg = -3.0e38f;

struct Stage {
  uint8_t rows[kRows * kStride];
  uint8_t queries[kQueries * kStride];
};

union Smem {
  Stage stage;
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(int x) { return __int2float_rn(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// (score, row) ordering: higher score first, then lower row
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Stage `kRows` rows of the current depth chunk into shared memory.
// STORAGE 0/1: the chunk is 128 bytes of the row as stored (int8 / bf16).
// STORAGE 2: the chunk is 64 f32 values, rounded to bf16 on the way in.
template <int STORAGE>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* vecs,
                                           int row0, int rs, int d, int chunk) {
  if (STORAGE == 2) {
    const int per_row = kChunk / 8;  // 16 loads of 4 floats -> 8 bytes each
    for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, c = i % per_row;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < rs) {
        const float* src = reinterpret_cast<const float*>(vecs) +
                           (size_t)(row0 + r) * d + (size_t)chunk * 64 + c * 4;
        v = *reinterpret_cast<const float4*>(src);
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + r * kStride + c * 8) = packed;
    }
  } else {
    const int esize = STORAGE == 0 ? 1 : 2;
    const int per_row = kChunk / 16;  // 8 loads of 16 bytes
    for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, c = i % per_row;
      int4 v = make_int4(0, 0, 0, 0);
      if (row0 + r < rs) {
        const uint8_t* src = vecs + (size_t)(row0 + r) * d * esize +
                             (size_t)chunk * kChunk + c * 16;
        v = *reinterpret_cast<const int4*>(src);
      }
      *reinterpret_cast<int4*>(dst + r * kStride + c * 16) = v;
    }
  }
}

// Stage `kQueries` query rows (int8 or bf16, `qbytes` bytes per row).
__device__ __forceinline__ void stage_queries(uint8_t* dst, const uint8_t* qq,
                                              int q0, int nq, int qbytes,
                                              int chunk) {
  const int per_row = kChunk / 16;
  for (int i = threadIdx.x; i < kQueries * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    int4 v = make_int4(0, 0, 0, 0);
    if (q0 + r < nq) {
      v = *reinterpret_cast<const int4*>(qq + (size_t)(q0 + r) * qbytes +
                                         (size_t)chunk * kChunk + c * 16);
    }
    *reinterpret_cast<int4*>(dst + r * kStride + c * 16) = v;
  }
}

template <int STORAGE>
__global__ void __launch_bounds__(kThreads)
top2_scan_kernel(const uint8_t* __restrict__ vecs,
                 const float* __restrict__ mult,
                 const float* __restrict__ add,
                 const uint8_t* __restrict__ qq,
                 const float* __restrict__ qsc,
                 float* __restrict__ bmax, int* __restrict__ brow,
                 int rs, int d, int nq, int n_qtiles) {
  using Acc = typename std::conditional<STORAGE == 0, int, float>::type;
  __shared__ __align__(16) Smem smem;

  // query tiles vary fastest, so the blocks sharing one row block run
  // together and re-read its rows from L2 rather than device memory
  const int qtile = blockIdx.x % n_qtiles;
  const int blk = blockIdx.x / n_qtiles;
  const int q0 = qtile * kQueries;
  const int row0 = blk * kRows;
  const int nb = (rs + kRows - 1) / kRows;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int m0 = warp * 16;              // this warp's first row in the block

  const int qbytes = STORAGE == 0 ? d : 2 * d;
  const int n_chunks = qbytes / kChunk;

  Acc acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = Acc(0);

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    stage_rows<STORAGE>(smem.stage.rows, vecs, row0, rs, d, chunk);
    stage_queries(smem.stage.queries, qq, q0, nq, qbytes, chunk);
    __syncthreads();
    const uint8_t* A = smem.stage.rows;
    const uint8_t* B = smem.stage.queries;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      // the s8 k32 and bf16 k16 fragments read the same byte offsets
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(A + (m0 + g) * kStride + kk + t * 4);
      a[1] = *reinterpret_cast<const uint32_t*>(A + (m0 + g + 8) * kStride + kk + t * 4);
      a[2] = *reinterpret_cast<const uint32_t*>(A + (m0 + g) * kStride + kk + 16 + t * 4);
      a[3] = *reinterpret_cast<const uint32_t*>(A + (m0 + g + 8) * kStride + kk + 16 + t * 4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint8_t* bq = B + (n * 8 + g) * kStride + kk + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bq);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bq + 16);
        if constexpr (STORAGE == 0) {
          mma_s8(acc[n], a, b0, b1);
        } else {
          mma_bf16(acc[n], a, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: unfused f32 rescale, row mask, score tile to shared memory
  float* S = smem.scores;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + g + (i >= 2 ? 8 : 0);
      const int q = n * 8 + t * 2 + (i & 1);
      const int row = row0 + r;
      float s = kNeg;
      if (row < rs) {
        const float qs = q0 + q < nq ? qsc[q0 + q] : 0.f;
        s = __fadd_rn(__fmul_rn(__fmul_rn(to_float(acc[n][i]), qs), mult[row]),
                      add[row]);
      }
      S[q * kScoreStride + r] = s;
    }
  }
  __syncthreads();

  // top-2 per query: lane holds rows lane, lane+32, lane+64, lane+96
  for (int qi = 0; qi < kQueries / 8; ++qi) {
    const int q = warp * (kQueries / 8) + qi;
    if (q0 + q >= nq) break;
    const float* sq = S + q * kScoreStride;
    float m1 = sq[lane], m2 = __int_as_float(0xff800000);  // -inf
    int i1 = lane, i2 = 0x7fffffff;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      const float s = sq[lane + 32 * j];
      const int i = lane + 32 * j;
      if (better(s, i, m1, i1)) {
        m2 = m1; i2 = i1; m1 = s; i1 = i;
      } else if (better(s, i, m2, i2)) {
        m2 = s; i2 = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float n1 = __shfl_xor_sync(0xffffffffu, m1, off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1, off);
      const float n2 = __shfl_xor_sync(0xffffffffu, m2, off);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2, off);
      if (better(n1, j1, m1, i1)) {
        // the other list's first wins; runner-up is the better of our
        // first and its second
        if (better(m1, i1, n2, j2)) { m2 = m1; i2 = i1; } else { m2 = n2; i2 = j2; }
        m1 = n1; i1 = j1;
      } else if (better(n1, j1, m2, i2)) {
        m2 = n1; i2 = j1;
      }
    }
    if (lane == 0) {
      // the TPU kernel picks the runner-up after overwriting the first's
      // lane with the sentinel: when nothing beats the sentinel, the
      // runner-up is the sentinel at the lowest lane holding it
      if (!(m2 > kNeg)) {
        i2 = (m2 == kNeg) ? min(i1, i2) : i1;
        m2 = kNeg;
      }
      const size_t o = (size_t)(q0 + q) * (2 * nb);
      bmax[o + blk] = m1;
      brow[o + blk] = row0 + i1;
      bmax[o + nb + blk] = m2;
      brow[o + nb + blk] = row0 + i2;
    }
  }
}

template <int STORAGE>
cudaError_t launch(const void* vecs, const float* mult, const float* add,
                   const void* qq, const float* qsc, float* bmax, int* brow,
                   int rs, int d, int nq, cudaStream_t stream) {
  const int n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long nb = (rs + kRows - 1) / kRows;
  const long long blocks = nb * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  top2_scan_kernel<STORAGE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(vecs), mult, add,
      static_cast<const uint8_t*>(qq), qsc, bmax, brow, rs, d, nq, n_qtiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int semcode_top2_scan(const void* vecs, const float* mult,
                                 const float* add, const void* qq,
                                 const float* qsc, float* bmax, int* brow,
                                 int rs, int d, int nq, int storage,
                                 void* stream) {
  if (rs <= 0 || nq <= 0 || d <= 0 || d % 128 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch<0>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq, s);
    case 1: return launch<1>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq, s);
    case 2: return launch<2>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq, s);
    default: return cudaErrorInvalidValue;
  }
}
