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
// Plain C interface (loaded with ctypes): returns the cudaError_t of the
// launch; the caller allocates the outputs, owns the stream, and chooses the
// launch geometry (ops/scan_top2.scan_geometry), which is checked here.

#include <cuda_runtime.h>
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

struct Args {
  const float* mult;
  const float* add;
  const float* qsc;
  float* bmax;
  int* brow;
  int rs, d, nq, stages, n_qtiles, n_qpairs, n_units;
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

template <int STORAGE>
__global__ void __launch_bounds__(kThreads, 1)
top2_scan_kernel(const __grid_constant__ CUtensorMap rows_map,
                 const __grid_constant__ CUtensorMap q_map, const Args p) {
  using Acc = typename std::conditional<STORAGE == 0, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
      ~uintptr_t(kSmemAlign - 1));
  const int stages = p.stages;
  // stage s: rows [0, 32K), query tile 0 [32K, 40K), query tile 1 [40K, 48K)
  uint8_t* raw = smem + stages * kStageBytes;  // f32: kRawStages row stages
  float4* epi = reinterpret_cast<float4*>(raw + raw_bytes(STORAGE));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(epi) + kEpiSlots * kEpiBytes);
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
  constexpr bool kTurns = STORAGE != 2;
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
                tma_load(raw + r * kRawBytes, &rows_map, raw_full + r,
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
            if (STORAGE != 2) tma_load(st, &rows_map, full + s, kx, row0);
            for (int c = pass; c < pass + nq_tiles; ++c)
              tma_load(st + kRowChunkBytes + c * kQueryChunkBytes, &q_map,
                       full + s, kx, (qt0 + c) * kQueryTile);
          }
        }
      }
    } else if (warp == 1) {
      // mult/add of each item's row tile, interleaved {m, m, a, a} per row
      // pair; rows past Rs get mult 0 and add -3e38, so their zero-filled
      // products score exactly the sentinel
      int n = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x, ++n) {
        const int row0 = (u / p.n_qpairs) * kRowTile;
        // all 16 loads in flight before the slot is claimed: one memory
        // round trip per item
        constexpr int kPer = kRowTile / 32;
        float m[kPer], a[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int row = row0 + 32 * i + lane;
          m[i] = row < p.rs ? p.mult[row] : 0.f;
          a[i] = row < p.rs ? p.add[row] : kNeg;
        }
        const int e = n % kEpiSlots;
        mbar_wait(epi_empty + e, ((n / kEpiSlots) & 1) ^ 1);
        float* dst = reinterpret_cast<float*>(epi + e * (kRowTile / 2));
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = 32 * i + lane;
          dst[(r >> 1) * 4 + (r & 1)] = m[i];
          dst[(r >> 1) * 4 + 2 + (r & 1)] = a[i];
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
    int n = 0, pos = 0;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x, ++n) {
      const int row0 = (u / p.n_qpairs) * kRowTile;
      const int qt0 = 2 * (u % p.n_qpairs);
      const int q0 = (qt0 + c) * kQueryTile;
      const bool live = q0 < p.nq;
      const bool live1 = qt0 + 1 < p.n_qtiles;
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
          const uint8_t* st = smem + s * kStageBytes;
          const uint64_t a = sw128_desc(st + kRowChunkBytes + c * kQueryChunkBytes);
          const uint64_t b = sw128_desc(st);
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
      if (TOP2_PROBE != 1 && live && q0 + warp * 16 < p.nq)  // warp-uniform
        select_top2(acc, epi + e * (kRowTile / 2), p, row0, q0, warp, lane);
      mbar_arrive(epi_empty + e);
    }
  }
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
  const Args args{mult, add, qsc, bmax, brow, rs, d, nq, stages,
                  (int)n_qtiles, (int)n_qpairs, (int)units};
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
