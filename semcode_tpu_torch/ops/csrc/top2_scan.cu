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
// operations bound it. The selection is larger on the CUDA cores: for each
// of the 5.1e8 scores a conversion, two multiplies and an add kept unfused
// for bit-exact int8, then two compares and six selects of a branch-free
// top-2 update, so it has to run beside the tensor cores, not after them.
// On one H100 (chip_smoke.py's measurement builds) the products and pipeline
// alone run at the bound and the selection alone takes the whole kernel's
// time: the selection bounds this design.
//
// int8 design (top2_scan_s8): persistent warp-specialised CTAs of three
// warpgroups. A work item is 256 rows x 2 query tiles of 64. The producer
// warpgroup's first warp streams 128-byte depth chunks of the row tile and of
// both query tiles by TMA (128-byte swizzle, rows past Rs and queries past Q
// zero-filled) into a ring of mbarrier-guarded stages; its second warp loads
// the tile's mult/add with coalesced loads (rows past Rs get add = -3e38).
// Each consumer warpgroup owns one query tile of the item and runs
// wgmma.m64n256k32.s32.s8.s8 with the queries as M and the rows as N, both
// K-major from shared memory, so every thread holds 2 queries x 64 rows of
// scores in registers: a block's top-2 is an in-thread scan over 32 values in
// row order, then two shuffle rounds across the 4 threads of a quad. No score
// reaches shared memory. The two consumers take turns at the tensor cores
// (ping-pong, an mbarrier pair), so one's selection runs while the other's
// products do; the row chunk of a stage serves both before it is released,
// halving the rows' L2 reads. The grid is min(#SMs, items); item u is (row
// tile u / pairs, query pair u % pairs) and CTA b walks b, b + grid, ...: the
// CTAs that share a row tile run together and re-read it from L2.
//
// bf16/f32 storage keeps the first design (top2_scan_mma): one block of 256
// threads owns 128 rows x 64 queries, depth staged synchronously through
// padded shared memory (f32 rounded to bf16 on the way in, which TMA cannot
// do), mma.sync bf16 m16n8k16, and the 128 x 64 score tile reduced through
// shared memory.
//
// Plain C interface (loaded with ctypes): returns the cudaError_t of the
// launch; the caller allocates the outputs, owns the stream, and chooses the
// int8 launch geometry (ops/scan_top2.scan_geometry), which is checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// Measurement builds of the int8 kernel (ops/scan_top2.PROBE_LIBRARIES, timed
// by chip_smoke.py): -DTOP2_PROBE=1 skips the selection (products and
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
// int8 storage: TMA ring + wgmma + in-register top-2, persistent ping-pong
// ---------------------------------------------------------------------------

constexpr int kRowTile = 256;    // rows per work item: wgmma N, two top-2 blocks
constexpr int kQueryTile = 64;   // queries per consumer warpgroup: wgmma M
constexpr int kChunk = 128;      // bytes of depth per stage: one swizzle atom row
constexpr int kRowChunkBytes = kRowTile * kChunk;
constexpr int kQueryChunkBytes = kQueryTile * kChunk;
constexpr int kStageBytes = kRowChunkBytes + 2 * kQueryChunkBytes;
constexpr int kEpiBytes = kRowTile * 8;  // mult and add of one row tile
constexpr int kEpiSlots = 4;             // row tiles of mult/add in flight
constexpr int kBarrierBytes = 256;
constexpr int kSmemAlign = 1024;         // 128-byte swizzle atoms
constexpr int kSmemLimit = 232448;       // a block's dynamic shared memory
constexpr int kMaxStages =
    (kSmemLimit - kSmemAlign - kEpiSlots * kEpiBytes - kBarrierBytes) / kStageBytes;
constexpr int kS8Threads = 384;          // 2 consumer warpgroups + producer

constexpr int smem_bytes_for(int stages) {
  return kSmemAlign + stages * kStageBytes + kEpiSlots * kEpiBytes + kBarrierBytes;
}

// D(64 queries x 256 rows, s32) (+)= A(64 x 32 s8) . B(256 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct S8Args {
  const float* mult;
  const float* add;
  const float* qsc;
  float* bmax;
  int* brow;
  int rs, d, nq, stages, n_qtiles, n_qpairs, n_units;
};

// One consumer warpgroup's selection for its 64 queries x 256 rows: the
// accumulator element d[4j + 2i + c] is query warp*16 + g + 8i, tile row
// 8j + 2t + c (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void select_top2(const int (&acc)[128],
                                            const float4* __restrict__ epi,
                                            const S8Args& p, int row0, int q0,
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
          const int raw = acc[4 * (16 * b + jj) + 2 * i + c];
          const float s = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(raw), qs[i]),
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

__global__ void __launch_bounds__(kS8Threads, 1)
top2_scan_s8(const __grid_constant__ CUtensorMap rows_map,
             const __grid_constant__ CUtensorMap q_map, const S8Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
      ~uintptr_t(kSmemAlign - 1));
  const int stages = p.stages;
  // stage s: rows [0, 32K), query tile 0 [32K, 40K), query tile 1 [40K, 48K)
  float4* epi = reinterpret_cast<float4*>(smem + stages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStageBytes +
                                               kEpiSlots * kEpiBytes);
  uint64_t* empty = full + stages;
  uint64_t* epi_full = empty + stages;
  uint64_t* epi_empty = epi_full + kEpiSlots;
  uint64_t* turn = epi_empty + kEpiSlots;  // turn[c]: consumer c's turn
  const int n_k = p.d / kChunk;
  // While an item's depth fits in the ring, one load of each row chunk
  // serves both consumers (consumer 1 reads it while consumer 0 selects);
  // deeper items load the row tile once for each consumer.
  const bool share = n_k <= stages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, share ? 256 : 128);
    }
    for (int e = 0; e < kEpiSlots; ++e) {
      mbar_init(epi_full + e, 32);
      mbar_init(epi_empty + e, 256);
    }
    mbar_init(turn, 128);
    mbar_init(turn + 1, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      // ring positions in the order the consumers read them: per item, one
      // pass of n_k chunks for both consumers (share), or one pass for each
      // live consumer
      int pos = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int row0 = (u / p.n_qpairs) * kRowTile;
        const int qt0 = 2 * (u % p.n_qpairs);
        const int n_live = qt0 + 1 < p.n_qtiles ? 2 : 1;
        for (int pass = 0; pass < (share ? 1 : n_live); ++pass) {
          const int nq_tiles = share ? n_live : 1;
          const uint32_t bytes = kRowChunkBytes + nq_tiles * kQueryChunkBytes;
          for (int k = 0; k < n_k; ++k, ++pos) {
            const int s = pos % stages;
            mbar_wait(empty + s, ((pos / stages) & 1) ^ 1);
            mbar_expect_tx(full + s, bytes);
            uint8_t* st = smem + s * kStageBytes;
            tma_load(st, &rows_map, full + s, k * kChunk, row0);
            for (int c = pass; c < pass + nq_tiles; ++c)
              tma_load(st + kRowChunkBytes + c * kQueryChunkBytes, &q_map,
                       full + s, k * kChunk, (qt0 + c) * kQueryTile);
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
    }
  } else {
    // ---- consumer warpgroups 0 and 1 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
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
      mbar_wait(turn + c, (n & 1) ^ (c == 0 ? 1 : 0));
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
            wgmma_s8(acc, a + 2 * kk, b + 2 * kk, (k | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's products are done
          fence_acc(acc);
        }
        if (k > 0) mbar_arrive(empty + (at - 1) % stages);
      }
      mbar_arrive(turn + (1 - c));
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

cudaError_t launch_s8(const void* vecs, const float* mult, const float* add,
                      const void* qq, const float* qsc, float* bmax, int* brow,
                      int rs, int d, int nq, int grid, int stages,
                      int smem_bytes, cudaStream_t stream) {
  const long long n_qtiles = (nq + kQueryTile - 1) / kQueryTile;
  const long long n_qpairs = (n_qtiles + 1) / 2;
  const long long units = ((long long)rs + kRowTile - 1) / kRowTile * n_qpairs;
  if (units > 0x7fffffffLL || grid < 1 || grid > units || stages < 2 ||
      stages > kMaxStages || smem_bytes != smem_bytes_for(stages) ||
      (reinterpret_cast<uintptr_t>(vecs) | reinterpret_cast<uintptr_t>(qq)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap rows_map, q_map;
  if (!int8_map(&rows_map, vecs, d, rs, kRowTile) ||
      !int8_map(&q_map, qq, d, nq, kQueryTile))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      top2_scan_s8, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const S8Args args{mult, add, qsc, bmax, brow, rs, d, nq, stages,
                    (int)n_qtiles, (int)n_qpairs, (int)units};
  top2_scan_s8<<<grid, kS8Threads, smem_bytes, stream>>>(rows_map, q_map, args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16/f32 storage: synchronous staging + mma.sync bf16 (the first design)
// ---------------------------------------------------------------------------

constexpr int kRows = 128;            // rows per block = one top-2 block
constexpr int kQueries = 64;          // queries per block
constexpr int kStride = kChunk + 16;  // padded smem row stride (bytes)
constexpr int kThreads = 256;
constexpr int kScoreStride = kRows + 1;  // padded score-tile row (floats)

struct Stage {
  uint8_t rows[kRows * kStride];
  uint8_t queries[kQueries * kStride];
};

union Smem {
  Stage stage;
  float scores[kQueries * kScoreStride];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage `kRows` rows of the current depth chunk into shared memory.
// STORAGE 1: the chunk is 128 bytes of the bf16 row as stored.
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
    const int per_row = kChunk / 16;  // 8 loads of 16 bytes
    for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, c = i % per_row;
      int4 v = make_int4(0, 0, 0, 0);
      if (row0 + r < rs) {
        const uint8_t* src = vecs + (size_t)(row0 + r) * d * 2 +
                             (size_t)chunk * kChunk + c * 16;
        v = *reinterpret_cast<const int4*>(src);
      }
      *reinterpret_cast<int4*>(dst + r * kStride + c * 16) = v;
    }
  }
}

// Stage `kQueries` bf16 query rows (`qbytes` bytes per row).
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
top2_scan_mma(const uint8_t* __restrict__ vecs,
              const float* __restrict__ mult,
              const float* __restrict__ add,
              const uint8_t* __restrict__ qq,
              const float* __restrict__ qsc,
              float* __restrict__ bmax, int* __restrict__ brow,
              int rs, int d, int nq, int n_qtiles) {
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

  const int qbytes = 2 * d;
  const int n_chunks = qbytes / kChunk;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    stage_rows<STORAGE>(smem.stage.rows, vecs, row0, rs, d, chunk);
    stage_queries(smem.stage.queries, qq, q0, nq, qbytes, chunk);
    __syncthreads();
    const uint8_t* A = smem.stage.rows;
    const uint8_t* B = smem.stage.queries;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 32) {
      // two k16 steps of bf16 per 32 bytes of depth
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
        mma_bf16(acc[n], a, b0, b1);
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
        s = __fadd_rn(__fmul_rn(__fmul_rn(acc[n][i], qs), mult[row]), add[row]);
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
      merge_top2(m1, i1, m2, i2, n1, j1, n2, j2);
    }
    if (lane == 0) {
      sentinel_rule(i1, m2, i2);
      const size_t o = (size_t)(q0 + q) * (2 * nb);
      bmax[o + blk] = m1;
      brow[o + blk] = row0 + i1;
      bmax[o + nb + blk] = m2;
      brow[o + nb + blk] = row0 + i2;
    }
  }
}

template <int STORAGE>
cudaError_t launch_mma(const void* vecs, const float* mult, const float* add,
                       const void* qq, const float* qsc, float* bmax, int* brow,
                       int rs, int d, int nq, cudaStream_t stream) {
  const int n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long nb = (rs + kRows - 1) / kRows;
  const long long blocks = nb * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  top2_scan_mma<STORAGE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(vecs), mult, add,
      static_cast<const uint8_t*>(qq), qsc, bmax, brow, rs, d, nq, n_qtiles);
  return cudaGetLastError();
}

}  // namespace

// storage 0 (int8) launches top2_scan_s8 with the caller's geometry: `grid`
// persistent CTAs, `stages` ring stages and `smem_bytes` of dynamic shared
// memory (refused unless it is exactly what `stages` needs); storage 1 (bf16)
// and 2 (f32) launch top2_scan_mma, whose grid follows from the shape, and
// ignore the three.
extern "C" int semcode_top2_scan(const void* vecs, const float* mult,
                                 const float* add, const void* qq,
                                 const float* qsc, float* bmax, int* brow,
                                 int rs, int d, int nq, int storage, int grid,
                                 int stages, int smem_bytes, void* stream) {
  if (rs <= 0 || nq <= 0 || d <= 0 || d % 128 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch_s8(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq,
                             grid, stages, smem_bytes, s);
    case 1: return launch_mma<1>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq, s);
    case 2: return launch_mma<2>(vecs, mult, add, qq, qsc, bmax, brow, rs, d, nq, s);
    default: return cudaErrorInvalidValue;
  }
}
