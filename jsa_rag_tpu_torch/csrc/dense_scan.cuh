// The dense scans' scoring core, shared by topt_dense.cu (kernels B3-B7,
// each ending in the per-tile top-T emit) and mips_stream.cu (kernel B9,
// the exact streaming top-k): one block scores a tile of TQ = 32 query rows
// against TILE_N index rows into a (TQ, TILE_N + 8) score tile in shared
// memory. topt_dense.cu's header comment explains the precision of each
// instance and the design (cp.async double buffering of 128-byte chunks of
// d, padded rows, 8 warps on mma.sync m16n8k16 for 16-bit rows, a 4 x 8
// register block per thread on the f32 FMA loop).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "topt_emit.cuh"

namespace dense {

using topt::cp_async16;
using topt::cp_async_commit;
using topt::cp_async_wait_1;
using topt::NEG_INF;

constexpr int TQ = 32;        // queries per block (two planes -> 64 A rows)
constexpr int KC = 128;       // bytes of d per pipeline stage (64 elements)
constexpr int ROW = KC + 16;  // padded shared-memory row stride in bytes
constexpr int THREADS = 256;  // 8 warps
constexpr float LO_WEIGHT = 0.00048828125f;  // 2^-11, the fp16 lo plane's

template <int TILE_N, int PLANES>
struct Smem {
  static constexpr int A_BYTES = PLANES * TQ * ROW;
  static constexpr int E_BYTES = TILE_N * ROW;
  static constexpr int STAGE = A_BYTES + E_BYTES;
  static constexpr int SROW = TILE_N + 8;  // score row stride in floats
  static constexpr int SCORES = TQ * SROW * 4;
  static constexpr int TOTAL = (2 * STAGE > SCORES) ? 2 * STAGE : SCORES;
};

// m16n8k16 with f32 accumulate; fp16 and bf16 fragments share one layout
template <bool F16>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (F16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// One 16-bit score tile, three instances:
//   F16 = false, PLANES = 2: bf16 rows, q_hi and q_lo bf16 planes,
//      score = acc_hi + acc_lo;
//   F16 = true, PLANES = 2: fp16 rows, q_h and q_l fp16 planes of the
//      query scaled by 2^k, score = (acc_h + 2^-11 acc_l) * inv_s;
//   F16 = true, PLANES = 1: fp16 rows, q_h only, score = acc_h * inv_s.
// q0p, q1p: (b, d) 16-bit planes (q1p unused with one plane); inv_s: (b,)
// f32 powers of two (fp16 only); emb: (n_rows, d) 16-bit rows. Query rows
// q0 .. q0 + TQ - 1 at or past q_end and index rows past n_rows are
// zero-filled; columns n0 + c at or past n_valid score NEG_INF. `smem`
// holds Smem::TOTAL bytes; `sc` (TQ x SROW floats) may alias it: it is
// written after the last stage is consumed. Ends with a block barrier.
template <bool F16, int PLANES, int TILE_N>
__device__ __forceinline__ void mma_scores(
    unsigned char* smem, float* sc, const unsigned char* __restrict__ q0p,
    const unsigned char* __restrict__ q1p, const float* __restrict__ inv_s,
    const unsigned char* __restrict__ emb, int q_end, int d, int n_rows,
    int n_valid, int q0, int n0) {
  using S = Smem<TILE_N, PLANES>;
  constexpr int WN = TILE_N / 4;  // columns per warp
  constexpr int NT8 = WN / 8;     // n8 mma tiles per warp
  constexpr int SEGS = KC / 16;   // 16-byte segments per staged row
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1;   // which 16 queries of the tile
  const int wn = warp >> 1;  // which quarter of the columns
  const int gid = lane >> 2, tig = lane & 3;
  const int row_bytes = 2 * d;

  float acc[PLANES][NT8][4];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;

  auto load_stage = [&](int chunk, int stage) {
    unsigned char* a_s = smem + stage * S::STAGE;
    unsigned char* e_s = a_s + S::A_BYTES;
    const int k0 = chunk * KC;
    for (int i = tid; i < PLANES * TQ * SEGS; i += THREADS) {
      const int r = i / SEGS, seg = i % SEGS;
      const int q = q0 + (r % TQ), k = k0 + seg * 16;
      const unsigned char* base = r < TQ ? q0p : q1p;
      const bool ok = q < q_end && k < row_bytes;
      cp_async16(a_s + r * ROW + seg * 16,
                 ok ? base + (size_t)q * row_bytes + k : base, ok);
    }
    for (int i = tid; i < TILE_N * SEGS; i += THREADS) {
      const int r = i / SEGS, seg = i % SEGS;
      const int n = n0 + r, k = k0 + seg * 16;
      const bool ok = n < n_rows && k < row_bytes;
      cp_async16(e_s + r * ROW + seg * 16,
                 ok ? emb + (size_t)n * row_bytes + k : emb, ok);
    }
  };

  const int n_chunks = (row_bytes + KC - 1) / KC;
  load_stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_stage(c + 1, (c + 1) & 1);
    cp_async_commit();  // an empty group on the last chunk keeps counts even
    cp_async_wait_1();
    __syncthreads();
    const unsigned char* a_s = smem + (c & 1) * S::STAGE;
    const unsigned char* e_s = a_s + S::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 32) {  // 32 bytes = one k16 step
      unsigned a[PLANES][4];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const unsigned char* ar =
            a_s + (p * TQ + wm * 16 + gid) * ROW + kk + tig * 4;
        a[p][0] = *reinterpret_cast<const unsigned*>(ar);
        a[p][1] = *reinterpret_cast<const unsigned*>(ar + 8 * ROW);
        a[p][2] = *reinterpret_cast<const unsigned*>(ar + 16);
        a[p][3] = *reinterpret_cast<const unsigned*>(ar + 8 * ROW + 16);
      }
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const unsigned char* br =
            e_s + (wn * WN + j * 8 + gid) * ROW + kk + tig * 4;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(br);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(br + 16);
#pragma unroll
        for (int p = 0; p < PLANES; ++p) mma16<F16>(acc[p][j], a[p], b0, b1);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  // scores into shared memory (the stage buffers are free after the loop's
  // last barrier); fragment cell e of an m16n8 tile sits at row
  // gid + 8*(e/2), column 2*tig + e%2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ql_row = wm * 16 + gid + 8 * h;
    float row_scale = 1.f;
    if constexpr (F16) {
      if (q0 + ql_row < q_end) row_scale = inv_s[q0 + ql_row];
    }
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * WN + j * 8 + tig * 2 + e;
        float s;
        if constexpr (!F16) {
          s = __fadd_rn(acc[0][j][2 * h + e], acc[1][j][2 * h + e]);
        } else if constexpr (PLANES == 2) {
          // 2^-11 and inv_s are powers of two: both products are exact
          s = __fmul_rn(__fadd_rn(acc[0][j][2 * h + e],
                                  __fmul_rn(acc[1][j][2 * h + e], LO_WEIGHT)),
                        row_scale);
        } else {
          s = __fmul_rn(acc[0][j][2 * h + e], row_scale);
        }
        sc[ql_row * S::SROW + cl] = n0 + cl < n_valid ? s : NEG_INF;
      }
    }
  }
  __syncthreads();
}

// ----------------------------------------------------------------- f32 rows
constexpr int FK = 32;  // floats of d per stage

template <int TILE_N>
struct SmemF32 {
  static constexpr int EROW = TILE_N + 1;  // k-major slab row, conflict-free
  static constexpr int QROW = TQ + 1;
  static constexpr int STAGE = (FK * EROW + FK * QROW) * 4;
  static constexpr int SROW = TILE_N + 8;
  static constexpr int SCORES = TQ * SROW * 4;
  static constexpr int TOTAL = STAGE > SCORES ? STAGE : SCORES;
};

// One f32 score tile: q (b, d) f32 against emb (n_rows, d) f32, a plain
// SIMT FMA loop. Thread (warp w, lane l) owns queries 4w..4w+3 and columns
// l + 32j, j < TILE_N/32. Bounds, `smem` (SmemF32::TOTAL bytes), `sc` and
// the closing barrier as in mma_scores.
template <int TILE_N>
__device__ __forceinline__ void f32_scores(unsigned char* smem, float* sc,
                                           const float* __restrict__ q,
                                           const float* __restrict__ emb,
                                           int q_end, int d, int n_rows,
                                           int n_valid, int q0, int n0) {
  using S = SmemF32<TILE_N>;
  constexpr int CJ = TILE_N / 32;          // columns per thread
  constexpr int QI = TQ / (THREADS / 32);  // queries per thread (4)
  float* es = reinterpret_cast<float*>(smem);  // [FK][EROW]
  float* qs = es + FK * S::EROW;                // [FK][QROW]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float acc[QI][CJ];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += FK) {
    // coalesced along d: consecutive threads read consecutive floats of a row
    for (int i = tid; i < TILE_N * FK; i += THREADS) {
      const int kk = i % FK, c = i / FK;
      const int n = n0 + c, k = k0 + kk;
      es[kk * S::EROW + c] =
          n < n_rows && k < d ? emb[(size_t)n * d + k] : 0.f;
    }
    for (int i = tid; i < TQ * FK; i += THREADS) {
      const int kk = i % FK, r = i / FK;
      const int qq = q0 + r, k = k0 + kk;
      qs[kk * S::QROW + r] =
          qq < q_end && k < d ? q[(size_t)qq * d + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FK; ++kk) {
      float qv[QI], ev[CJ];
#pragma unroll
      for (int i = 0; i < QI; ++i) qv[i] = qs[kk * S::QROW + warp * QI + i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) ev[j] = es[kk * S::EROW + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(qv[i], ev[j], acc[i][j]);
    }
    __syncthreads();  // the next chunk overwrites the slab
  }

#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int cl = lane + 32 * j;
      sc[(warp * QI + i) * S::SROW + cl] =
          n0 + cl < n_valid ? acc[i][j] : NEG_INF;
    }
  __syncthreads();
}

}  // namespace dense
