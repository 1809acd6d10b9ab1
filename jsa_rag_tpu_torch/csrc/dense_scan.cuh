// The f32 dense scan's scoring core, shared by topt_dense.cu (the f32 rows
// of kernel B3, ending in the per-tile top-T emit) and mips_stream.cu (the
// f32 rows of kernel B9, the exact streaming top-k): one block scores a
// tile of TQ = 32 query rows against TILE_N index rows into a (TQ,
// TILE_N + 8) score tile in shared memory, on a plain SIMT FMA loop (a
// 4 x 8 register block of (query, column) cells a thread). The 16-bit rows
// score on wgmma_scan.cuh.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "topt_emit.cuh"

namespace dense {

using topt::NEG_INF;

constexpr int TQ = 32;        // queries per block
constexpr int THREADS = 256;  // 8 warps

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
// l + 32j, j < TILE_N/32. Query rows q0 .. q0 + TQ - 1 at or past q_end and
// index rows past n_rows are zero-filled; columns n0 + c at or past n_valid
// score NEG_INF. `smem` holds SmemF32::TOTAL bytes; `sc` (TQ x SROW floats)
// may alias it: it is written after the last chunk is consumed. Ends with a
// block barrier.
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
