// Shared pieces of the port's scan-and-select kernels: NEG_INF, and the
// per-tile top-T emit from a score tile in shared memory, which the f32
// scans (dense_scan.cuh) end in; the wgmma scans emit from registers in the
// same order (wgmma_scan.cuh::emit_quads).
//
// The emit replaces jsa_rag_tpu/ops/mips_pallas2.py::_emit_topt (:32-49):
// T extract-max passes over one tile of scores per query row, each pass
// emitting (score, global id) with ties to the lower column like jnp.argmax,
// and id -1 once the tile has no scorable column left (the JAX regression:
// a placeholder that carried a real id let one passage fill many top-k
// slots after a refine).

#pragma once

#include <cuda_runtime.h>

namespace topt {

constexpr float NEG_INF = -3.40282347e+38f;  // float32 min, the JAX NEG_INF

// Per-row top-T of a (TQ, TILE_N) tile of scores in shared memory (row
// stride `srow` floats): one warp per query row, TILE_N/32 scores per lane
// in registers, T passes of a shuffle argmax on (score, column). Writes
// out_s/out_i[(nt * b + q) * t_per_tile + t] for the block's rows q < b.
template <int TILE_N, int TQ, int THREADS>
__device__ __forceinline__ void emit_topt(const float* sc, int srow, int q0,
                                          int b, int n0, int nt,
                                          int t_per_tile,
                                          float* __restrict__ out_s,
                                          int* __restrict__ out_i) {
  constexpr int V = TILE_N / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TQ; r += THREADS / 32) {
    const int q = q0 + r;
    if (q >= b) break;  // warp-uniform: rows ascend with r
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = sc[r * srow + j * 32 + lane];
    float* os = out_s + ((size_t)nt * b + q) * t_per_tile;
    int* oi = out_i + ((size_t)nt * b + q) * t_per_tile;
    for (int t = 0; t < t_per_tile; ++t) {
      // lane-local max; columns ascend with j, so ">" keeps the first
      float bv = v[0];
      int bc = lane;
#pragma unroll
      for (int j = 1; j < V; ++j) {
        if (v[j] > bv) {
          bv = v[j];
          bc = j * 32 + lane;
        }
      }
      // warp argmax, ties to the lower column (jnp.argmax's first hit)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (ov > bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
      if (lane == 0) {
        os[t] = bv;
        oi[t] = bv > NEG_INF * 0.5f ? n0 + bc : -1;
      }
      if ((bc & 31) == lane) {
        const int js = bc >> 5;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (j == js) v[j] = NEG_INF;
      }
    }
  }
}

}  // namespace topt
