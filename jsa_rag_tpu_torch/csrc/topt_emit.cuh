// Shared pieces of the port's scan-and-select kernels (topt_int8r2.cu,
// topt_dense.cu): cp.async staging helpers and the per-tile top-T emit.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 bytes read -> 16 bytes of zeros written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

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
