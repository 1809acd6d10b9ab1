// int8 coarse scans with per-tile top-T emit, for Hopper (sm_90a): one
// kernel template over the number of query planes P.
//
// P = 2 (kernel B1) replaces jsa_rag_tpu/ops/mips_pallas2.py::
// _topt_int8r2_kernel_t (:724-747): the scan behind the int8r flat index's
// default "rows" refine. P = 1 (kernel B2) replaces _topt_int8_kernel_t
// (:769-786): the single-plane scan behind int8 storage, the int8r "rows1"
// and "cols" refines and the hybrid index's coarse pass. Both end in the
// epilogue _emit_topt (:32-49) and run behind mips_topk_pallas2_int8_t
// (:794-945).
//
// What it computes, for every query row q and every tile of TILE_N index rows:
//   acc_p[q, n] = sum_k qv_p[q, k] * emb[n, k]             (int8 x int8 -> int32)
//   P = 2: s[q, n] = (f32(acc_1) * qs1[q] + f32(acc_2) * qs2[q]) * es[n]
//   P = 1: s[q, n] = (f32(acc_1) * qs1[q]) * es[n]
//   s[q, n]     = NEG_INF for n >= n_valid (runtime valid count)
// then T extract-max passes per (q, tile): the tile's top-T as (score, global
// id), ties to the lower column like jnp.argmax, id -1 once the tile has no
// scorable column left. Output layout (n_tiles, b, T), as in the JAX package.
// The f32 combination is written with __fmul_rn/__fadd_rn so no FMA
// contraction changes the rounding: the scores equal the plain PyTorch
// versions' (ops/mips_topt.py::scan_topt_int8r2_plain, scan_topt_int8_plain)
// bit for bit.
//
// Layout. The index plane is row-major (N, d), not the JAX package's (d, N):
// the TPU wanted the contraction dim leading for its MXU, while mma.sync's
// s8 "row.col" form wants both operands K-contiguous, which (N, d) rows are.
// It is also the on-disk layout, so load is a plain copy.
//
// Bound (H100 SXM, 3.35 TB/s, 1,979 TOPS int8 dense) at the main path's
// flagship shape N = 1.3M, d = 1024: plane 1 is read once, 1.33 GB ->
// 0.40 ms; the P int8 products are 2*P*B*N*d ops -> 1.38 ms (P = 2) or
// 0.69 ms (P = 1) at B = 512. So the scan is bound by operations above
// B ~ 150 (P = 2) or ~ 300 (P = 1) and by bytes below it.
//
// Design, simple and right first:
// - blocks run independently over (query tile of 32 rows, index tile of
//   TILE_N rows) on a one-dimensional grid (2^31 - 1 blocks, so no cap on
//   the index short of int32 row ids); the query tile is the fastest-moving
//   part of the block index, so the blocks that read one index tile run
//   together and share it through L2 — device memory sees the plane about
//   once;
// - the P query planes are stacked as the 32*P rows of the A operand, so one
//   B fragment of the index feeds every product (one read, P dots, like the
//   TPU kernel);
// - d streams through shared memory in 128-byte chunks, double-buffered with
//   cp.async (zero-filled past d and past the last row); rows are padded to
//   144 bytes so the 32-bit fragment loads are free of bank conflicts;
// - 8 warps (2 along queries x 4 along columns) run
//   mma.sync.m16n8k32.s8.s8.s32; each thread holds every plane's sums for
//   the same (query, column) cells and combines them in registers;
// - scores go to shared memory (reusing the stage buffers), then one warp per
//   query row keeps TILE_N/32 scores per lane in registers and runs the T
//   passes with a shuffle argmax (topt_emit.cuh, shared with topt_dense.cu).
// wgmma/TMA, a persistent schedule and ldmatrix fragment loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "topt_emit.cuh"

namespace {

using topt::cp_async16;
using topt::cp_async_commit;
using topt::cp_async_wait_1;
using topt::NEG_INF;

constexpr int TQ = 32;        // queries per block (P planes -> 32*P A rows)
constexpr int KC = 128;       // bytes of d per pipeline stage
constexpr int ROW = KC + 16;  // padded shared-memory row stride in bytes
constexpr int THREADS = 256;  // 8 warps: 2 along queries x 4 along columns

template <int TILE_N, int P>
struct Smem {
  static constexpr int A_BYTES = P * TQ * ROW;
  static constexpr int E_BYTES = TILE_N * ROW;
  static constexpr int STAGE = A_BYTES + E_BYTES;
  static constexpr int SROW = TILE_N + 8;  // score row stride in floats
  static constexpr int SCORES = TQ * SROW * 4;
  static constexpr int TOTAL = (2 * STAGE > SCORES) ? 2 * STAGE : SCORES;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int TILE_N, int P>
__global__ void __launch_bounds__(THREADS, 2)
topt_int8_kernel(const int8_t* __restrict__ qv1,
                   const float* __restrict__ qs1,
                   const int8_t* __restrict__ qv2,
                   const float* __restrict__ qs2,
                   const int8_t* __restrict__ emb,
                   const float* __restrict__ es, int b, int d, int n_rows,
                   int n_valid, int t_per_tile, int q_tiles,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  static_assert(P == 1 || P == 2, "one or two query planes");
  using S = Smem<TILE_N, P>;
  constexpr int WN = TILE_N / 4;  // columns per warp
  constexpr int NT8 = WN / 8;     // n8 mma tiles per warp
  constexpr int SEGS = KC / 16;   // 16-byte segments per staged row
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int nt = blockIdx.x / q_tiles;
  const int n0 = nt * TILE_N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1;   // which 16 queries of the tile
  const int wn = warp >> 1;  // which quarter of the columns
  const int gid = lane >> 2, tig = lane & 3;

  int acc[P][NT8][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0;

  auto load_stage = [&](int chunk, int stage) {
    unsigned char* a_s = smem + stage * S::STAGE;
    unsigned char* e_s = a_s + S::A_BYTES;
    const int k0 = chunk * KC;
    for (int i = tid; i < P * TQ * SEGS; i += THREADS) {
      const int r = i / SEGS, seg = i % SEGS;
      const int q = q0 + (r % TQ), k = k0 + seg * 16;
      const int8_t* base = r < TQ ? qv1 : qv2;
      const bool ok = q < b && k < d;
      cp_async16(a_s + r * ROW + seg * 16,
                 ok ? base + (size_t)q * d + k : base, ok);
    }
    for (int i = tid; i < TILE_N * SEGS; i += THREADS) {
      const int r = i / SEGS, seg = i % SEGS;
      const int n = n0 + r, k = k0 + seg * 16;
      const bool ok = n < n_rows && k < d;
      cp_async16(e_s + r * ROW + seg * 16,
                 ok ? emb + (size_t)n * d + k : emb, ok);
    }
  };

  const int n_chunks = (d + KC - 1) / KC;
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
    for (int kk = 0; kk < KC; kk += 32) {
      unsigned a[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
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
        for (int p = 0; p < P; ++p) mma_s8(acc[p][j], a[p], b0, b1);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  // scores into shared memory (the stage buffers are free after the loop's
  // last barrier); fragment cell e of an m16n8 tile sits at row
  // gid + 8*(e/2), column 2*tig + e%2
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ql = wm * 16 + gid + 8 * h;
    const int q = q0 + ql;
    const float s1 = q < b ? qs1[q] : 0.f;
    const float s2 = (P == 2 && q < b) ? qs2[q] : 0.f;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * WN + j * 8 + tig * 2 + e;
        const int col = n0 + cl;
        float s = NEG_INF;
        if (col < n_valid) {
          float a1 = __fmul_rn(__int2float_rn(acc[0][j][2 * h + e]), s1);
          if constexpr (P == 2)
            a1 = __fadd_rn(
                a1, __fmul_rn(__int2float_rn(acc[P - 1][j][2 * h + e]), s2));
          s = __fmul_rn(a1, es[col]);
        }
        sc[ql * S::SROW + cl] = s;
      }
    }
  }
  __syncthreads();

  // per-row top-T (the shared emit, topt_emit.cuh)
  topt::emit_topt<TILE_N, TQ, THREADS>(sc, S::SROW, q0, b, n0, nt,
                                        t_per_tile, out_s, out_i);
}

template <int TILE_N, int P>
int launch(const int8_t* qv1, const float* qs1, const int8_t* qv2,
           const float* qs2, const int8_t* emb, const float* es, int b, int d,
           int n_rows, int n_valid, int t_per_tile, float* out_s, int* out_i,
           cudaStream_t stream) {
  constexpr int smem = Smem<TILE_N, P>::TOTAL;
  // once per process and instance (a thread-safe static): the port drives
  // one card
  static const cudaError_t attr = cudaFuncSetAttribute(
      topt_int8_kernel<TILE_N, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int q_tiles = (b + TQ - 1) / TQ;
  const long long blocks =
      static_cast<long long>(q_tiles) * ((n_rows + TILE_N - 1) / TILE_N);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  topt_int8_kernel<TILE_N, P><<<grid, THREADS, smem, stream>>>(
      qv1, qs1, qv2, qs2, emb, es, b, d, n_rows, n_valid, t_per_tile, q_tiles,
      out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Shapes: qv1, qv2 (b, d) int8; qs1, qs2 (b,) f32;
// emb (n_rows, d) int8; es (n_rows,) f32; out_s, out_i
// (ceil(n_rows / tile_n), b, t_per_tile). All contiguous, 16-byte aligned,
// d % 16 == 0, tile_n in {128, 256}, 1 <= t_per_tile <= tile_n (the Python
// wrapper checks). Returns a cudaError_t, 0 on a clean launch.
extern "C" int topt_int8r2_launch(const void* qv1, const void* qs1,
                                  const void* qv2, const void* qs2,
                                  const void* emb, const void* es, int b,
                                  int d, int n_rows, int n_valid, int tile_n,
                                  int t_per_tile, void* out_s, void* out_i,
                                  void* stream) {
  const auto* a1 = static_cast<const int8_t*>(qv1);
  const auto* a2 = static_cast<const int8_t*>(qv2);
  const auto* s1 = static_cast<const float*>(qs1);
  const auto* s2 = static_cast<const float*>(qs2);
  const auto* e = static_cast<const int8_t*>(emb);
  const auto* se = static_cast<const float*>(es);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile_n == 256)
    return launch<256, 2>(a1, s1, a2, s2, e, se, b, d, n_rows, n_valid,
                          t_per_tile, os, oi, st);
  if (tile_n == 128)
    return launch<128, 2>(a1, s1, a2, s2, e, se, b, d, n_rows, n_valid,
                          t_per_tile, os, oi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry for ctypes, single-plane query (kernel B2). Shapes: qv (b, d)
// int8; qs (b,) f32; the rest as in topt_int8r2_launch.
extern "C" int topt_int8_launch(const void* qv, const void* qs,
                                const void* emb, const void* es, int b, int d,
                                int n_rows, int n_valid, int tile_n,
                                int t_per_tile, void* out_s, void* out_i,
                                void* stream) {
  const auto* a1 = static_cast<const int8_t*>(qv);
  const auto* s1 = static_cast<const float*>(qs);
  const auto* e = static_cast<const int8_t*>(emb);
  const auto* se = static_cast<const float*>(es);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile_n == 256)
    return launch<256, 1>(a1, s1, nullptr, nullptr, e, se, b, d, n_rows,
                          n_valid, t_per_tile, os, oi, st);
  if (tile_n == 128)
    return launch<128, 1>(a1, s1, nullptr, nullptr, e, se, b, d, n_rows,
                          n_valid, t_per_tile, os, oi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
