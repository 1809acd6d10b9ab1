// Dense (bf16 / fp16 / f32 storage) scans with per-tile top-T emit, for
// Hopper (sm_90a). One 16-bit template, three instances, and an f32 loop:
//
// - B3 replaces jsa_rag_tpu/ops/mips_pallas2.py::_topt_kernel_t (:176-200):
//   the scan behind every --index_dtype bfloat16|float32 flat index
//   (mips_topk_pallas2_t, :203-292, reached from ops/mips.py::mips_topk_t);
// - B4 replaces _topt_f16h_kernel_t (:446-465): the coarse pass of a float16
//   flat index searched with refine_r > 0 (mips_topk_pallas2_f16_t,
//   :500-613), whose top-(r*k) candidates the wrapper rescores in f32;
// - B5 replaces _topt_f16_kernel_t (:468-492): fp16-exact scores, the same
//   wrapper with refine_r = 0.
// The row-major search of mips_topk (ops/mips.py) reaches the same instances
// with the valid count set to the row count:
// - B6 replaces _topt_kernel (:73-88, mips_topk_pallas2, :91-160): B3's
//   function on row-major (N, d) rows, every row valid;
// - B7 replaces _topt_f16_kernel (:326-347, mips_topk_pallas2_f16,
//   :350-425): B5's function; the JAX kernel decodes int16 bits and runs
//   three bf16 passes (~16 bits of the query, subnormals flushed), B5 reads
//   native fp16 rows with two fp16 query planes (~22 bits, subnormals kept).
// All end in the epilogue _emit_topt (:32-49), shared in topt_emit.cuh; the
// scoring core (staging, mma.sync, the f32 FMA loop) lives in
// dense_scan.cuh, shared with the exact streaming top-k (mips_stream.cu).
//
// What each computes, for every query row q and every tile of TILE_N rows:
//   s[q, n] = sum_i q[q, i] * x[n, i]                    (f32 accumulate)
//   s[q, n] = NEG_INF for n >= n_valid (runtime valid count)
// then T extract-max passes per (q, tile) (topt_emit.cuh): the tile's top-T as
// (score, global id), ties to the lower column, id -1 once the tile is
// exhausted. Output layout (n_tiles, b, T), as in the JAX package.
//
// Precision. The reference multiplies the f32 query by the stored rows in f32.
// - bf16 rows (B3): a bf16 query would lose ~8 bits, so the wrapper splits it
//   into q_hi = bf16(q) and q_lo = bf16(q - q_hi) (the hi/lo split of
//   mips_pallas2.py::_split_hilo_bf16, :296-308, rounded rather than
//   truncated). Both planes are the 64 rows of the A operand; each B fragment
//   of the index feeds mma.sync.m16n8k16 bf16 -> f32 for both, and the two
//   sums are added in registers. A bf16 x bf16 product is exact in f32, so
//   what is left is the lo plane's rounding, <= 2^-18 |q_i| per term, i.e.
//   <= 2^-18 * sum_i |q_i x_i| ~ 4e-6 for unit rows, plus the f32 sums'
//   ordering.
// - fp16 rows: fp16 is a native tensor-core type on Hopper, so the rows are
//   read as stored (the JAX package's int16 bit storage and in-kernel decode
//   were Mosaic workarounds; it also flushed subnormal rows to zero, the
//   tensor cores take them). The wrapper scales each query row by a power of
//   two s with max|q*s| <= 1 (exact), then q_h = fp16(q*s) and
//   q_l = fp16((q*s - q_h) * 2^11). An fp16 x fp16 product is exact in f32.
//   B5 scores (acc_h + 2^-11 acc_l) / s: what is left is q_l's rounding,
//   <= 2^-22 |q_i| per term (plus 2^-36 / s absolute where q_l is
//   subnormal), i.e. <= 2^-22 * sum_i |q_i x_i| ~ 2.4e-7 for unit rows, plus
//   the f32 sums' ordering; tighter than the TPU's three bf16 passes
//   (~2^-16, their dropped q_l x_l term). B4 scores acc_h / s: the query at
//   fp16's 11 bits against exact rows (the TPU's coarse pass was bf16 on
//   both sides); only which candidates reach the f32 rescore depends on it.
// - f32 rows: a plain SIMT f32 FMA loop (no TF32, which keeps ~3 digits).
//
// Layout: rows are row-major (N, d), the on-disk layout, K-contiguous for
// mma.sync's "row.col" form (the TPU wanted (d, N) for its MXU).
//
// Bounds (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 and fp16 dense) at the
// full-width shape N = 1,300,480, d = 1024, 16-bit rows: the index is read
// once, 2.66 GB -> 0.80 ms; two products (B3, B5) are 4*B*N*d operations ->
// 2.8 ms at B = 512, one (B4) 2*B*N*d -> 1.4 ms. So the scans are bound by
// bytes below B ~ 150 (two planes) or ~ 300 (one plane), by operations above.
//
// Design, simple and right first (the 16-bit scan follows topt_int8r2.cu):
// - blocks run independently over (query tile of 32 rows, index tile of
//   TILE_N rows) on a one-dimensional grid, the query tile moving fastest so
//   the blocks that read one index tile run together and share it through
//   L2; query rows past b are zero-filled and never emitted (B = 8 runs in
//   one 32-row tile);
// - d streams through shared memory in 128-byte chunks, double-buffered with
//   cp.async (zero-filled past d and past the last row); rows are padded to
//   144 bytes so the 32-bit fragment loads are free of bank conflicts;
// - 8 warps (2 along queries x 4 along columns); the fragment byte offsets
//   of m16n8k16 bf16/f16 equal those of B1's m16n8k32 s8, so the staging and
//   the fragment loads are B1's; each B fragment feeds one mma per plane;
// - the f32 scan stages a (32-float chunk of d) x TILE_N slab k-major in
//   shared memory and gives each thread a 4 x 8 block of (query, column)
//   cells;
// - scores go to shared memory and the shared emit runs one warp per row.
// wgmma/TMA, a persistent schedule and ldmatrix fragment loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_scan.cuh"
#include "topt_emit.cuh"

namespace {

using dense::SmemF32;
using dense::THREADS;
using dense::TQ;

// One 16-bit scan, three instances (dense_scan.cuh::mma_scores):
//   B3 (F16 = false, PLANES = 2): bf16 rows, q_hi and q_lo bf16 planes;
//   B5 (F16 = true, PLANES = 2): fp16 rows, q_h and q_l fp16 planes;
//   B4 (F16 = true, PLANES = 1): fp16 rows, q_h only.
// q0, q1: (b, d) 16-bit planes (q1 unused with one plane); inv_s: (b,) f32
// powers of two (fp16 only); emb: (n_rows, d) 16-bit rows.
template <bool F16, int PLANES, int TILE_N>
__global__ void __launch_bounds__(THREADS, 2)
topt_mma_kernel(const unsigned char* __restrict__ q0p,
                const unsigned char* __restrict__ q1p,
                const float* __restrict__ inv_s,
                const unsigned char* __restrict__ emb, int b, int d,
                int n_rows, int n_valid, int t_per_tile, int q_tiles,
                float* __restrict__ out_s, int* __restrict__ out_i) {
  using S = dense::Smem<TILE_N, PLANES>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int nt = blockIdx.x / q_tiles;
  const int n0 = nt * TILE_N;
  float* sc = reinterpret_cast<float*>(smem);
  dense::mma_scores<F16, PLANES, TILE_N>(smem, sc, q0p, q1p, inv_s, emb, b,
                                         d, n_rows, n_valid, q0, n0);
  topt::emit_topt<TILE_N, TQ, THREADS>(sc, S::SROW, q0, b, n0, nt,
                                        t_per_tile, out_s, out_i);
}

// q: (b, d) f32; emb: (n_rows, d) f32 (dense_scan.cuh::f32_scores).
template <int TILE_N>
__global__ void __launch_bounds__(THREADS)
topt_dense_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ emb, int b, int d,
                      int n_rows, int n_valid, int t_per_tile, int q_tiles,
                      float* __restrict__ out_s, int* __restrict__ out_i) {
  using S = SmemF32<TILE_N>;
  __shared__ __align__(16) unsigned char smem[S::TOTAL];
  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int nt = blockIdx.x / q_tiles;
  const int n0 = nt * TILE_N;
  float* sc = reinterpret_cast<float*>(smem);
  dense::f32_scores<TILE_N>(smem, sc, q, emb, b, d, n_rows, n_valid, q0, n0);
  topt::emit_topt<TILE_N, TQ, THREADS>(sc, S::SROW, q0, b, n0, nt,
                                        t_per_tile, out_s, out_i);
}

int grid_of(int b, int n_rows, int tile_n, int* q_tiles, dim3* grid) {
  *q_tiles = (b + TQ - 1) / TQ;
  const long long blocks =
      static_cast<long long>(*q_tiles) * ((n_rows + tile_n - 1) / tile_n);
  if (blocks < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(blocks));
  return 0;
}

template <bool F16, int PLANES, int TILE_N>
int launch_mma(const unsigned char* q0, const unsigned char* q1,
               const float* inv_s, const unsigned char* emb, int b, int d,
               int n_rows, int n_valid, int t_per_tile, float* out_s,
               int* out_i, cudaStream_t stream) {
  constexpr int smem = dense::Smem<TILE_N, PLANES>::TOTAL;
  // once per process and instance (a thread-safe static): the port drives
  // one card
  static const cudaError_t attr = cudaFuncSetAttribute(
      topt_mma_kernel<F16, PLANES, TILE_N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int q_tiles;
  dim3 grid;
  if (int rc = grid_of(b, n_rows, TILE_N, &q_tiles, &grid)) return rc;
  topt_mma_kernel<F16, PLANES, TILE_N><<<grid, THREADS, smem, stream>>>(
      q0, q1, inv_s, emb, b, d, n_rows, n_valid, t_per_tile, q_tiles, out_s,
      out_i);
  return static_cast<int>(cudaGetLastError());
}

template <bool F16, int PLANES>
int launch_mma_tile(const void* q0, const void* q1, const void* inv_s,
                    const void* emb, int b, int d, int n_rows, int n_valid,
                    int tile_n, int t_per_tile, void* out_s, void* out_i,
                    void* stream) {
  const auto* a = static_cast<const unsigned char*>(q0);
  const auto* l = static_cast<const unsigned char*>(q1);
  const auto* sc = static_cast<const float*>(inv_s);
  const auto* e = static_cast<const unsigned char*>(emb);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile_n == 256)
    return launch_mma<F16, PLANES, 256>(a, l, sc, e, b, d, n_rows, n_valid,
                                        t_per_tile, os, oi, st);
  if (tile_n == 128)
    return launch_mma<F16, PLANES, 128>(a, l, sc, e, b, d, n_rows, n_valid,
                                        t_per_tile, os, oi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int TILE_N>
int launch_f32(const float* q, const float* emb, int b, int d, int n_rows,
               int n_valid, int t_per_tile, float* out_s, int* out_i,
               cudaStream_t stream) {
  int q_tiles;
  dim3 grid;
  if (int rc = grid_of(b, n_rows, TILE_N, &q_tiles, &grid)) return rc;
  topt_dense_f32_kernel<TILE_N><<<grid, THREADS, 0, stream>>>(
      q, emb, b, d, n_rows, n_valid, t_per_tile, q_tiles, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Shapes: qh, ql (b, d) bf16 or fp16 planes;
// q (b, d) f32; inv_s (b,) f32; emb (n_rows, d) bf16 / fp16 / f32; out_s,
// out_i (ceil(n_rows / tile_n), b, t_per_tile). All contiguous, 16-byte
// aligned, d % 16 == 0, tile_n in {128, 256}, 1 <= t_per_tile <= tile_n (the
// Python wrapper checks). Each returns a cudaError_t, 0 on a clean launch.
extern "C" int topt_dense_bf16_launch(const void* qh, const void* ql,
                                      const void* emb, int b, int d,
                                      int n_rows, int n_valid, int tile_n,
                                      int t_per_tile, void* out_s,
                                      void* out_i, void* stream) {
  return launch_mma_tile<false, 2>(qh, ql, nullptr, emb, b, d, n_rows,
                                   n_valid, tile_n, t_per_tile, out_s, out_i,
                                   stream);
}

// B4: the coarse fp16 scan, one query plane
extern "C" int topt_f16h_launch(const void* qh, const void* inv_s,
                                const void* emb, int b, int d, int n_rows,
                                int n_valid, int tile_n, int t_per_tile,
                                void* out_s, void* out_i, void* stream) {
  return launch_mma_tile<true, 1>(qh, nullptr, inv_s, emb, b, d, n_rows,
                                  n_valid, tile_n, t_per_tile, out_s, out_i,
                                  stream);
}

// B5: fp16-exact scores, two query planes
extern "C" int topt_f16_launch(const void* qh, const void* ql,
                               const void* inv_s, const void* emb, int b,
                               int d, int n_rows, int n_valid, int tile_n,
                               int t_per_tile, void* out_s, void* out_i,
                               void* stream) {
  return launch_mma_tile<true, 2>(qh, ql, inv_s, emb, b, d, n_rows, n_valid,
                                  tile_n, t_per_tile, out_s, out_i, stream);
}

extern "C" int topt_dense_f32_launch(const void* q, const void* emb, int b,
                                     int d, int n_rows, int n_valid,
                                     int tile_n, int t_per_tile, void* out_s,
                                     void* out_i, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* e = static_cast<const float*>(emb);
  auto* os = static_cast<float*>(out_s);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile_n == 256)
    return launch_f32<256>(qf, e, b, d, n_rows, n_valid, t_per_tile, os, oi,
                           st);
  if (tile_n == 128)
    return launch_f32<128>(qf, e, b, d, n_rows, n_valid, t_per_tile, os, oi,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
