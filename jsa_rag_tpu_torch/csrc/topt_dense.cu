// Dense (bf16 / fp16 / f32 storage) scans with per-tile top-T emit, for
// Hopper (sm_90a). One 16-bit template, four instances, and an f32 loop:
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
// All emit as _emit_topt (:32-49) does; the 16-bit scoring core (TMA ring,
// wgmma, persistent blocks) lives in wgmma_scan.cuh, shared with the exact
// streaming top-k (mips_stream.cu); the f32 FMA loop in dense_scan.cuh.
//
// What each computes, for every query row q and every tile of tile_n rows:
//   s[q, n] = sum_i q[q, i] * x[n, i]                    (f32 accumulate)
//   s[q, n] = NEG_INF for n >= n_valid (runtime valid count)
// then the tile's top-T as (score, global id), ties to the lower column, id
// -1 once the tile is exhausted. Output layout (n_tiles, b, T), as in the
// JAX package.
//
// Precision. The reference multiplies the f32 query by the stored rows in f32.
// - bf16 rows (B3, B6): a bf16 query (the benches' and the dispatcher's) is
//   one plane and scores exactly bf16 x bf16. An f32 query would lose ~8
//   bits as bf16, so the wrapper splits it into q_hi = bf16(q) and q_lo =
//   bf16(q - q_hi) (mips_pallas2.py::_split_hilo_bf16, :296-308, rounded
//   rather than truncated), and both products accumulate into one f32 sum
//   (each product is exact; only the order of the f32 additions moves).
//   What is left is the lo plane's rounding, <= 2^-18 |q_i| per term, i.e.
//   <= 2^-18 * sum_i |q_i x_i| ~ 4e-6 for unit rows, plus the f32 sums'
//   ordering (~d * 2^-24 * sum_i |q_i x_i|, ~6e-5 at d = 1024 in the worst
//   case, ~2e-6 in practice): within the 1e-4 * |q| * |x| the tests hold.
// - fp16 rows: fp16 is a native tensor-core type on Hopper, so the rows are
//   read as stored (the JAX package's int16 bit storage and in-kernel decode
//   were Mosaic workarounds; it also flushed subnormal rows to zero, the
//   tensor cores take them). The wrapper scales each query row by a power of
//   two s with max|q*s| <= 1 (exact), then q_h = fp16(q*s) and
//   q_l = fp16((q*s - q_h) * 2^11). An fp16 x fp16 product is exact in f32.
//   B5 scores (acc_h + 2^-11 acc_l) / s in two accumulators: what is left is
//   q_l's rounding, <= 2^-22 |q_i| per term (plus 2^-36 / s absolute where
//   q_l is subnormal), i.e. <= 2^-22 * sum_i |q_i x_i| ~ 2.4e-7 for unit
//   rows, plus the f32 sums' ordering; tighter than the TPU's three bf16
//   passes (~2^-16). B4 scores acc_h / s: the query at fp16's 11 bits
//   against exact rows; only which candidates reach the f32 rescore
//   depends on it.
// - f32 rows: a plain SIMT f32 FMA loop (no TF32, which keeps ~3 digits).
//
// Bounds (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 and fp16 dense) at the
// full-width shape N = 1,300,480, d = 1024, 16-bit rows: the index is read
// once, 2.66 GB -> 0.80 ms; two products (an f32 query: B3, B5) are
// 4*B*N*d operations -> 2.8 ms at B = 512, one (B4, or B3/B6 on a bf16
// query) 2*B*N*d -> 1.4 ms. So the scans are bound by bytes below B ~ 150
// (two planes) or ~ 300 (one plane), by operations above.
//
// Design (wgmma_scan.cuh): persistent blocks, one an SM, each walking units
// of (128 queries, 256 index rows) (64 queries for B5's two accumulators)
// with the query tile moving fastest, so the blocks that read one index
// tile run together and share it through L2, and at B = 512 the index
// leaves device memory about once and L2 four times (eight for B5), where
// the 32-query blocks of the mma.sync design read it through L2 sixteen
// times; a producer warp keeps a TMA ring of 3-8 stages full across units
// (a batch within one tile loads only its own query rows, so more stages
// fit), two consumer warpgroups run wgmma m64n256k16 (n128 for B5: each
// warpgroup takes both planes of half the columns) with the queries as A
// and the index tile as B; the emit runs on the scores in registers while
// the producer loads the next unit. A 128-row emit tile (N <= 128) emits
// the two halves of a 256-row unit as two tiles.
//
// The f32 scan stages a (32-float chunk of d) x TILE_N slab k-major in
// shared memory and gives each thread a 4 x 8 block of (query, column)
// cells; scores go to shared memory and the shared emit runs one warp per
// row (topt_emit.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_scan.cuh"
#include "topt_emit.cuh"
#include "wgmma_scan.cuh"

namespace {

using dense::SmemF32;
using dense::THREADS;
using dense::TQ;
using topt::NEG_INF;

// Masks columns at or past n_valid and emits the unit's 256 columns as one
// emit tile, or as two of 128 (v: the scores at 4j + 2h + e,
// wgmma_scan.cuh::emit_quads).
__device__ __forceinline__ void emit_unit(float (&v)[128], int tile_n,
                                          int n_tiles_out, int n_valid,
                                          int q_row, int b, int n0,
                                          long long nt, int t_per_tile,
                                          float* __restrict__ out_s,
                                          int* __restrict__ out_i) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int j = i >> 2, e = i & 1;
    if (n0 + 8 * j + 2 * tig + e >= n_valid) v[i] = NEG_INF;
  }
  const int halves = wgs::TILE / tile_n;
  for (int hf = 0; hf < halves; ++hf) {
    const long long nt_out = nt * halves + hf;
    if (nt_out >= n_tiles_out) break;
    wgs::emit_quads(v, hf * 32 / halves, (hf + 1) * 32 / halves, q_row, b,
                    n0, nt_out, t_per_tile, out_s, out_i);
  }
}

// One 16-bit scan, four instances (wgmma_scan.cuh):
//   B3/B6 (F16 = false, PLANES = 1 or 2): bf16 rows, a bf16 query or the
//     hi/lo split of an f32 one, one accumulator;
//   B5/B7 (F16 = true, PLANES = 2): fp16 rows, q_h and q_l fp16 planes;
//   B4 (F16 = true, PLANES = 1): fp16 rows, q_h only.
// mq0, mq1: TMA maps of the (b, d) 16-bit query planes (mq1 unused with one
// plane); me: of the (n_rows, d) 16-bit rows; inv_s: (b,) f32 powers of two
// (fp16 only). Out (n_tiles_out, b, t_per_tile) at emit tile tile_n.
template <bool F16, int PLANES>
__global__ void __launch_bounds__(wgs::THREADS, 1)
topt_wgmma_kernel(const __grid_constant__ CUtensorMap mq0,
                  const __grid_constant__ CUtensorMap mq1,
                  const __grid_constant__ CUtensorMap me,
                  const float* __restrict__ inv_s, int b, int d, int n_valid,
                  int tile_n, int n_tiles_out, int t_per_tile, int q_tiles,
                  int qbox, long long units, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
  using C = wgs::Cfg<F16, PLANES>;
  extern __shared__ unsigned char smem_raw[];
  const wgs::Ring ring = wgs::carve<PLANES>(smem_raw, C::RING, qbox);
  float* xbuf = reinterpret_cast<float*>(ring.stages + C::RING);
  wgs::init_ring(ring);
  __syncthreads();
  const int n_k = (d + wgs::KC - 1) / wgs::KC;
  const wgs::Units w{blockIdx.x, units, gridDim.x, q_tiles};
  if (threadIdx.x >= wgs::CONSUMERS) {
    if (threadIdx.x == wgs::CONSUMERS)
      wgs::produce<C>(ring, wgs::PlaneLoads<C, PLANES>{&mq0, &mq1, &me, qbox},
                      n_k, w);
    return;
  }
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int gid = (tw & 31) >> 2;
  int s = 0;
  uint32_t ph = 0;
  float acc[C::ACCS][C::NW / 2];
  for (long long u = w.u0; u < w.u1; u += w.step) {
    const int q0 = static_cast<int>(u % q_tiles) * C::QROWS;
    const long long nt = u / q_tiles;
    const int n0 = static_cast<int>(nt) * wgs::TILE;
    const int qw = q0 + (C::ACCS == 1 ? 64 * wg : 0);
    const bool active = qw < b;
    wgs::mma_unit<F16, PLANES, C>(acc, ring, s, ph, n_k, wg, active);
    if (!active) continue;
    const int q_row = qw + 16 * (tw >> 5) + gid;  // the h = 0 row
    float sc[2] = {1.f, 1.f};
    if constexpr (F16) {
      if (q_row < b) sc[0] = inv_s[q_row];
      if (q_row + 8 < b) sc[1] = inv_s[q_row + 8];
    }
    if constexpr (C::ACCS == 2) {
      // 2^-11 and inv_s are powers of two: both products are exact
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[0][i] = __fmul_rn(
            __fadd_rn(acc[0][i], __fmul_rn(acc[1][i], wgs::LO_WEIGHT)),
            sc[(i >> 1) & 1]);
      // warpgroup 1's columns 128..255 go to warpgroup 0's thread of the
      // same rows; warpgroup 1 goes on to the next unit
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) xbuf[i * 128 + tw] = acc[0][i];
      }
      wgs::named_sync(1, wgs::CONSUMERS);
      if (wg == 1) {
        wgs::named_sync(2, wgs::CONSUMERS);
        continue;
      }
      float v[128];
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        v[i] = acc[0][i];
        v[64 + i] = xbuf[i * 128 + tw];
      }
      wgs::named_sync(2, wgs::CONSUMERS);
      emit_unit(v, tile_n, n_tiles_out, n_valid, q_row, b, n0, nt,
                t_per_tile, out_s, out_i);
    } else {
      if constexpr (F16) {
#pragma unroll
        for (int i = 0; i < 128; ++i)
          acc[0][i] = __fmul_rn(acc[0][i], sc[(i >> 1) & 1]);
      }
      emit_unit(acc[0], tile_n, n_tiles_out, n_valid, q_row, b, n0, nt,
                t_per_tile, out_s, out_i);
    }
  }
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

template <bool F16, int PLANES>
int launch_wgmma(const void* q0, const void* q1, const void* inv_s,
                 const void* emb, int b, int d, int n_rows, int n_valid,
                 int tile_n, int t_per_tile, void* out_s, void* out_i,
                 void* stream) {
  using C = wgs::Cfg<F16, PLANES>;
  if (tile_n != 128 && tile_n != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  // once per process and instance (a thread-safe static): the port drives
  // one card
  static const cudaError_t attr = cudaFuncSetAttribute(
      topt_wgmma_kernel<F16, PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int qbox = wgs::query_box(b, C::QROWS);
  CUtensorMap mq0, mq1, me;
  if (int rc = wgs::make_map(&mq0, q0, F16, d, b, qbox)) return rc;
  if (int rc = wgs::make_map(&mq1, PLANES == 2 ? q1 : q0, F16, d, b, qbox))
    return rc;
  if (int rc = wgs::make_map(&me, emb, F16, d, n_rows, wgs::TILE)) return rc;
  int sms;
  if (int rc = wgs::sm_count(&sms)) return rc;
  const int q_tiles = (b + C::QROWS - 1) / C::QROWS;
  const long long units =
      static_cast<long long>(q_tiles) * ((n_rows + wgs::TILE - 1) / wgs::TILE);
  const int grid = static_cast<int>(units < sms ? units : sms);
  const int n_tiles_out = (n_rows + tile_n - 1) / tile_n;
  topt_wgmma_kernel<F16, PLANES>
      <<<grid, wgs::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
          mq0, mq1, me, static_cast<const float*>(inv_s), b, d, n_valid,
          tile_n, n_tiles_out, t_per_tile, q_tiles, qbox, units,
          static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
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
// Python wrapper checks). Each returns a cudaError_t (or 10000 + a refused
// TMA encode's CUresult), 0 on a clean launch.
//
// B3/B6: a null ql scores the one bf16 plane qh (a bf16 query).
extern "C" int topt_dense_bf16_launch(const void* qh, const void* ql,
                                      const void* emb, int b, int d,
                                      int n_rows, int n_valid, int tile_n,
                                      int t_per_tile, void* out_s,
                                      void* out_i, void* stream) {
  if (ql == nullptr)
    return launch_wgmma<false, 1>(qh, nullptr, nullptr, emb, b, d, n_rows,
                                  n_valid, tile_n, t_per_tile, out_s, out_i,
                                  stream);
  return launch_wgmma<false, 2>(qh, ql, nullptr, emb, b, d, n_rows, n_valid,
                                tile_n, t_per_tile, out_s, out_i, stream);
}

// B4: the coarse fp16 scan, one query plane
extern "C" int topt_f16h_launch(const void* qh, const void* inv_s,
                                const void* emb, int b, int d, int n_rows,
                                int n_valid, int tile_n, int t_per_tile,
                                void* out_s, void* out_i, void* stream) {
  return launch_wgmma<true, 1>(qh, nullptr, inv_s, emb, b, d, n_rows,
                               n_valid, tile_n, t_per_tile, out_s, out_i,
                               stream);
}

// B5: fp16-exact scores, two query planes
extern "C" int topt_f16_launch(const void* qh, const void* ql,
                               const void* inv_s, const void* emb, int b,
                               int d, int n_rows, int n_valid, int tile_n,
                               int t_per_tile, void* out_s, void* out_i,
                               void* stream) {
  return launch_wgmma<true, 2>(qh, ql, inv_s, emb, b, d, n_rows, n_valid,
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
