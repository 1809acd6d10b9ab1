// int8 coarse scans with per-tile top-T emit, for Hopper (sm_90a), on the
// int8 instance of the wgmma scoring core (wgmma_scan.cuh, CfgS8): one
// kernel template over the query rows a thread holds.
//
// B1 (two query planes) replaces jsa_rag_tpu/ops/mips_pallas2.py::
// _topt_int8r2_kernel_t (:724-747): the scan behind the int8r flat index's
// default "rows" refine. B2 (one plane) replaces _topt_int8_kernel_t
// (:769-786): the single-plane scan behind int8 storage, the int8r "rows1"
// and "cols" refines and the hybrid index's coarse pass; B8
// (_topt_int8_kernel, :705-721, the row-major mips_topk_pallas2_int8) is
// B2's function with every row valid and launches B2's instance. All end in
// the epilogue _emit_topt (:32-49) and run behind mips_topk_pallas2_int8_t
// (:794-945).
//
// What it computes, for every query row q and every tile of tile_n index
// rows:
//   acc_p[q, n] = sum_k qv_p[q, k] * emb[n, k]             (int8 x int8 -> s32)
//   B1: s[q, n] = (f32(acc_1) * qs1[q] + f32(acc_2) * qs2[q]) * es[n]
//   B2: s[q, n] = (f32(acc_1) * qs1[q]) * es[n]
//   s[q, n]     = NEG_INF for n >= n_valid (runtime valid count)
// then T extract-max passes per (q, tile): the tile's top-T as (score, global
// id), ties to the lower column like jnp.argmax, id -1 once the tile has no
// scorable column left. Output layout (n_tiles, b, T), as in the JAX package.
// The s32 sums are exact in any order; the f32 combination is written with
// __fmul_rn/__fadd_rn in the plain versions' order, so no FMA contraction
// changes the rounding: the scores equal ops/mips_topt.py::
// scan_topt_int8r2_plain and scan_topt_int8_plain bit for bit.
//
// Layout. The index plane is row-major (N, d), not the JAX package's (d, N):
// wgmma's 8-bit forms take both operands K-major, which (N, d) rows are. It
// is also the on-disk layout, so load is a plain copy.
//
// Bound (H100 SXM, 3.35 TB/s, 1,979 TOPS int8 dense) at the main path's
// flagship shape N = 1.3M, d = 1024: plane 1 is read once, 1.33 GB ->
// 0.40 ms; the products are 2*P*B*N*d ops (P planes) -> 1.38 ms (B1) or
// 0.69 ms (B2) at B = 512. So the scan is bound by operations above
// B ~ 150 (B1) or ~ 300 (B2) and by bytes below it.
//
// Design (the 16-bit scans', at 8 bits): persistent blocks, one an SM,
// walking units of (128 A rows, 256 index rows) with the query tile
// moving fastest, so the blocks that read one index tile run together and
// share it through L2; a producer warp keeps a TMA ring full across units
// (stage rows of 128 bytes = 128 int8 values of d; 4 stages of 48 KB, or
// up to 6 when a batch within one tile loads only its own rows); two
// consumer warpgroups run wgmma m64n256k32 s8 into one s32 accumulator of
// 128 registers a thread, with the A rows as wgmma's A and the index tile
// as B; the scores are formed and the emit runs in registers on the thread
// quads (wgmma_scan.cuh::emit_quads) while the producer loads the next
// unit. A 128-row emit tile emits a unit's 256 columns as two tiles, a
// compile-time split (HALVES): a run-time column range in the emit's inner
// loop cost B1 a fifth of its time at B = 512 (PERF.md). Every warpgroup
// multiplies, also where its rows lie past b (those are never written): a
// wgmma under a branch makes ptxas serialise every wgmma of the kernel
// (warning C7518).
//
// The A rows. B2: the (b, d) query plane, 128 queries a unit; a thread's
// two accumulator rows are two queries (H = 2). B1: two s32 accumulators of
// n256 do not fit the registers, so the wrapper interleaves the planes into
// one A plane of 2 * round_up(b, 8) rows by 8-row groups
// (ops/mips_topt.py::interleave_planes): rows 16g..16g+7 hold plane 1 of
// queries 8g..8g+7 and rows 16g+8..16g+15 their plane 2. wgmma's fragment
// layout gives a thread rows r and r + 8 of its warp's 16, so its two
// accumulator rows are the two planes of ONE query (H = 1), at the same
// columns: the f32 combination stays in its registers, with no hand-over
// between warpgroups. A unit is then 64 queries (32 a warpgroup), so one
// index tile serves half as many queries as in B2, for twice the products.
// The interleaved copy (2 * b * d bytes, one stack when b % 8 == 0) keeps
// one TMA box a stage; loading each plane's 8-row groups as boxes of their
// own (16 a stage) cost more at B = 512 than the copy does at any B
// (PERF.md). The other layout (B5's: each warpgroup both planes of 128
// columns at n128) halves wgmma's N, and B5's timings showed a hand-over of
// sums between warpgroups through shared memory costing more than it saves.
//
// The row scales es: each thread needs those of its 64 columns. Read
// through L1/L2 in the epilogue, their latency sat on every unit's critical
// path (0.80 against 0.49 ms at B = 2; PERF.md), so the producer TMAs each
// unit's 1 KB of scales beside its stages, into one of 4 buffers with a
// full/empty barrier pair of their own, and the epilogue reads them from
// shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "wgmma_scan.cuh"

namespace {

using topt::NEG_INF;
using C = wgs::CfgS8;

// How a scan cuts its work: the A plane's rows (planes 1: the b query
// rows; 2: the interleaved 2 * round_up(b, 8)), the TMA box of query rows
// a stage takes, the query tiles of 128 A rows, the ring's stages, the
// units and the persistent grid on sms SMs.
struct Geometry {
  int a_rows, qbox, q_tiles, stages, grid;
  long long units;
};

int geometry(int b, int planes, int n_rows, int sms, Geometry* g) {
  if (b < 1 || n_rows < 1 || sms < 1 || (planes != 1 && planes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  g->a_rows = planes == 1 ? b : 2 * ((b + 7) / 8 * 8);
  g->qbox = wgs::query_box(g->a_rows, C::QROWS);
  g->q_tiles = (g->a_rows + C::QROWS - 1) / C::QROWS;
  g->stages = wgs::ring_depth(C::RING, wgs::stage_bytes(1, g->qbox));
  g->units = static_cast<long long>(g->q_tiles) *
             ((n_rows + wgs::TILE - 1) / wgs::TILE);
  g->grid = static_cast<int>(g->units < sms ? g->units : sms);
  return 0;
}

// The unit's scores from a thread's s32 sums (acc[i] at row r + 8*((i/2)%2)
// of its warp's 16 A rows, column 8*(i/4) + 2*(lane%4) + i%2), masked at
// n_valid, into v as emit_quads<64 * H> reads it. H = 2 (B2): rows q_row and
// q_row + 8; H = 1 (B1): the two planes of query q_row. es_u: the unit's
// 256 row scales in shared memory.
template <int H>
__device__ __forceinline__ void scores(const int (&acc)[128],
                                       float (&v)[64 * H], int q_row, int b,
                                       int n0, int n_valid,
                                       const float* __restrict__ qs1,
                                       const float* __restrict__ qs2,
                                       const float* es_u) {
  const int tig = threadIdx.x & 3;
  float s1[2], s2 = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q_row + 8 * h;
    s1[h] = (H == 2 || h == 0) && q < b ? qs1[q] : 0.f;
  }
  if constexpr (H == 1) s2 = q_row < b ? qs2[q_row] : 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 se2 =
        *reinterpret_cast<const float2*>(es_u + 8 * j + 2 * tig);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = n0 + 8 * j + 2 * tig + e < n_valid;
      const float se = e ? se2.y : se2.x;
      if constexpr (H == 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          v[i] = ok ? __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), s1[h]), se)
                    : NEG_INF;
        }
      } else {
        const float a = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + e]), s1[0]),
            __fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), s2));
        v[2 * j + e] = ok ? __fmul_rn(a, se) : NEG_INF;
      }
    }
  }
}

// What the int8 scans' stages hold, and the row scales beside them: one
// box of qbox A rows (B2: query rows; B1: interleaved plane rows) at the
// unit's first A row, then the index tile. Before a unit's stages, its 256
// row scales into side buffer i % SIDE, once the consumers have released
// that buffer's previous unit.
struct S8Loads {
  const CUtensorMap *mq, *me, *mes;
  int qbox;
  float* es_buf;
  uint64_t *es_full, *es_empty;
  __device__ uint32_t bytes() const { return qbox * wgs::ROW + C::B_BYTES; }
  __device__ void unit(long long i, int n0) const {
    const int k = static_cast<int>(i % C::SIDE);
    wgs::mbar_wait(&es_empty[k], static_cast<uint32_t>(i / C::SIDE & 1) ^ 1u);
    wgs::mbar_expect_tx(&es_full[k], wgs::TILE * 4);
    wgs::tma_load_1d(es_buf + k * wgs::TILE, mes, &es_full[k], n0);
  }
  __device__ void stage(unsigned char* st, int plane, uint64_t* bar, int kc,
                        int q0, int n0) const {
    wgs::tma_load(st, mq, bar, kc * C::KE, q0);
    wgs::tma_load(st + plane, me, bar, kc * C::KE, n0);
  }
};

// mq: the TMA map of the A plane (a_rows, d) int8 (B1: interleaved); me: of
// the (n_rows, d) int8 rows; mes: of the (n_rows,) f32 row scales; qs1, qs2
// (b,) f32 (qs2 B1 only). Out (n_tiles_out, b, t_per_tile) at emit tile
// 256 / HALVES.
template <int H, int HALVES>
__global__ void __launch_bounds__(wgs::THREADS, 1)
topt_int8_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap me,
                 const __grid_constant__ CUtensorMap mes,
                 const float* __restrict__ qs1, const float* __restrict__ qs2,
                 int b, int d, int n_valid, int n_tiles_out, int t_per_tile,
                 int q_tiles, int qbox, long long units,
                 float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int QPU = C::QROWS * H / 2;  // queries a unit
  extern __shared__ unsigned char smem_raw[];
  const wgs::Ring ring = wgs::carve<1>(smem_raw, C::RING, qbox);
  // the row scales of C::SIDE units, each with a full/empty barrier pair
  // after the ring's
  float* es_buf = reinterpret_cast<float*>(ring.stages + C::RING);
  uint64_t* es_full = ring.full + 2 * wgs::MAX_STAGES;
  uint64_t* es_empty = es_full + C::SIDE;
  if (threadIdx.x == 0) {
    for (int k = 0; k < C::SIDE; ++k) {
      wgs::mbar_init(&es_full[k], 1);
      wgs::mbar_init(&es_empty[k], wgs::CONSUMERS);
    }
  }
  wgs::init_ring(ring);
  __syncthreads();
  const int n_k = (d + C::KE - 1) / C::KE;
  const wgs::Units w{blockIdx.x, units, gridDim.x, q_tiles};
  if (threadIdx.x >= wgs::CONSUMERS) {
    if (threadIdx.x == wgs::CONSUMERS)
      wgs::produce<C>(
          ring, S8Loads{&mq, &me, &mes, qbox, es_buf, es_full, es_empty},
          n_k, w);
    return;
  }
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int gid = (tw & 31) >> 2;
  int s = 0;
  uint32_t ph = 0;
  int acc[1][128];
  long long i = 0;
  for (long long u = w.u0; u < w.u1; u += w.step, ++i) {
    const int qw = static_cast<int>(u % q_tiles) * QPU + wg * (QPU / 2);
    const long long nt = u / q_tiles;
    const int n0 = static_cast<int>(nt) * wgs::TILE;
    // every warpgroup multiplies, past b too (rows never written): a
    // wgmma under a branch makes ptxas serialise all of them (C7518)
    wgs::mma_unit<false, 1, C>(acc, ring, s, ph, n_k, wg, true);
    // H = 2: 16 queries a warp; H = 1: 8, each in two A rows
    const int q_warp = qw + 8 * H * (tw >> 5);
    // every consumer thread waits for the unit's scales and releases them,
    // so the buffer's phases advance in step
    const int k = static_cast<int>(i % C::SIDE);
    wgs::mbar_wait(&es_full[k], (i / C::SIDE) & 1);
    if (q_warp >= b) {  // the warp's rows all lie past b (warp-uniform)
      wgs::mbar_arrive(&es_empty[k]);
      continue;
    }
    const int q_row = q_warp + gid;  // the h = 0 row
    float v[64 * H];
    scores<H>(acc[0], v, q_row, b, n0, n_valid, qs1, qs2,
              es_buf + k * wgs::TILE);
    wgs::mbar_arrive(&es_empty[k]);
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      const long long nt_out = nt * HALVES + hf;
      if (nt_out >= n_tiles_out) break;
      wgs::emit_quads(v, hf * 32 / HALVES, (hf + 1) * 32 / HALVES, q_row, b,
                      n0, nt_out, t_per_tile, out_s, out_i);
    }
  }
}

template <int H, int HALVES>
int launch(const void* qv, const void* qs1, const void* qs2, const void* emb,
           const void* es, int b, int d, int n_rows, int n_valid,
           int t_per_tile, void* out_s, void* out_i, void* stream) {
  // once per process and instance (a thread-safe static): the port drives
  // one card
  static const cudaError_t attr = cudaFuncSetAttribute(
      topt_int8_kernel<H, HALVES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int sms;
  if (int rc = wgs::sm_count(&sms)) return rc;
  Geometry g;
  if (int rc = geometry(b, H == 2 ? 1 : 2, n_rows, sms, &g)) return rc;
  CUtensorMap mq, me, mes;
  if (int rc = wgs::make_map_s8(&mq, qv, d, g.a_rows, g.qbox)) return rc;
  if (int rc = wgs::make_map_s8(&me, emb, d, n_rows, wgs::TILE)) return rc;
  if (int rc = wgs::make_map_1d_f32(&mes, es, n_rows, wgs::TILE)) return rc;
  const int tile_n = wgs::TILE / HALVES;
  topt_int8_kernel<H, HALVES>
      <<<g.grid, wgs::THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
          mq, me, mes, static_cast<const float*>(qs1),
          static_cast<const float*>(qs2), b, d, n_valid,
          (n_rows + tile_n - 1) / tile_n, t_per_tile, g.q_tiles, g.qbox,
          g.units, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// the instance of an emit tile of tile_n rows
template <int H>
int launch_tile(int tile_n, const void* qv, const void* qs1, const void* qs2,
                const void* emb, const void* es, int b, int d, int n_rows,
                int n_valid, int t_per_tile, void* out_s, void* out_i,
                void* stream) {
  if (tile_n == 256)
    return launch<H, 1>(qv, qs1, qs2, emb, es, b, d, n_rows, n_valid,
                        t_per_tile, out_s, out_i, stream);
  if (tile_n == 128)
    return launch<H, 2>(qv, qs1, qs2, emb, es, b, d, n_rows, n_valid,
                        t_per_tile, out_s, out_i, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entries for ctypes. Shapes: emb (n_rows, d) int8; es (n_rows,)
// f32; out_s, out_i (ceil(n_rows / tile_n), b, t_per_tile). All contiguous,
// the int8 planes and es 16-byte aligned, d % 16 == 0, tile_n in {128, 256},
// 1 <= t_per_tile <= tile_n (the Python wrapper checks). Each returns a
// cudaError_t (or 10000 + a refused TMA encode's CUresult), 0 on a clean
// launch.
//
// B1: qv (2 * round_up(b, 8), d) int8, the two query planes interleaved by
// 8-row groups (ops/mips_topt.py::interleave_planes); qs1, qs2 (b,) f32.
extern "C" int topt_int8r2_launch(const void* qv, const void* qs1,
                                  const void* qs2, const void* emb,
                                  const void* es, int b, int d, int n_rows,
                                  int n_valid, int tile_n, int t_per_tile,
                                  void* out_s, void* out_i, void* stream) {
  return launch_tile<1>(tile_n, qv, qs1, qs2, emb, es, b, d, n_rows, n_valid,
                        t_per_tile, out_s, out_i, stream);
}

// B2 (and B8): qv (b, d) int8, one query plane; qs (b,) f32.
extern "C" int topt_int8_launch(const void* qv, const void* qs,
                                const void* emb, const void* es, int b, int d,
                                int n_rows, int n_valid, int tile_n,
                                int t_per_tile, void* out_s, void* out_i,
                                void* stream) {
  return launch_tile<2>(tile_n, qv, qs, nullptr, emb, es, b, d, n_rows,
                        n_valid, t_per_tile, out_s, out_i, stream);
}

// The geometry a launch of b queries with `planes` query planes over n_rows
// rows takes on sms SMs: out = (qbox, q_tiles, stages, grid)
// (ops/mips_topt.py::int8_scan_geometry mirrors it).
extern "C" int topt_int8_geometry(int b, int planes, int n_rows, int sms,
                                  int* out) {
  Geometry g;
  if (int rc = geometry(b, planes, n_rows, sms, &g)) return rc;
  out[0] = g.qbox;
  out[1] = g.q_tiles;
  out[2] = g.stages;
  out[3] = g.grid;
  return 0;
}
