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
// B ~ 150 (B1) or ~ 300 (B2) and by bytes below it. At B = 512 the feed is
// not the limit: streaming a unit's A rows once per block instead of once
// per unit (a third of the bytes through L2) moved nothing, while taking
// the emit out took a third off B1 (PERF.md).
//
// Design (the 16-bit scans', at 8 bits): persistent blocks, one an SM,
// walking units of (128 A rows, 256 index rows) with the query tile
// moving fastest, so the blocks that read one index tile run together and
// share it through L2; a producer warp keeps a TMA ring full across units
// (stage rows of 128 bytes = 128 int8 values of d; B2: 4 stages of 48 KB,
// or up to 6 when a batch within one tile loads only its own rows; B1: 3,
// or 4 up to 24 queries, beside its score tile); two consumer warpgroups
// run wgmma m64n256k32 s8 into one s32 accumulator of 128 registers a
// thread, with the A rows as wgmma's A and the index tile as B. Every
// warpgroup multiplies, also where its rows lie past b (those are never
// written): a wgmma under a branch makes ptxas serialise every wgmma of
// the kernel (warning C7518). The schedule follows H at compile time (no
// knob, no run-time choice):
// - SERIAL (B2 and B8, H = 2): the consumers form a unit's scores and emit
//   them in registers on the thread quads (wgmma_scan.cuh::emit_quads)
//   while the producer loads the next unit. A 128-row emit tile emits a
//   unit's 256 columns as two tiles, a compile-time split (HALVES): a
//   run-time column range in the emit's inner loop cost B1 a fifth of its
//   time at B = 512 (PERF.md). B2's 128 queries a unit would need a score
//   tile of 133 KB, which leaves the ring one stage.
// - OVERLAP (B1, H = 1, at every batch): the consumers only form the
//   scores, into a score tile of the unit's 64 queries x 256 columns in
//   shared memory (65 KB), and go on to the next unit's products; two
//   emit warps, a thread a query, emit the tile meanwhile. Their passes
//   keep the best of each 16 columns in registers and rescan only the
//   group they emitted from (emit_row), so 2 warps keep up with 8 (4 full
//   passes a unit kept B1 emit-bound). The handoff runs on two named
//   barriers, where a waiting warp takes no issue slots (consumers polling
//   an mbarrier starved the emit warps). Where the index's bytes bound the
//   scan (B up to ~150) the shallower ring cost nothing: B1 read 1-2%
//   faster under OVERLAP than under SERIAL at B = 2-64 (PERF.md). The emit
//   within the consumers' own stages, between a stage's wgmma issue and its
//   wait, ran slower than after them; an emit warpgroup of four warps (the
//   loads then issued by a consumer thread) too, and 416 threads leave 152
//   registers a thread, fewer than the wgmma's 154.
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
// between warpgroups, and a query's scores are one row of the score tile.
// A unit is then 64 queries (32 a warpgroup), so one index tile serves
// half as many queries as in B2, for twice the products. The A box is
// streamed with every stage: keeping a query tile resident (128 KB at
// d = 1024) would leave 2 stages, and the bytes it saves are not the limit.
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

// The schedules (see Design), by H. SERIAL (B2, H = 2): both consumer
// warpgroups multiply a unit, then both form its scores and emit them.
// OVERLAP (B1, H = 1): the consumers hand each unit's scores to two emit
// warps through a score tile in shared memory and multiply the next unit
// while they emit.
enum Schedule { SERIAL = 0, OVERLAP = 1 };
// OVERLAP's block: the two consumer warpgroups, two emit warps (a thread a
// unit query) and the producer warp. The handoff runs on two named
// barriers, on which a waiting warp takes no issue slots from the others
// (an mbarrier wait polls).
constexpr int OV_EMIT = wgs::CONSUMERS;           // the first emit thread
constexpr int OV_PRODUCER = wgs::CONSUMERS + 64;  // the producer thread
constexpr int OV_THREADS = OV_PRODUCER + 32;
constexpr int SC_FULL = 1, SC_EMPTY = 2;  // named barriers of the handoff
constexpr int SC_SYNC = OV_PRODUCER;      // threads on each
// The score tile: a unit's 64 queries x 256 columns of f32 scores, rows of
// SROW floats (256 + 4: the emit warps' 16-byte loads of 8 rows at once
// meet no bank twice)
constexpr int SROW = wgs::TILE + 4;
constexpr int SC_BYTES = C::QROWS / 2 * SROW * 4;
// OVERLAP's ring: the serial ring less the score tile (3 full stages)
constexpr int OV_RING = C::RING - SC_BYTES;

// How a scan cuts its work: the A plane's rows (planes 1: the b query
// rows; 2: the interleaved 2 * round_up(b, 8)), the TMA box of query rows
// a stage takes, the query tiles of 128 A rows, the units, the persistent
// grid on sms SMs, the schedule, the ring's stages under it and the
// block's threads.
struct Geometry {
  int a_rows, qbox, q_tiles, stages, grid, schedule, threads;
  long long units;
};

int geometry(int b, int planes, int n_rows, int sms, Geometry* g) {
  if (b < 1 || n_rows < 1 || sms < 1 || (planes != 1 && planes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  g->a_rows = planes == 1 ? b : 2 * ((b + 7) / 8 * 8);
  g->qbox = wgs::query_box(g->a_rows, C::QROWS);
  g->q_tiles = (g->a_rows + C::QROWS - 1) / C::QROWS;
  g->units = static_cast<long long>(g->q_tiles) *
             ((n_rows + wgs::TILE - 1) / wgs::TILE);
  g->grid = static_cast<int>(g->units < sms ? g->units : sms);
  g->schedule = planes == 2 ? OVERLAP : SERIAL;
  g->stages = wgs::ring_depth(g->schedule == OVERLAP ? OV_RING : C::RING,
                              wgs::stage_bytes(1, g->qbox));
  g->threads = g->schedule == OVERLAP ? OV_THREADS : wgs::THREADS;
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

// A consumer warpgroup of B2 under SERIAL: each unit's products, then its
// scores and its emit.
template <int HALVES>
__device__ __forceinline__ void consume_serial(
    const wgs::Ring& ring, const wgs::Units& w, int n_k, const float* es_buf,
    uint64_t* es_full, uint64_t* es_empty, const float* __restrict__ qs1,
    const float* __restrict__ qs2, int b, int n_valid, int n_tiles_out,
    int t_per_tile, float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int QPU = C::QROWS;  // queries a unit
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int gid = (tw & 31) >> 2;
  int s = 0;
  uint32_t ph = 0;
  int acc[1][128];
  long long i = 0;
  for (long long u = w.u0; u < w.u1; u += w.step, ++i) {
    const int qw = static_cast<int>(u % w.q_tiles) * QPU + wg * (QPU / 2);
    const long long nt = u / w.q_tiles;
    const int n0 = static_cast<int>(nt) * wgs::TILE;
    // every warpgroup multiplies, past b too (rows never written): a
    // wgmma under a branch makes ptxas serialise all of them (C7518)
    wgs::mma_unit<false, 1, C>(acc, ring, s, ph, n_k, wg, true);
    const int q_warp = qw + 16 * (tw >> 5);  // 16 queries a warp
    // every consumer thread waits for the unit's scales and releases them,
    // so the buffer's phases advance in step
    const int k = static_cast<int>(i % C::SIDE);
    wgs::mbar_wait(&es_full[k], (i / C::SIDE) & 1);
    if (q_warp >= b) {  // the warp's rows all lie past b (warp-uniform)
      wgs::mbar_arrive(&es_empty[k]);
      continue;
    }
    const int q_row = q_warp + gid;  // the h = 0 row
    float v[128];
    scores<2>(acc[0], v, q_row, b, n0, n_valid, qs1, qs2,
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

// Arrive on named barrier id (count threads in all) without waiting.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A consumer warpgroup of B1 under OVERLAP: each unit's products, then,
// once the emit warps have released the score tile (SC_EMPTY), the unit's
// scores into it (row: the unit's query, 0..63; a warp past b writes none),
// handed over on SC_FULL.
__device__ __forceinline__ void consume_handoff(
    const wgs::Ring& ring, const wgs::Units& w, int n_k, const float* es_buf,
    uint64_t* es_full, uint64_t* es_empty, float* sc,
    const float* __restrict__ qs1, const float* __restrict__ qs2, int b,
    int n_valid) {
  constexpr int QPU = C::QROWS / 2;  // queries a unit (two A rows each)
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int gid = (tw & 31) >> 2, tig = tw & 3;
  const int q_local = wg * (QPU / 2) + 8 * (tw >> 5) + gid;
  int s = 0;
  uint32_t ph = 0;
  int acc[1][128];
  long long i = 0;
  for (long long u = w.u0; u < w.u1; u += w.step, ++i) {
    const int q0 = static_cast<int>(u % w.q_tiles) * QPU;
    const int n0 = static_cast<int>(u / w.q_tiles) * wgs::TILE;
    wgs::mma_unit<false, 1, C>(acc, ring, s, ph, n_k, wg, true);
    const int q_warp = q0 + q_local - gid;
    const int k = static_cast<int>(i % C::SIDE);
    wgs::mbar_wait(&es_full[k], (i / C::SIDE) & 1);
    wgs::named_sync(SC_EMPTY, SC_SYNC);
    if (q_warp < b) {  // warp-uniform
      float v[64];
      scores<1>(acc[0], v, q0 + q_local, b, n0, n_valid, qs1, qs2,
                es_buf + k * wgs::TILE);
      float* row = sc + q_local * SROW + 2 * tig;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(v[2 * j], v[2 * j + 1]);
    }
    wgs::mbar_arrive(&es_empty[k]);
    named_arrive(SC_FULL, SC_SYNC);
  }
}

// The best (score, column) of the 16 scores at row + 16 * g, ties to the
// lower column (columns ascend, so ">" keeps the first).
__device__ __forceinline__ void group_best(const float* row, int g, float& bv,
                                           int& bc) {
  bv = __int_as_float(0xff800000);  // -inf < NEG_INF
  bc = 16 * g;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 x4 = *reinterpret_cast<const float4*>(row + 16 * g + 4 * m);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (xs[k] > bv) {
        bv = xs[k];
        bc = 16 * g + 4 * m + k;
      }
  }
}

// The top-T of one emit tile of N scores at row (a thread's query), as T
// extract-max passes make it (wgmma_scan.cuh::emit_quads: the higher score
// first, ties to the lower column, id -1 once the tile has no scorable
// column), each emitted column cleared in the row. The best of each group
// of 16 columns is kept in registers, so a pass picks among the N / 16
// groups and rescans only the group it emitted from. Writes (score, n0 +
// c0 + column) at out_s / out_i[o + t].
template <int N>
__device__ __forceinline__ void emit_row(float* row, int c0, int n0,
                                         int t_per_tile, size_t o,
                                         float* __restrict__ out_s,
                                         int* __restrict__ out_i) {
  constexpr int G = N / 16;
  float gv[G];
  int gc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) group_best(row, g, gv[g], gc[g]);
  for (int t = 0; t < t_per_tile; ++t) {
    float bv = gv[0];
    int bc = gc[0];
#pragma unroll
    for (int g = 1; g < G; ++g)
      if (gv[g] > bv) {  // groups ascend in column: ties keep the first
        bv = gv[g];
        bc = gc[g];
      }
    out_s[o + t] = bv;
    out_i[o + t] = bv > NEG_INF * 0.5f ? n0 + c0 + bc : -1;
    if (t + 1 == t_per_tile) break;
    row[bc] = NEG_INF;
    const int gs = bc >> 4;
    float nv;
    int nc;
    group_best(row, gs, nv, nc);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g == gs) {
        gv[g] = nv;
        gc[g] = nc;
      }
  }
}

// B1's emit warps under OVERLAP: for each unit of the walk, once the
// consumers have filled the score tile (SC_FULL), thread e's query (row e)
// gets its per-tile top-T over each emit tile of 256 / HALVES columns
// (emit_row); then the tile goes back to the consumers (SC_EMPTY: free at
// the start, not handed back after the walk's last unit). Rows past b hold
// stale scores and are not written.
template <int HALVES>
__device__ __forceinline__ void emit_handoff(const wgs::Units& w, float* sc,
                                             int b, int n_tiles_out,
                                             int t_per_tile,
                                             float* __restrict__ out_s,
                                             int* __restrict__ out_i) {
  constexpr int QPU = C::QROWS / 2;
  constexpr int N = wgs::TILE / HALVES;  // columns an emit tile
  const int e = threadIdx.x - OV_EMIT;
  float* row = sc + e * SROW;
  named_arrive(SC_EMPTY, SC_SYNC);
  for (long long u = w.u0; u < w.u1; u += w.step) {
    const int q = static_cast<int>(u % w.q_tiles) * QPU + e;
    const long long nt = u / w.q_tiles;
    const int n0 = static_cast<int>(nt) * wgs::TILE;
    wgs::named_sync(SC_FULL, SC_SYNC);
    if (q < b) {
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        const long long nt_out = nt * HALVES + hf;
        if (nt_out >= n_tiles_out) break;
        emit_row<N>(row + hf * N, hf * N, n0, t_per_tile,
                    ((size_t)nt_out * b + q) * t_per_tile, out_s, out_i);
      }
    }
    if (u + w.step < w.u1) named_arrive(SC_EMPTY, SC_SYNC);
  }
}

// mq: the TMA map of the A plane (a_rows, d) int8 (B1: interleaved); me: of
// the (n_rows, d) int8 rows; mes: of the (n_rows,) f32 row scales; qs1, qs2
// (b,) f32 (qs2 B1 only). Out (n_tiles_out, b, t_per_tile) at emit tile
// 256 / HALVES. The schedule follows H: OVERLAP for B1 (H = 1), SERIAL for
// B2 (H = 2).
template <int H, int HALVES>
__global__ void __launch_bounds__(H == 1 ? OV_THREADS : wgs::THREADS, 1)
topt_int8_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap me,
                 const __grid_constant__ CUtensorMap mes,
                 const float* __restrict__ qs1, const float* __restrict__ qs2,
                 int b, int d, int n_valid, int n_tiles_out, int t_per_tile,
                 int q_tiles, int qbox, long long units,
                 float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int RING = H == 1 ? OV_RING : C::RING;
  extern __shared__ unsigned char smem_raw[];
  const wgs::Ring ring = wgs::carve<1>(smem_raw, RING, qbox);
  // the row scales of C::SIDE units, each with a full/empty barrier pair
  // after the ring's; B1: then the score tile
  float* es_buf = reinterpret_cast<float*>(ring.stages + RING);
  uint64_t* es_full = ring.full + 2 * wgs::MAX_STAGES;
  uint64_t* es_empty = es_full + C::SIDE;
  float* sc = es_buf + C::SIDE * wgs::TILE;
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
  const S8Loads loads{&mq, &me, &mes, qbox, es_buf, es_full, es_empty};
  if constexpr (H == 1) {
    if (threadIdx.x >= OV_PRODUCER) {
      if (threadIdx.x == OV_PRODUCER) wgs::produce<C>(ring, loads, n_k, w);
    } else if (threadIdx.x >= OV_EMIT) {
      emit_handoff<HALVES>(w, sc, b, n_tiles_out, t_per_tile, out_s, out_i);
    } else {
      consume_handoff(ring, w, n_k, es_buf, es_full, es_empty, sc, qs1, qs2,
                      b, n_valid);
    }
  } else {
    if (threadIdx.x >= wgs::CONSUMERS) {
      if (threadIdx.x == wgs::CONSUMERS) wgs::produce<C>(ring, loads, n_k, w);
      return;
    }
    consume_serial<HALVES>(ring, w, n_k, es_buf, es_full, es_empty, qs1, qs2,
                           b, n_valid, n_tiles_out, t_per_tile, out_s, out_i);
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
      <<<g.grid, g.threads, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
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
// rows takes on sms SMs: out = (qbox, q_tiles, stages, grid, schedule,
// threads) (ops/mips_topt.py::int8_scan_geometry mirrors it).
extern "C" int topt_int8_geometry(int b, int planes, int n_rows, int sms,
                                  int* out) {
  Geometry g;
  if (int rc = geometry(b, planes, n_rows, sms, &g)) return rc;
  out[0] = g.qbox;
  out[1] = g.q_tiles;
  out[2] = g.stages;
  out[3] = g.grid;
  out[4] = g.schedule;
  out[5] = g.threads;
  return 0;
}
