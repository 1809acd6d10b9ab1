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
// All end in the epilogue _emit_topt (:32-49), shared in topt_emit.cuh.
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

#include "topt_emit.cuh"

namespace {

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

// One 16-bit scan, three instances:
//   B3 (F16 = false, PLANES = 2): bf16 rows, q_hi and q_lo bf16 planes,
//      score = acc_hi + acc_lo;
//   B5 (F16 = true, PLANES = 2): fp16 rows, q_h and q_l fp16 planes of the
//      query scaled by 2^k, score = (acc_h + 2^-11 acc_l) * inv_s;
//   B4 (F16 = true, PLANES = 1): fp16 rows, q_h only,
//      score = acc_h * inv_s.
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
  using S = Smem<TILE_N, PLANES>;
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
      const bool ok = q < b && k < row_bytes;
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
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ql_row = wm * 16 + gid + 8 * h;
    float row_scale = 1.f;
    if constexpr (F16) {
      if (q0 + ql_row < b) row_scale = inv_s[q0 + ql_row];
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
  topt::emit_topt<TILE_N, TQ, THREADS>(sc, S::SROW, q0, b, n0, nt,
                                        t_per_tile, out_s, out_i);
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

// q: (b, d) f32; emb: (n_rows, d) f32. Thread (warp w, lane l) owns queries
// 4w..4w+3 and columns l + 32j, j < TILE_N/32.
template <int TILE_N>
__global__ void __launch_bounds__(THREADS)
topt_dense_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ emb, int b, int d,
                      int n_rows, int n_valid, int t_per_tile, int q_tiles,
                      float* __restrict__ out_s, int* __restrict__ out_i) {
  using S = SmemF32<TILE_N>;
  constexpr int CJ = TILE_N / 32;  // columns per thread
  constexpr int QI = TQ / (THREADS / 32);  // queries per thread (4)
  __shared__ __align__(16) unsigned char smem[S::TOTAL];
  float* es = reinterpret_cast<float*>(smem);  // [FK][EROW]
  float* qs = es + FK * S::EROW;                // [FK][QROW]

  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int nt = blockIdx.x / q_tiles;
  const int n0 = nt * TILE_N;
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
      qs[kk * S::QROW + r] = qq < b && k < d ? q[(size_t)qq * d + k] : 0.f;
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

  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int cl = lane + 32 * j;
      sc[(warp * QI + i) * S::SROW + cl] =
          n0 + cl < n_valid ? acc[i][j] : NEG_INF;
    }
  __syncthreads();
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
  constexpr int smem = Smem<TILE_N, PLANES>::TOTAL;
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
