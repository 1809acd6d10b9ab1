// Two-plane int8 coarse scan with per-tile top-T emit, for Hopper (sm_90a).
//
// Replaces jsa_rag_tpu/ops/mips_pallas2.py::_topt_int8r2_kernel_t (:724-747)
// together with its epilogue _emit_topt (:32-49): the scan behind the int8r
// flat index's default "rows" refine (mips_topk_pallas2_int8_t, :794-945).
//
// What it computes, for every query row q and every tile of TILE_N index rows:
//   acc_p[q, n] = sum_k qv_p[q, k] * emb[n, k]             (int8 x int8 -> int32)
//   s[q, n]     = (f32(acc_1) * qs1[q] + f32(acc_2) * qs2[q]) * es[n]
//   s[q, n]     = NEG_INF for n >= n_valid (runtime valid count)
// then T extract-max passes per (q, tile): the tile's top-T as (score, global
// id), ties to the lower column like jnp.argmax, id -1 once the tile has no
// scorable column left. Output layout (n_tiles, b, T), as in the JAX package.
// The f32 combination is written with __fmul_rn/__fadd_rn so no FMA
// contraction changes the rounding: the scores equal the plain PyTorch
// version's (ops/mips_topt.py::scan_topt_int8r2_plain) bit for bit.
//
// Layout. The index plane is row-major (N, d), not the JAX package's (d, N):
// the TPU wanted the contraction dim leading for its MXU, while mma.sync's
// s8 "row.col" form wants both operands K-contiguous, which (N, d) rows are.
// It is also the on-disk layout, so load is a plain copy.
//
// Bound (H100 SXM, 3.35 TB/s, 1,979 TOPS int8 dense) at the main path's
// flagship shape N = 1.3M, d = 1024: plane 1 is read once, 1.33 GB ->
// 0.40 ms; the two int8 products are 4*B*N*d ops -> 1.38 ms at B = 512. So
// the scan is bound by operations above B ~ 150 and by bytes below it.
//
// Design, simple and right first:
// - blocks run independently over (query tile of 32 rows, index tile of
//   TILE_N rows) on a one-dimensional grid (2^31 - 1 blocks, so no cap on
//   the index short of int32 row ids); the query tile is the fastest-moving
//   part of the block index, so the blocks that read one index tile run
//   together and share it through L2 — device memory sees the plane about
//   once;
// - the two query planes are stacked as the 64 rows of the A operand, so one
//   B fragment of the index feeds both products (one read, two dots, like the
//   TPU kernel);
// - d streams through shared memory in 128-byte chunks, double-buffered with
//   cp.async (zero-filled past d and past the last row); rows are padded to
//   144 bytes so the 32-bit fragment loads are free of bank conflicts;
// - 8 warps (2 along queries x 4 along columns) run
//   mma.sync.m16n8k32.s8.s8.s32; each thread holds both planes' sums for the
//   same (query, column) cells and combines them in registers;
// - scores go to shared memory (reusing the stage buffers), then one warp per
//   query row keeps TILE_N/32 scores per lane in registers and runs the T
//   passes with a shuffle argmax.
// wgmma/TMA, a persistent schedule and ldmatrix fragment loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 32;        // queries per block (two planes -> 64 A rows)
constexpr int KC = 128;       // bytes of d per pipeline stage
constexpr int ROW = KC + 16;  // padded shared-memory row stride in bytes
constexpr int THREADS = 256;  // 8 warps: 2 along queries x 4 along columns
constexpr float NEG_INF = -3.40282347e+38f;  // float32 min, the JAX NEG_INF

template <int TILE_N>
struct Smem {
  static constexpr int A_BYTES = 2 * TQ * ROW;
  static constexpr int E_BYTES = TILE_N * ROW;
  static constexpr int STAGE = A_BYTES + E_BYTES;
  static constexpr int SROW = TILE_N + 8;  // score row stride in floats
  static constexpr int SCORES = TQ * SROW * 4;
  static constexpr int TOTAL = (2 * STAGE > SCORES) ? 2 * STAGE : SCORES;
};

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int TILE_N>
__global__ void __launch_bounds__(THREADS, 2)
topt_int8r2_kernel(const int8_t* __restrict__ qv1,
                   const float* __restrict__ qs1,
                   const int8_t* __restrict__ qv2,
                   const float* __restrict__ qs2,
                   const int8_t* __restrict__ emb,
                   const float* __restrict__ es, int b, int d, int n_rows,
                   int n_valid, int t_per_tile, int q_tiles,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  using S = Smem<TILE_N>;
  constexpr int WN = TILE_N / 4;  // columns per warp
  constexpr int NT8 = WN / 8;     // n8 mma tiles per warp
  constexpr int V = TILE_N / 32;  // scores per lane in the emit
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

  int acc[2][NT8][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0;

  auto load_stage = [&](int chunk, int stage) {
    unsigned char* a_s = smem + stage * S::STAGE;
    unsigned char* e_s = a_s + S::A_BYTES;
    const int k0 = chunk * KC;
    for (int i = tid; i < 2 * TQ * SEGS; i += THREADS) {
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
      unsigned a[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
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
        mma_s8(acc[0][j], a[0], b0, b1);
        mma_s8(acc[1][j], a[1], b0, b1);
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
    const float s2 = q < b ? qs2[q] : 0.f;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * WN + j * 8 + tig * 2 + e;
        const int col = n0 + cl;
        float s = NEG_INF;
        if (col < n_valid) {
          s = __fmul_rn(
              __fadd_rn(__fmul_rn(__int2float_rn(acc[0][j][2 * h + e]), s1),
                        __fmul_rn(__int2float_rn(acc[1][j][2 * h + e]), s2)),
              es[col]);
        }
        sc[ql * S::SROW + cl] = s;
      }
    }
  }
  __syncthreads();

  // per-row top-T: one warp per query row, TILE_N/32 scores per lane
  for (int r = warp; r < TQ; r += THREADS / 32) {
    const int q = q0 + r;
    if (q >= b) break;  // warp-uniform: rows ascend with r
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = sc[r * S::SROW + j * 32 + lane];
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

template <int TILE_N>
int launch(const int8_t* qv1, const float* qs1, const int8_t* qv2,
           const float* qs2, const int8_t* emb, const float* es, int b, int d,
           int n_rows, int n_valid, int t_per_tile, float* out_s, int* out_i,
           cudaStream_t stream) {
  constexpr int smem = Smem<TILE_N>::TOTAL;
  // once per process (a thread-safe static): the port drives one card
  static const cudaError_t attr = cudaFuncSetAttribute(
      topt_int8r2_kernel<TILE_N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int q_tiles = (b + TQ - 1) / TQ;
  const long long blocks =
      static_cast<long long>(q_tiles) * ((n_rows + TILE_N - 1) / TILE_N);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  topt_int8r2_kernel<TILE_N><<<grid, THREADS, smem, stream>>>(
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
    return launch<256>(a1, s1, a2, s2, e, se, b, d, n_rows, n_valid,
                       t_per_tile, os, oi, st);
  if (tile_n == 128)
    return launch<128>(a1, s1, a2, s2, e, se, b, d, n_rows, n_valid,
                       t_per_tile, os, oi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
