// Exact streaming MIPS top-k for Hopper (sm_90a): kernel B9.
//
// Replaces jsa_rag_tpu/ops/mips_pallas.py::_mips_kernel (:38-90), behind
// mips_topk_pallas (:93-161) and ops/mips.py::mips_topk's method "pallas":
// queries (B, d) against row-major rows (N, d), bf16 or f32, -> the exact
// top-k of every query's scores. The TPU kernel walks the N tiles in order
// on one core and carries one sorted running (tile_q, k_pad) list in VMEM
// scratch, merging each tile by a rank-insert loop with a data-dependent
// trip count. Hopper's blocks run in parallel and carry nothing from one to
// the next, so the work is split instead:
//
// - the N tiles (TILE_N = 256 rows) are cut into S slices, and one block
//   takes (a tile of qpb query rows, one slice); S is chosen by the wrapper
//   so ceil(B / qpb) * S blocks fill the SMs once;
// - a block scores each tile of its slice with the dense scans' core
//   (dense_scan.cuh: the bf16 rows against the hi/lo bf16 split of the f32
//   query on mma.sync m16n8k16, or the f32 FMA loop; the precision is B3's,
//   see topt_dense.cu) into a score tile in shared memory;
// - it keeps, for each of its queries, an exact running top-k of its slice
//   in shared memory: k (score, id) pairs, unsorted, with the list's minimum
//   and its slot (the threshold) beside them;
// - a tile merges per query row on one warp, warp-uniformly: while the list
//   is short the tile's scorable columns are appended in column order
//   (ballot + prefix count); once it is full, each lane keeps its tile
//   scores above the threshold pending, and while any lane has one, the
//   lowest such lane's best replaces the list's minimum and the warp
//   recomputes the minimum (k/32 shared loads a lane and a shuffle
//   reduction). After the first tiles almost no score passes the
//   threshold, and a tile costs each row 8 compares and one ballot;
// - the block writes its lists as (S, B, k) candidates; the wrapper
//   finishes with the exact merge (ops/mips_topt.py::_merge_candidates).
//
// Exactness: every replacement swaps the list's minimum for a larger score,
// so the threshold only rises; a score left out was at most the threshold
// when it was passed over or evicted, hence at most the final minimum. So
// each slice's list is a top-k of the slice (its score multiset is exact),
// and it holds every member of the global top-k that lies in the slice.
// Each (tile, column) enters at most once, so the ids are distinct; a slice
// with fewer than k rows leaves (NEG_INF, -1) slots, which the merge never
// returns while n >= k (the wrapper takes k = min(k, n)). Equal scores may
// come back in any order, where the TPU's rank-insert put a new one ahead.
//
// Shared memory against k: a list takes 8 bytes per query and slot, beside
// the scoring core's stages (92,160 bytes for bf16 rows, 37,120 for f32; the
// score tile aliases them). The wrapper reads that fixed part and a block's
// 232,448 bytes from mips_stream_fixed_smem / mips_stream_max_smem, sizes
// qpb = min(32, budget / (8 k)), and refuses a k whose one-query list does
// not fit. Rows qpb..31 of the 32-row scoring tile are zero-filled.
//
// Bound (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): the rows are read
// once, N*d*2 bytes (2.66 GB -> 0.80 ms at N = 1.3M, d = 1024), and the
// split query makes two products, 2 * 2*B*N*d operations (2.8 ms at
// B = 512); the larger bounds. Like B3, the design is simple first: each
// block re-reads its slice for its own query tile (ceil(B / qpb) reads of
// the index in all, through L2 only by chance), one block an SM where the
// lists push the block past half the SM's shared memory; wgmma/TMA and a
// query tile that covers all of B are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_scan.cuh"

namespace {

using dense::THREADS;
using dense::TQ;
using topt::NEG_INF;

constexpr int TILE_N = 256;
constexpr int SROW = TILE_N + 8;  // score row stride in floats
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr int ROW_STATE = 3 * TQ * 4;  // threshold, its slot, fill count
constexpr unsigned FULL = 0xffffffffu;
constexpr float FLT_MAXF = 3.40282347e+38f;

template <bool F32>
__host__ __device__ constexpr int stage_bytes() {
  return F32 ? dense::SmemF32<TILE_N>::TOTAL : dense::Smem<TILE_N, 2>::TOTAL;
}

// The minimum of l[0..k) and its slot (the lowest slot among equal minima),
// on every lane of the warp.
__device__ __forceinline__ void warp_min(const float* l, int k, float* t,
                                         int* at) {
  const int lane = threadIdx.x & 31;
  float mv = FLT_MAXF;
  int mi = k;
  for (int i = lane; i < k; i += 32) {
    const float v = l[i];
    if (v < mv) {
      mv = v;
      mi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, mv, off);
    const int oi = __shfl_xor_sync(FULL, mi, off);
    if (ov < mv || (ov == mv && oi < mi)) {
      mv = ov;
      mi = oi;
    }
  }
  *t = mv;
  *at = mi;
}

// Merge a (TQ, TILE_N) score tile into the running lists of its first
// `rows` query rows; warp w takes rows w, w + 8, ... . `list_s`/`list_i`
// hold k slots a row; `thr`, `slot`, `fill` the row's minimum, its slot and
// how many slots are filled (the minimum is NEG_INF until the list is full).
__device__ __forceinline__ void merge_tile(const float* sc, float* list_s,
                                           int* list_i, float* thr,
                                           int* slot, int* fill, int rows,
                                           int k, int n0) {
  constexpr int V = TILE_N / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += WARPS) {
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = sc[r * SROW + j * 32 + lane];
    float* ls = list_s + (size_t)r * k;
    int* li = list_i + (size_t)r * k;
    float t = thr[r];
    int at = slot[r];
    int c = fill[r];
    if (c < k) {
      // fill: append scorable columns (masked ones score NEG_INF) in column
      // order; what does not fit stays pending for the replacement below
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool p = v[j] > NEG_INF;
        const unsigned m = __ballot_sync(FULL, p);
        const int pos = c + __popc(m & ((1u << lane) - 1u));
        if (p && pos < k) {
          ls[pos] = v[j];
          li[pos] = n0 + j * 32 + lane;
          v[j] = NEG_INF;
        }
        c = min(k, c + __popc(m));
      }
      __syncwarp();
      if (c == k) warp_min(ls, k, &t, &at);
    }
    if (c == k) {
      // replace: while a lane holds a score above the minimum, the lowest
      // such lane's best takes the minimum's slot
      for (;;) {
        float bv = t;
        int bj = -1;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (v[j] > bv) {
            bv = v[j];
            bj = j;
          }
        }
        const unsigned m = __ballot_sync(FULL, bj >= 0);
        if (m == 0u) break;
        const int leader = __ffs(m) - 1;
        const float cv = __shfl_sync(FULL, bv, leader);
        const int cj = __shfl_sync(FULL, bj, leader);
        if (lane == leader) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (j == cj) v[j] = NEG_INF;
        }
        if (lane == 0) {
          ls[at] = cv;
          li[at] = n0 + cj * 32 + leader;
        }
        __syncwarp();
        warp_min(ls, k, &t, &at);
        __syncwarp();  // every lane has read the list before the next write
      }
    }
    if (lane == 0) {
      thr[r] = t;
      slot[r] = at;
      fill[r] = c;
    }
  }
}

// qh, ql: (b, d) bf16 planes of the split query (bf16 rows); qf: (b, d) f32
// (f32 rows); emb: (n_rows, d) rows. out_s/out_i: (slices, b, k).
template <bool F32>
__global__ void __launch_bounds__(THREADS, 2)
mips_stream_kernel(const unsigned char* __restrict__ qh,
                   const unsigned char* __restrict__ ql,
                   const float* __restrict__ qf,
                   const unsigned char* __restrict__ emb, int b, int d,
                   int n_rows, int k, int qpb, int q_tiles,
                   int tiles_per_slice, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  constexpr int STAGE = stage_bytes<F32>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);  // aliases the stages
  float* list_s = reinterpret_cast<float*>(smem + STAGE);
  int* list_i = reinterpret_cast<int*>(list_s + (size_t)qpb * k);
  float* thr = reinterpret_cast<float*>(list_i + (size_t)qpb * k);
  int* slot = reinterpret_cast<int*>(thr + TQ);
  int* fill = slot + TQ;

  const int s = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * qpb;
  const int q_end = min(b, q0 + qpb);
  const int rows = q_end - q0;
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * k; i += THREADS) {
    list_s[i] = NEG_INF;
    list_i[i] = -1;
  }
  for (int r = tid; r < TQ; r += THREADS) {
    thr[r] = NEG_INF;
    slot[r] = 0;
    fill[r] = 0;
  }
  // the scoring core's closing barrier orders these writes before the merge

  const int n_tiles = (n_rows + TILE_N - 1) / TILE_N;
  const int t_lo = s * tiles_per_slice;
  const int t_hi = min(n_tiles, t_lo + tiles_per_slice);
  for (int nt = t_lo; nt < t_hi; ++nt) {
    const int n0 = nt * TILE_N;
    if constexpr (F32) {
      dense::f32_scores<TILE_N>(smem, sc, qf,
                                reinterpret_cast<const float*>(emb), q_end,
                                d, n_rows, n_rows, q0, n0);
    } else {
      dense::mma_scores<false, 2, TILE_N>(smem, sc, qh, ql, nullptr, emb,
                                          q_end, d, n_rows, n_rows, q0, n0);
    }
    merge_tile(sc, list_s, list_i, thr, slot, fill, rows, k, n0);
    __syncthreads();  // the next tile's staging overwrites the scores
  }

  for (int i = tid; i < rows * k; i += THREADS) {
    const int r = i / k;
    const size_t o = ((size_t)s * b + q0 + r) * k + (i - r * k);
    out_s[o] = list_s[i];
    out_i[o] = list_i[i];
  }
}

template <bool F32>
int launch(const void* qh, const void* ql, const void* qf, const void* emb,
           int b, int d, int n_rows, int k, int qpb, int tiles_per_slice,
           void* out_s, void* out_i, void* stream) {
  if (b < 1 || d < 1 || n_rows < 1 || k < 1 || k > n_rows || qpb < 1 ||
      qpb > TQ || tiles_per_slice < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem =
      stage_bytes<F32>() + 8LL * qpb * k + static_cast<long long>(ROW_STATE);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // once per process and instance (a thread-safe static): the port drives
  // one card; each launch then asks for what its k and qpb need
  static const cudaError_t attr = cudaFuncSetAttribute(
      mips_stream_kernel<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long q_tiles = (b + qpb - 1) / qpb;
  const long long n_tiles = (n_rows + TILE_N - 1LL) / TILE_N;
  const long long blocks =
      q_tiles * ((n_tiles + tiles_per_slice - 1) / tiles_per_slice);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mips_stream_kernel<F32>
      <<<dim3(static_cast<unsigned>(blocks)), THREADS, static_cast<int>(smem),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const unsigned char*>(qh),
          static_cast<const unsigned char*>(ql),
          static_cast<const float*>(qf),
          static_cast<const unsigned char*>(emb), b, d, n_rows, k, qpb,
          static_cast<int>(q_tiles), tiles_per_slice,
          static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. qh, ql (b, d) bf16 planes; q (b, d) f32;
// emb (n_rows, d) bf16 or f32; out_s, out_i (slices, b, k) with slices =
// ceil(ceil(n_rows / 256) / tiles_per_slice). All contiguous, 16-byte
// aligned, d % 16 == 0, 1 <= k <= n_rows, 1 <= qpb <= 32 (the Python
// wrapper checks). Each returns a cudaError_t, 0 on a clean launch.
extern "C" int mips_stream_bf16_launch(const void* qh, const void* ql,
                                       const void* emb, int b, int d,
                                       int n_rows, int k, int qpb,
                                       int tiles_per_slice, void* out_s,
                                       void* out_i, void* stream) {
  return launch<false>(qh, ql, nullptr, emb, b, d, n_rows, k, qpb,
                       tiles_per_slice, out_s, out_i, stream);
}

// The shared memory a block takes besides its lists (the scoring core's
// stages and the per-row state) for bf16 (f32 = 0) or f32 rows, and the
// most a block may take: the wrapper sizes qpb from these.
extern "C" int mips_stream_fixed_smem(int f32) {
  return (f32 ? stage_bytes<true>() : stage_bytes<false>()) + ROW_STATE;
}

extern "C" int mips_stream_max_smem() { return MAX_SMEM; }

extern "C" int mips_stream_f32_launch(const void* q, const void* emb, int b,
                                      int d, int n_rows, int k, int qpb,
                                      int tiles_per_slice, void* out_s,
                                      void* out_i, void* stream) {
  return launch<true>(nullptr, nullptr, q, emb, b, d, n_rows, k, qpb,
                      tiles_per_slice, out_s, out_i, stream);
}
