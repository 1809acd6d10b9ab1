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
// - the N tiles (TILE = 256 rows) are cut into S slices, and one block
//   takes (a tile of qpb query rows, one slice); S is chosen by the wrapper
//   so ceil(B / qpb) * S blocks fill the SMs once;
// - bf16 rows: a block scores its slice with the 16-bit core
//   (wgmma_scan.cuh: a TMA ring that runs across the slice's tiles, two
//   warpgroups of wgmma m64n256k16, qpb = 128 queries; a bf16 query is one
//   plane, an f32 query its hi/lo bf16 split into one accumulator, the
//   precision of B3, see topt_dense.cu); f32 rows: the f32 FMA loop of
//   dense_scan.cuh, qpb = 32, into a score tile in shared memory;
// - it keeps, for each of its queries, an exact running top-k of its slice:
//   k (score, id) slots, unsorted; the ids in the block's own rows of the
//   (S, B, k) output, the scores in shared memory where min(B, 128) lists
//   fit beside a ring of two stages (k <= 239 with one plane) and in the
//   output otherwise; the list's minimum, its slot and the fill count in
//   shared memory;
// - a tile merges per query row on one warp, warp-uniformly: while the list
//   is short the tile's scorable columns are appended in column order
//   (ballot + prefix count); once it is full, a row with 8 or more scores
//   above the minimum (the first tiles of a slice) takes them in one batch
//   (merge_batch: the k-th largest of list and candidates by a bitwise
//   search on warp sums, one compaction), and otherwise, while a lane holds
//   a score above the minimum, the lowest such lane's best replaces it and
//   the warp recomputes the minimum (a scan and two warp integer
//   reductions). With bf16 rows the scores sit in registers (a thread quad
//   per query row) and a row is merged only when one of its scores beats
//   its minimum, through a 256-float row buffer of the warp; the wrapper
//   orders the queries so that consecutive ones fall on different warps
//   (a warp merges its own 16 rows in turn). After the first tiles almost
//   no score passes, and a tile costs a row 64 compares a thread and a
//   ballot;
// - the wrapper finishes with the exact merge of the (S, B, k) lists
//   (ops/mips_topt.py::_merge_candidates).
//
// Exactness: every replacement swaps the list's minimum for a larger score,
// and a batch keeps a top-k of the list and its candidates, so the
// threshold only rises; a score left out was at most the threshold
// when it was passed over or evicted, hence at most the final minimum. So
// each slice's list is a top-k of the slice (its score multiset is exact),
// and it holds every member of the global top-k that lies in the slice.
// Each (tile, column) enters at most once, so the ids are distinct; a slice
// with fewer than k rows leaves (NEG_INF, -1) slots, which the merge never
// returns while n >= k (the wrapper takes k = min(k, n)). Equal scores may
// come back in any order, where the TPU's rank-insert put a new one ahead.
//
// Memory against k: shared memory no longer bounds k (the lists go to the
// output when they do not fit); k is capped at K_MAX = 32,768, where the
// rare replacement path reads k/32 slots a lane.
//
// Bound (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense): the rows are read
// once, N*d*2 bytes (2.66 GB -> 0.80 ms at N = 1.3M, d = 1024); one bf16
// product is 2*B*N*d operations (1.4 ms at B = 512), an f32 query's two
// 4*B*N*d; the larger bounds.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_scan.cuh"
#include "wgmma_scan.cuh"

namespace {

using topt::NEG_INF;

constexpr int TILE = wgs::TILE;
constexpr int K_MAX = 32768;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;
constexpr float FLT_MAXF = 3.40282347e+38f;

// f32 rows: the f32 core's block of 8 warps, 32 queries
constexpr int F32_THREADS = dense::THREADS;
constexpr int F32_WARPS = F32_THREADS / 32;
constexpr int SROW = TILE + 8;  // f32 score row stride in floats
constexpr int F32_SMEM = dense::SmemF32<TILE>::TOTAL + 3 * dense::TQ * 4;

// bf16 rows: the barriers, the ring, a 256-float row buffer for each of the
// 8 consumer warps, (threshold, slot, fill) for 128 queries and, where they
// fit beside a ring of at least two stages, the scores of the lists of k
// slots of the tile's query rows (min(b, 128)); else those live in the
// output too, and the ring takes what is left. (A list's ids always live in
// the output: the merge writes them but never reads them.) -> the block's
// shared memory, the ring's bytes and whether the scores are in shared
// memory.
struct StreamLayout {
  int smem, ring;
  bool smem_lists;
};

constexpr int STREAM_FIXED = wgs::BARS + (wgs::CONSUMERS / 32) * TILE * 4 +
                             3 * 128 * 4 + 1024;

inline StreamLayout stream_layout(int planes, int k, int b) {
  const int stride = wgs::stage_bytes(planes, 128);
  const long long lists = 4LL * (b < 128 ? b : 128) * k;
  const long long avail = MAX_SMEM - STREAM_FIXED - lists;
  if (avail >= 2LL * stride) {
    const int ring = wgs::ring_depth(static_cast<int>(avail), stride) * stride;
    return {static_cast<int>(STREAM_FIXED + ring + lists), ring, true};
  }
  const int ring =
      wgs::ring_depth(MAX_SMEM - STREAM_FIXED, stride) * stride;
  return {STREAM_FIXED + ring, ring, false};
}

// A float's bits as an unsigned key in the float's order (no NaNs here).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The minimum of l[0..k) and its slot (the lowest slot among equal minima),
// on every lane of the warp: a scan of each lane's slots, then two warp
// reductions on the hardware's integer reduce (the order key, then the
// lowest slot holding it).
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
  const unsigned key = order_key(mv);
  const unsigned lo = __reduce_min_sync(FULL, key);
  const int slot = static_cast<int>(__reduce_min_sync(
      FULL, key == lo ? static_cast<unsigned>(mi) : 0xffffffffu));
  *t = __shfl_sync(FULL, mv, slot & 31);
  *at = slot;
}

constexpr int BATCH_MIN = 8;    // candidates that take the batch insert
constexpr int BATCH_K = 128;    // the largest k it takes (4 slots a lane)

// Inserts every candidate v[j] > t of a full list (k <= BATCH_K) at once:
// X, the k-th largest order key of (list + candidates), by a bitwise search
// on warp sums; the list keeps its entries above X and, first, those at X;
// the candidates above X and then those at X (in column order) take the
// freed slots in slot order (`scratch`: BATCH_K ints of this warp). Each
// candidate is settled (v[j] set to NEG_INF). The new list is a top-k of
// the old list and the candidates.
__device__ __forceinline__ void merge_batch(float (&v)[TILE / 32], float t,
                                            float* ls, int* li, int k,
                                            int n0, int* scratch) {
  constexpr int V = TILE / 32, Q = BATCH_K / 32;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  unsigned lk[Q], ck[V];
  bool lin[Q], cin[V];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    lin[q] = lane + 32 * q < k;
    lk[q] = lin[q] ? order_key(ls[lane + 32 * q]) : 0u;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    cin[j] = v[j] > t;
    ck[j] = cin[j] ? order_key(v[j]) : 0u;
  }
  unsigned x = 0u;  // the largest key with at least k keys at or above it
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = x | (1u << bit);
    int n = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) n += lin[q] && lk[q] >= cand;
#pragma unroll
    for (int j = 0; j < V; ++j) n += cin[j] && ck[j] >= cand;
    if (static_cast<int>(__reduce_add_sync(FULL, n)) >= k) x = cand;
  }
  int above = 0, equal = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    above += lin[q] && lk[q] > x;
    equal += lin[q] && lk[q] == x;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) above += cin[j] && ck[j] > x;
  const int need = k - static_cast<int>(__reduce_add_sync(FULL, above));
  const int keep_eq = min(static_cast<int>(__reduce_add_sync(FULL, equal)),
                          need);
  const int take_eq = need - keep_eq;
  int freed = 0, seen = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const bool eq = lin[q] && lk[q] == x;
    const unsigned me = __ballot_sync(FULL, eq);
    const bool gone = lin[q] && lk[q] <= x &&
                      !(eq && seen + __popc(me & lt) < keep_eq);
    const unsigned mg = __ballot_sync(FULL, gone);
    if (gone) scratch[freed + __popc(mg & lt)] = lane + 32 * q;
    freed += __popc(mg);
    seen += __popc(me);
  }
  __syncwarp();
  int used = 0;
  seen = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool eq = cin[j] && ck[j] == x;
    const unsigned me = __ballot_sync(FULL, eq);
    const bool in = cin[j] && (ck[j] > x ||
                               (eq && seen + __popc(me & lt) < take_eq));
    const unsigned mi = __ballot_sync(FULL, in);
    if (in) {
      const int at = scratch[used + __popc(mi & lt)];
      ls[at] = v[j];
      li[at] = n0 + j * 32 + lane;
    }
    used += __popc(mi);
    seen += __popc(me);
    v[j] = NEG_INF;
  }
  __syncwarp();
}

// Merge one query row's 256 tile scores (row[c], column c; masked columns
// score NEG_INF) into its running list (ls, li: k slots in device memory),
// on one warp. `thr`, `slot` and `fill` hold the row's minimum, its slot
// and how many slots are filled (the minimum is NEG_INF until the list is
// full). Only this
// warp touches the row's list and state; __syncwarp orders its lanes'
// reads after lane 0's writes.
__device__ __forceinline__ void merge_row(const float* row, float* ls,
                                          int* li, float* thr, int* slot,
                                          int* fill, int k, int n0,
                                          int* scratch) {
  constexpr int V = TILE / 32;
  const int lane = threadIdx.x & 31;
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = row[j * 32 + lane];
  float t = *thr;
  int at = *slot;
  int c = *fill;
  if (c < k) {
    // fill: append scorable columns in column order; what does not fit
    // stays pending for the replacement below
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
    // many candidates (the first tiles of a slice): all in one batch
    if (scratch != nullptr && k <= BATCH_K) {
      int m = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) m += __popc(__ballot_sync(FULL, v[j] > t));
      if (m >= BATCH_MIN) {
        merge_batch(v, t, ls, li, k, n0, scratch);
        warp_min(ls, k, &t, &at);
        __syncwarp();
      }
    }
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
  __syncwarp();
  if (lane == 0) {
    *thr = t;
    *slot = at;
    *fill = c;
  }
  __syncwarp();
}

// Sets one warp's rows [r0, r1) of the (S, b, k) lists to (NEG_INF, -1).
__device__ __forceinline__ void clear_rows(float* out_s, int* out_i,
                                           size_t r0, size_t r1, int k) {
  const int lane = threadIdx.x & 31;
  for (size_t i = r0 * k + lane; i < r1 * k; i += 32) {
    out_s[i] = NEG_INF;
    out_i[i] = -1;
  }
  __syncwarp();
}

// bf16 rows. mq0, mq1: TMA maps of the (b_rows, d) bf16 query planes (mq1
// unused with one plane), the caller's queries permuted within each tile of
// 128 so that consecutive queries land on different warps (src: (b_rows,)
// the caller's row of each, -1 for padding); me: of the (n_rows, d) rows.
// ring_bytes: the ring's share of shared memory (stream_layout).
// out_s/out_i: (slices, b, k), rows by src.
template <int PLANES, bool SMEM_LISTS>
__global__ void __launch_bounds__(wgs::THREADS, 1)
mips_stream_bf16_kernel(const __grid_constant__ CUtensorMap mq0,
                        const __grid_constant__ CUtensorMap mq1,
                        const __grid_constant__ CUtensorMap me,
                        const int* __restrict__ src, int b, int d,
                        int n_rows, int k, int q_tiles, int tiles_per_slice,
                        int ring_bytes, float* out_s, int* out_i) {
  using C = wgs::Cfg<false, PLANES>;
  extern __shared__ unsigned char smem_raw[];
  const wgs::Ring ring = wgs::carve<PLANES>(smem_raw, ring_bytes, C::QROWS);
  float* wbuf = reinterpret_cast<float*>(ring.stages + ring_bytes);
  float* thr = wbuf + (wgs::CONSUMERS / 32) * TILE;
  int* slot = reinterpret_cast<int*>(thr + C::QROWS);
  int* fill = slot + C::QROWS;
  float* sls = reinterpret_cast<float*>(fill + C::QROWS);
  wgs::init_ring(ring);
  __syncthreads();
  const int slice = blockIdx.x / q_tiles;
  const int qt = blockIdx.x % q_tiles;
  const int n_tiles = (n_rows + TILE - 1) / TILE;
  const int t_lo = slice * tiles_per_slice;
  const int t_hi = min(n_tiles, t_lo + tiles_per_slice);
  const wgs::Units w{static_cast<long long>(t_lo) * q_tiles + qt,
                     static_cast<long long>(t_hi) * q_tiles, q_tiles,
                     q_tiles};
  const int n_k = (d + wgs::KC - 1) / wgs::KC;
  if (threadIdx.x >= wgs::CONSUMERS) {
    if (threadIdx.x == wgs::CONSUMERS)
      wgs::produce<C>(
          ring, wgs::PlaneLoads<C, PLANES>{&mq0, &mq1, &me, C::QROWS}, n_k, w);
    return;
  }
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int warp = threadIdx.x >> 5, lane = tw & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qt * C::QROWS;
  const int r_base = 64 * wg + 16 * (tw >> 5);  // the warp's first local row
  float* buf = wbuf + warp * TILE;
  // the list of local row r: its scores in shared memory (by the caller's
  // row within the tile, < min(b, 128): the permutation stays inside a
  // tile) or in the caller's row of the output; its ids in that row
  auto list_s = [&](int r) {
    return SMEM_LISTS ? sls + (size_t)(src[q0 + r] - q0) * k
                      : out_s + ((size_t)slice * b + src[q0 + r]) * k;
  };
  auto list_i = [&](int r) {
    return out_i + ((size_t)slice * b + src[q0 + r]) * k;
  };

  // each warp owns 16 rows: their lists and state
  bool any = false;  // the warp has a row of the caller
  for (int i = 0; i < 16; ++i) {
    const int r = r_base + i;
    if (src[q0 + r] < 0) continue;
    any = true;
    float* ls = list_s(r);
    int* li = list_i(r);
    for (int j = lane; j < k; j += 32) {
      ls[j] = NEG_INF;
      li[j] = -1;
    }
  }
  if (lane < 16) {
    thr[r_base + lane] = NEG_INF;
    slot[r_base + lane] = 0;
    fill[r_base + lane] = 0;
  }
  __syncwarp();
  // a warpgroup with no row of the caller releases the stages unmultiplied
  bool active = false;
  for (int i = 0; i < 64; ++i) active |= src[q0 + 64 * wg + i] >= 0;

  int s = 0;
  uint32_t ph = 0;
  float acc[1][128];
  for (long long u = w.u0; u < w.u1; u += w.step) {
    const int n0 = static_cast<int>(u / q_tiles) * TILE;
    wgs::mma_unit<false, PLANES, C>(acc, ring, s, ph, n_k, wg, active);
    if (!any) continue;
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      const int j = i >> 2, e = i & 1;
      if (n0 + 8 * j + 2 * tig + e >= n_rows) acc[0][i] = NEG_INF;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_base + gid + 8 * h;
      const float t = src[q0 + r] >= 0 ? thr[r] : FLT_MAXF;
      bool f = false;
#pragma unroll
      for (int i = 0; i < 128; ++i)
        if (((i >> 1) & 1) == h) f |= acc[0][i] > t;
      const unsigned m = __ballot_sync(FULL, f);
      for (int g = 0; g < 8; ++g) {
        if (((m >> (4 * g)) & 0xFu) == 0u) continue;  // warp-uniform
        if (gid == g) {
#pragma unroll
          for (int i = 0; i < 128; ++i)
            if (((i >> 1) & 1) == h)
              buf[8 * (i >> 2) + 2 * tig + (i & 1)] = acc[0][i];
        }
        __syncwarp();
        const int rr = r_base + g + 8 * h;
        // the row buffer doubles as the batch insert's scratch
        merge_row(buf, list_s(rr), list_i(rr), &thr[rr], &slot[rr],
                  &fill[rr], k, n0, reinterpret_cast<int*>(buf));
      }
    }
  }
  if constexpr (SMEM_LISTS) {
    for (int i = 0; i < 16; ++i) {
      const int r = r_base + i;
      if (src[q0 + r] < 0) continue;
      const size_t o = ((size_t)slice * b + src[q0 + r]) * k;
      const float* ls = list_s(r);
      for (int j = lane; j < k; j += 32) out_s[o + j] = ls[j];
    }
  }
}

// f32 rows: q (b, d) f32, emb (n_rows, d) f32, 32 queries a block on the
// f32 core. out_s/out_i: (slices, b, k).
__global__ void __launch_bounds__(F32_THREADS, 2)
mips_stream_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ emb, int b, int d,
                       int n_rows, int k, int q_tiles, int tiles_per_slice,
                       float* out_s, int* out_i) {
  using S = dense::SmemF32<TILE>;
  __shared__ __align__(16) unsigned char smem[S::TOTAL];
  __shared__ float thr[dense::TQ];
  __shared__ int slot[dense::TQ], fill[dense::TQ];
  float* sc = reinterpret_cast<float*>(smem);  // aliases the stages

  const int s = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * dense::TQ;
  const int q_end = min(b, q0 + dense::TQ);
  const int rows = q_end - q0;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += F32_WARPS)
    clear_rows(out_s, out_i, (size_t)s * b + q0 + r,
               (size_t)s * b + q0 + r + 1, k);
  for (int r = threadIdx.x; r < dense::TQ; r += F32_THREADS) {
    thr[r] = NEG_INF;
    slot[r] = 0;
    fill[r] = 0;
  }
  // the scoring core's closing barrier orders these writes before the merge

  const int n_tiles = (n_rows + TILE - 1) / TILE;
  const int t_lo = s * tiles_per_slice;
  const int t_hi = min(n_tiles, t_lo + tiles_per_slice);
  for (int nt = t_lo; nt < t_hi; ++nt) {
    const int n0 = nt * TILE;
    dense::f32_scores<TILE>(smem, sc, q, emb, q_end, d, n_rows, n_rows, q0,
                            n0);
    for (int r = warp; r < rows; r += F32_WARPS) {
      const size_t o = ((size_t)s * b + q0 + r) * k;
      merge_row(sc + r * SROW, out_s + o, out_i + o, &thr[r], &slot[r],
                &fill[r], k, n0, nullptr);
    }
    __syncthreads();  // the next tile's staging overwrites the scores
  }
}

int check(int b, int d, int n_rows, int k, int qpb, int tiles_per_slice,
          int want_qpb, long long* blocks, int* q_tiles) {
  if (b < 1 || d < 1 || n_rows < 1 || k < 1 || k > n_rows || k > K_MAX ||
      qpb != want_qpb || tiles_per_slice < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *q_tiles = (b + qpb - 1) / qpb;
  const long long n_tiles = (n_rows + TILE - 1LL) / TILE;
  *blocks = *q_tiles * ((n_tiles + tiles_per_slice - 1) / tiles_per_slice);
  if (*blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int PLANES, bool SMEM_LISTS>
int launch_bf16(const void* qh, const void* ql, const int* src,
                const void* emb, int b, int d, int n_rows, int k,
                int q_tiles, long long blocks, int tiles_per_slice,
                const StreamLayout& lay, void* out_s, void* out_i,
                void* stream) {
  using C = wgs::Cfg<false, PLANES>;
  // once per process and instance (a thread-safe static): the port drives
  // one card; each launch then asks for what its k and b need
  static const cudaError_t attr = cudaFuncSetAttribute(
      mips_stream_bf16_kernel<PLANES, SMEM_LISTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int b_rows = q_tiles * C::QROWS;  // the permuted, padded queries
  CUtensorMap mq0, mq1, me;
  if (int rc = wgs::make_map(&mq0, qh, false, d, b_rows, C::QROWS)) return rc;
  if (int rc = wgs::make_map(&mq1, PLANES == 2 ? ql : qh, false, d, b_rows,
                             C::QROWS))
    return rc;
  if (int rc = wgs::make_map(&me, emb, false, d, n_rows, TILE)) return rc;
  mips_stream_bf16_kernel<PLANES, SMEM_LISTS>
      <<<dim3(static_cast<unsigned>(blocks)), wgs::THREADS, lay.smem,
         static_cast<cudaStream_t>(stream)>>>(
          mq0, mq1, me, src, b, d, n_rows, k, q_tiles, tiles_per_slice,
          lay.ring, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

template <int PLANES>
int launch_bf16_lists(const void* qh, const void* ql, const void* src,
                      const void* emb, int b, int d, int n_rows, int k,
                      int qpb, int tiles_per_slice, void* out_s, void* out_i,
                      void* stream) {
  long long blocks;
  int q_tiles;
  if (int rc = check(b, d, n_rows, k, qpb, tiles_per_slice,
                     wgs::Cfg<false, PLANES>::QROWS, &blocks, &q_tiles))
    return rc;
  const StreamLayout lay = stream_layout(PLANES, k, b);
  const auto* sr = static_cast<const int*>(src);
  if (lay.smem_lists)
    return launch_bf16<PLANES, true>(qh, ql, sr, emb, b, d, n_rows, k,
                                     q_tiles, blocks, tiles_per_slice, lay,
                                     out_s, out_i, stream);
  return launch_bf16<PLANES, false>(qh, ql, sr, emb, b, d, n_rows, k,
                                    q_tiles, blocks, tiles_per_slice, lay,
                                    out_s, out_i, stream);
}

}  // namespace

// Plain C entries for ctypes. qh, ql (ceil(b / 128) * 128, d) bf16 planes,
// the queries permuted within each tile of 128 (a null ql: one plane, a
// bf16 query) and src (ceil(b / 128) * 128,) int32 the caller's row of
// each, -1 for padding; q (b, d) f32; emb (n_rows, d) bf16 or f32; out_s,
// out_i (slices, b, k) with slices = ceil(ceil(n_rows / 256) /
// tiles_per_slice). All contiguous, 16-byte aligned, d % 16 == 0,
// 1 <= k <= min(n_rows, 32768), qpb = mips_stream_qpb(f32) (the Python
// wrapper checks). Each returns a cudaError_t (or 10000 + a refused TMA
// encode's CUresult), 0 on a clean launch.
extern "C" int mips_stream_bf16_launch(const void* qh, const void* ql,
                                       const void* src, const void* emb,
                                       int b, int d, int n_rows, int k,
                                       int qpb, int tiles_per_slice,
                                       void* out_s, void* out_i,
                                       void* stream) {
  if (ql == nullptr)
    return launch_bf16_lists<1>(qh, nullptr, src, emb, b, d, n_rows, k, qpb,
                                tiles_per_slice, out_s, out_i, stream);
  return launch_bf16_lists<2>(qh, ql, src, emb, b, d, n_rows, k, qpb,
                              tiles_per_slice, out_s, out_i, stream);
}

extern "C" int mips_stream_f32_launch(const void* q, const void* emb, int b,
                                      int d, int n_rows, int k, int qpb,
                                      int tiles_per_slice, void* out_s,
                                      void* out_i, void* stream) {
  long long blocks;
  int q_tiles;
  if (int rc = check(b, d, n_rows, k, qpb, tiles_per_slice, dense::TQ,
                     &blocks, &q_tiles))
    return rc;
  mips_stream_f32_kernel<<<dim3(static_cast<unsigned>(blocks)), F32_THREADS,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(emb), b, d,
      n_rows, k, q_tiles, tiles_per_slice, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// A block's shared memory for bf16 rows with `planes` query planes at k
// and batch b (stream_layout), or f32 rows (f32 = 1), and the queries a
// block takes: the wrapper's ops/mips_stream.py::stream_smem mirrors these
// (the card tests compare).
extern "C" int mips_stream_smem(int f32, int planes, int k, int b) {
  return f32 ? F32_SMEM : stream_layout(planes, k, b).smem;
}

extern "C" int mips_stream_qpb(int f32) {
  return f32 ? dense::TQ : wgs::Cfg<false, 1>::QROWS;
}

extern "C" int mips_stream_k_max() { return K_MAX; }
