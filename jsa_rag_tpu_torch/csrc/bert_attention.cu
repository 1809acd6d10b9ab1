// Fused attention for the BERT tower's forward without autograd, for Hopper
// (sm_90a): ctx = softmax(q k^T / sqrt(hd) + bias) v for every (sequence,
// head) of one layer, without the logits or the probabilities ever reaching
// device memory.
//
// It replaces no Pallas kernel: the JAX package's BERT attention
// (jsa_rag_tpu/models/bert.py) is plain XLA. The port's composed version
// (models/bert.py::_attention_plain) casts q and k to f32, permutes them,
// writes the (B, nh, S, S) f32 logits, scales them, adds the mask, runs a
// softmax over them, casts the probabilities and permutes v and the context:
// ~7 GB of device traffic a layer at B = 256, S = 192, and an f32 product on
// the SIMT path. This kernel reads q, k and v once and writes the context
// once.
//
// Bound (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16 dense), bge-large's layer at
// B = 256, S = 192, nh = 16, hd = 64: 4 B nh S^2 hd = 38.7 GFLOP (39 us)
// against 4 B S H 2 bytes = 403 MB (120 us) of q, k, v and the context:
// bytes bound, ~96 operations a byte against the card's ~295. So the design
// moves each byte once and keeps the products on the tensor cores:
//
// - one block (one warpgroup, 128 threads) per (sequence, head): the grid is
//   B x nh blocks, 4,096 at the rebuild's shape, three resident an SM;
// - the head's K and V (S x hd 16-bit, 24 KB each at S = 192) are staged
//   whole in shared memory, so they leave device memory once; the query
//   tiles of 64 rows follow, double-buffered (tile t + 1 loads while tile t
//   computes). The stage is cp.async 16-byte copies into wgmma's 128-byte
//   swizzle: the head's hd values sit at a row stride of H in the
//   projections' (B, S, H) outputs, read in place (no permute copies), and
//   rows of fewer than 64 values (hd < 64) are zero-padded in shared memory,
//   which a TMA box over the (B S, H) matrix would fill with the next head's
//   columns. When K and V do not fit beside the queries (hd > 64 with
//   S > 384) they stream through one 64-key stage instead, read again from
//   L2 for every query tile;
// - a 64-key chunk's logits: one wgmma m64n64k16 per 16 values of hd (A =
//   the query tile, B = the chunk's keys, both K-major from shared memory,
//   f32 sums of exact 16-bit products: the composed path's arithmetic), then
//   the logit times 1/sqrt(hd) and plus the f32 mask bias, each rounded as
//   the composed path rounds them (no fused multiply-add);
// - an online softmax in f32 over the chunks: the running row max and sum
//   live on the four threads that share a row; the context accumulator is
//   rescaled by exp(m_old - m_new) at each chunk;
// - P goes to 16 bits in registers and is wgmma's register A operand for
//   P.V (the f32 accumulator fragment of a 64 x 16 slice is laid out as the
//   A fragment of a k16 step), with V as the MN-major B from the same
//   swizzled stage (wgmma's transposed B), n64 per 64 values of hd;
// - the context is normalised by the row sum in f32 and stored in the
//   activation dtype, in the (B, S, H) layout the output projection reads.
//
// Every key is read, masked ones included: a mask bias of -1e9 gives those
// keys exp(-1e9 - m) = 0 beside a real key, and a row whose every key is
// masked (a padding passage) gets the composed path's uniform weights, not
// NaN. Keys past S in the last chunk (zero rows) are excluded with a bias of
// -inf. P is rounded to 16 bits before normalisation here and after it in the
// composed path, so the two agree to the 16-bit type's rounding.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "wgmma_scan.cuh"

namespace {

using wgs::align1024;
using wgs::fence_regs;
using wgs::FULL;
using wgs::smem_u32;
using wgs::sw128_desc;
using wgs::wg_commit;
using wgs::wg_fence;
using wgs::wg_wait;

constexpr int THREADS = 128;     // one warpgroup
constexpr int QT = 64;           // query rows a tile (wgmma's M)
constexpr int KC = 64;           // keys a chunk (the logits' N)
constexpr int ROWB = 128;        // bytes of a staged row: 64 16-bit values
constexpr int BLK = QT * ROWB;   // a query tile's column block: 8 KB
constexpr int SMEM_MAX = 232448;

// bytes of shared memory a block takes: the alignment slack, two query
// tiles, K and V of kv_rows rows each, the mask of sp keys
inline int smem_bytes(int cb, int sp, int kv_rows) {
  return 1024 + 2 * cb * BLK + 2 * cb * kv_rows * ROWB + sp * 4;
}

// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout
// type 1) of a byte offset from a 1024-byte-aligned base: the 16-byte unit
// within a 128-byte row XOR the row's place in its 8-row atom
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

// 16 bytes global -> shared; fewer source bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of an MN-major operand (V: keys along K, hd contiguous
// along N) in the 128-byte swizzle: 8 key rows of 128 bytes an atom, atoms
// 1024 bytes apart along K. An n64 product spans one atom along N, so the
// stride between atoms along N is never used; both offsets are set to 1024
// bytes, which is the K stride whichever of the two fields the unit reads
// for it.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | ((1024ull >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

// m64n64k16, f32 += A (smem, K-major) x B (smem, K-major); d[i] sits at row
// 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2
template <bool F16>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db) {
  if constexpr (F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
}

// m64n64k16, f32 += A (registers: a[0..3], two 16-bit values each, the
// fragment of mma_ss's d over 16 columns) x B (smem, MN-major: transposed)
template <bool F16>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db) {
  if constexpr (F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// two floats -> one register of two 16-bit values, the first in the low half
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// Rows [r0, r0 + n) of one head (src: its row 0, rows H values apart) into
// dst: CB column blocks of 64 values, `blk` bytes apart, row r0 + r at
// 128 r bytes of each, swizzled. Rows at or past s_len and values at or past
// hd are zero-filled.
template <int CB>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int blk,
                                           const uint16_t* src, int H, int r0,
                                           int n, int s_len, int hd) {
  constexpr int CH = CB * 8;  // 16-byte units a row
  const uint32_t base = smem_u32(dst);
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    const int row = r0 + r, col = ch * 8;
    const bool ok = row < s_len && col < hd;
    const uint16_t* g = src + (ok ? static_cast<size_t>(row) * H + col : 0);
    cp_async16(base + (ch >> 3) * blk + swz(r * ROWB + (ch & 7) * 16), g,
               ok ? 16 : 0);
  }
}

// q, k, v: (B, S, H) 16-bit, head h's values at columns [h hd, (h+1) hd);
// bias: (B, S) f32, added to every query row's logits; out: (B, S, H).
// kv_rows: S rounded up to 64 (K and V resident) or 64 (streamed).
template <bool F16, int CB>
__global__ void __launch_bounds__(THREADS)
bert_attention_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const float* __restrict__ bias,
                      uint16_t* __restrict__ out, int s_len, int nh, int hd,
                      int H, float scale, int kv_rows) {
  extern __shared__ unsigned char smem_raw[];
  const float neg_inf = __int_as_float(0xff800000);
  unsigned char* sq = align1024(smem_raw);  // two query tiles
  const int sp = (s_len + KC - 1) / KC * KC;
  const bool resident = kv_rows >= sp;
  const int kblk = kv_rows * ROWB;  // a column block of K or V
  unsigned char* sk = sq + 2 * CB * BLK;
  unsigned char* sv = sk + CB * kblk;
  float* sb = reinterpret_cast<float*>(sv + CB * kblk);
  const int seq = blockIdx.x / nh, head = blockIdx.x % nh;
  const size_t off =
      static_cast<size_t>(seq) * s_len * H + static_cast<size_t>(head) * hd;
  const uint16_t* qh = q + off;
  const uint16_t* kh = k + off;
  const uint16_t* vh = v + off;

  for (int i = threadIdx.x; i < sp; i += THREADS)
    sb[i] = i < s_len ? bias[static_cast<size_t>(seq) * s_len + i] : neg_inf;
  // groups: query tile 0 with K, then V, then query tile 1
  const int n_qt = sp / QT, n_kc = sp / KC;
  stage_rows<CB>(sq, BLK, qh, H, 0, QT, s_len, hd);
  if (resident) stage_rows<CB>(sk, kblk, kh, H, 0, sp, s_len, hd);
  cp_commit();
  if (resident) stage_rows<CB>(sv, kblk, vh, H, 0, sp, s_len, hd);
  cp_commit();
  if (n_qt > 1) stage_rows<CB>(sq + CB * BLK, BLK, qh, H, QT, QT, s_len, hd);
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = 0; t < n_qt; ++t) {
    if (t == 0)
      cp_wait<2>();  // query tile 0 and K
    else
      cp_wait<0>();  // query tile t
    fence_async_smem();
    __syncthreads();  // every thread's copies landed; tile t - 1 is done
    if (t >= 1) {     // its buffer takes tile t + 1
      if (t + 1 < n_qt)
        stage_rows<CB>(sq + ((t + 1) & 1) * CB * BLK, BLK, qh, H,
                       (t + 1) * QT, QT, s_len, hd);
      cp_commit();
    }
    const unsigned char* st = sq + (t & 1) * CB * BLK;
    float o[CB][32];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
    }
    float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
    for (int c = 0; c < n_kc; ++c) {
      int kr = c * KC;  // the chunk's first row in the K and V stages
      if (!resident) {
        __syncthreads();  // the last chunk's products are done everywhere
        stage_rows<CB>(sk, kblk, kh, H, c * KC, KC, s_len, hd);
        stage_rows<CB>(sv, kblk, vh, H, c * KC, KC, s_len, hd);
        cp_commit();
        cp_wait<0>();
        fence_async_smem();
        __syncthreads();
        kr = 0;
      }
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const uint64_t da = sw128_desc(st + cb * BLK);
        const uint64_t db = sw128_desc(sk + cb * kblk + kr * ROWB);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +32 bytes a k16 step
          mma_ss<F16>(s, da + 2 * kk, db + 2 * kk);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(s);

      // the chunk's logits as the composed path rounds them, the row max
      // over the four threads of a row
      const float* bc = sb + c * KC + 2 * (lane & 3);
      float mx[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = __fadd_rn(__fmul_rn(s[i], scale), bc[8 * (i >> 2) + (i & 1)]);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        corr[h] = __expf(m[h] - mn);  // 0 at the first chunk
        m[h] = mn;
      }
      // P: register r of k-step j holds s[8j + 2r], s[8j + 2r + 1]: rows
      // (r odd: + 8), columns 16j + 2(lane%4) (r >= 2: + 8), the A
      // fragment of wgmma's m64k16
      uint32_t pa[16];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const float p0 = __expf(s[i] - m[h]), p1 = __expf(s[i + 1] - m[h]);
        ls[h] += p0 + p1;
        pa[i >> 1] = pack2<F16>(p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cb][i] *= corr[(i >> 1) & 1];
      }
      if (resident && t == 0 && c == 0) {
        cp_wait<1>();  // V
        fence_async_smem();
        __syncthreads();
      }
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(o[cb]);
      wg_fence();
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
          mma_rs<F16>(o[cb], pa + 4 * j,
                      sw128_mn_desc(sv + cb * kblk + (kr + 16 * j) * ROWB));
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(o[cb]);
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      inv[h] = 1.f / sum;
    }
    const int row0 = t * QT + 16 * warp + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= s_len) continue;
      uint16_t* orow = out + off + static_cast<size_t>(row) * H;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * 64 + 8 * j + 2 * (lane & 3);
          if (col < hd)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack2<F16>(o[cb][4 * j + 2 * h] * inv[h],
                           o[cb][4 * j + 2 * h + 1] * inv[h]);
        }
      }
    }
  }
}

template <bool F16, int CB>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int batch, int s_len, int nh, int hd, int H,
           float scale, cudaStream_t stream) {
  // once per process and instance (a thread-safe static): the port drives
  // one card
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bert_attention_kernel<F16, CB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(bert_attention_kernel<F16, CB>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int sp = (s_len + KC - 1) / KC * KC;
  int kv_rows = sp;
  if (smem_bytes(CB, sp, kv_rows) > SMEM_MAX) kv_rows = KC;
  const int smem = smem_bytes(CB, sp, kv_rows);
  const long long blocks = static_cast<long long>(batch) * nh;
  if (smem > SMEM_MAX || blocks < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bert_attention_kernel<F16, CB>
      <<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
          static_cast<const uint16_t*>(v), static_cast<const float*>(bias),
          static_cast<uint16_t*>(out), s_len, nh, hd, H, scale, kv_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. q, k, v, out: (batch, s_len, H) bf16 or fp16
// (f16 != 0), contiguous, 16-byte aligned, H = nh * hd; bias: (batch, s_len)
// f32; hd a multiple of 16 in [16, 128]; scale = 1 / sqrt(hd) in f32 (the
// Python wrapper checks). Returns a cudaError_t, 0 on a clean launch.
extern "C" int bert_attention_launch(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* out, int batch, int s_len, int nh,
                                     int hd, int H, int f16, float scale,
                                     void* stream) {
  if (hd < 16 || hd > 128 || hd % 16 != 0 || s_len < 1 || H != nh * hd)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (f16) {
    if (hd <= 64)
      return launch<true, 1>(q, k, v, bias, out, batch, s_len, nh, hd, H,
                             scale, st);
    return launch<true, 2>(q, k, v, bias, out, batch, s_len, nh, hd, H, scale,
                           st);
  }
  if (hd <= 64)
    return launch<false, 1>(q, k, v, bias, out, batch, s_len, nh, hd, H,
                            scale, st);
  return launch<false, 2>(q, k, v, bias, out, batch, s_len, nh, hd, H, scale,
                          st);
}

// Whether K and V of a head stay resident for the whole block (1) or stream
// through one 64-key stage (0) at s_len and hd; -1 where no block fits.
extern "C" int bert_attention_resident(int s_len, int hd) {
  const int cb = hd <= 64 ? 1 : 2;
  const int sp = (s_len + KC - 1) / KC * KC;
  if (smem_bytes(cb, sp, sp) <= SMEM_MAX) return 1;
  return smem_bytes(cb, sp, KC) <= SMEM_MAX ? 0 : -1;
}
