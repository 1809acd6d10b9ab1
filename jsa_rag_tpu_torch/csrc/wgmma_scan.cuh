// The scans' scoring core for Hopper (sm_90a), shared by topt_dense.cu
// (kernels B3-B7, 16-bit rows), topt_int8r2.cu (kernels B1, B2 and B8,
// int8 rows), each ending in the per-tile top-T emit, and mips_stream.cu
// (kernel B9, the exact streaming top-k).
//
// One block runs three roles: a producer warp that streams tiles of the
// query planes and of the index through a ring of shared-memory stages with
// TMA (cp.async.bulk.tensor, 2-D, 128-byte swizzle, one mbarrier pair a
// stage), and two consumer warpgroups that multiply them with
// wgmma.mma_async (both operands from shared memory). A stage row is 128
// bytes of d whatever the element: 64 bf16 / fp16 values or 128 int8 ones,
// and a wgmma k-step is 32 bytes of it (k16 at 16 bits, k32 at 8), so the
// descriptors, the swizzle and the ring are the same for both widths. A
// unit of work is (a tile of QROWS query rows, a tile of TILE = 256 index
// rows), the whole of d; a block walks its units in order and the producer
// runs ahead across unit boundaries, so a unit's epilogue (the emit, or
// B9's merge) overlaps the next unit's loads.
//
// Operand roles: the queries are wgmma's A (m64, 64 query rows a
// warpgroup) and the index tile is B (n256: 256 index rows), both K-major
// as stored (row-major (rows, d); 8-bit operands must be K-major). One
// index tile in shared memory then serves 128 queries (64 with two
// accumulators), and each thread ends a unit holding 2 query rows x 64 of
// the 256 columns, so the per-row top-T runs in registers on the thread
// quads that share a row. The other orientation (index rows on M) would
// need the (queries x 256) score tile in shared memory for the per-row
// emit: 128 KB at 128 queries.
//
// Precision: each wgmma product of two 16-bit values is exact in f32, the
// sums are f32; int8 products sum exactly in s32 (|127 * 127 * d| < 2^31 up
// to d ~ 133k). Accumulators:
//   bf16 rows, one plane (a bf16 query): acc = q.x exactly summed in f32;
//   bf16 rows, two planes (the hi/lo split of an f32 query): hi.x and lo.x
//     accumulate into ONE accumulator, k16 step by k16 step (both products
//     exact, only the order of the f32 sums differs from hi.x + lo.x);
//   fp16 rows, one plane (B4): acc = q_h.x, times the row's 1/s;
//   fp16 rows, two planes (B5): q_l carries a 2^-11 weight, so it keeps its
//     own accumulator: (acc_h + 2^-11 acc_l) / s. Two accumulators of n256
//     do not fit the registers, so each warpgroup takes 128 of the 256
//     columns (n128) of the same 64 queries, and warpgroup 1 hands its
//     scores to warpgroup 0 through shared memory for the emit;
//   int8 rows (CfgS8): one s32 accumulator of n256 over one A plane. B1's
//     two query planes are interleaved into that plane by 8-row groups, so
//     a thread's two rows are the two planes of one query (topt_int8r2.cu).

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "topt_emit.cuh"

namespace wgs {

using topt::NEG_INF;

constexpr int TILE = 256;                // index rows a unit (wgmma's N)
constexpr int ROW = 128;                 // bytes of d a stage
constexpr int KC = 64;                   // 16-bit elements of d a stage
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr float LO_WEIGHT = 0.00048828125f;  // 2^-11, the fp16 lo plane's
constexpr unsigned FULL = 0xffffffffu;

constexpr int MAX_STAGES = 8;
constexpr int BARS = 1024;  // 2 * MAX_STAGES mbarriers, padded to 1024

// a 16-bit instance: bf16 rows, or fp16 (F16) ones
template <bool F16, int PLANES>
struct Cfg {
  static constexpr bool S8 = false;
  using Acc = float;
  static constexpr int KE = KC;  // elements of d a stage
  static constexpr int ACCS = (F16 && PLANES == 2) ? 2 : 1;
  static constexpr int QROWS = ACCS == 1 ? 128 : 64;  // query rows a unit
  static constexpr int NW = TILE / ACCS;  // index columns a warpgroup
  static constexpr int A_BYTES = QROWS * ROW;  // one full query plane
  static constexpr int B_BYTES = TILE * ROW;
  static constexpr int STAGE = PLANES * A_BYTES + B_BYTES;
  static constexpr int XBUF = ACCS == 2 ? 64 * 128 * 4 : 0;  // wg 1 -> 0
  // the dense kernels' ring: as many full stages as fit a block's shared
  // memory (232,448 bytes) beside the rest, at most 4; a batch smaller
  // than a tile fits more, shorter ones (carve)
  static constexpr int RING =
      ((232448 - BARS - XBUF - 1024) / STAGE < 4
           ? (232448 - BARS - XBUF - 1024) / STAGE
           : 4) * STAGE;
  // +1024: the swizzled stages need 1024-byte alignment
  static constexpr int SMEM = BARS + RING + XBUF + 1024;
};

// The int8 instance: int8 rows, one A plane of 128 rows (B2's 128 queries,
// or B1's 64 queries' two planes interleaved), one s32 accumulator. A
// stage is half a 16-bit one's bytes per element of d, so the ring takes
// all the shared memory beside the barriers and the row scales' buffers:
// 4 full stages, or up to 6 short ones for a batch within one tile.
struct CfgS8 {
  static constexpr bool S8 = true;
  using Acc = int;
  static constexpr int KE = ROW;  // elements of d a stage
  static constexpr int ACCS = 1;
  static constexpr int QROWS = 128;  // A rows a unit
  static constexpr int NW = TILE;
  static constexpr int A_BYTES = QROWS * ROW;
  static constexpr int B_BYTES = TILE * ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the row scales of SIDE units in flight, TMA'd beside the stages
  static constexpr int SIDE = 4;
  static constexpr int SIDE_BYTES = SIDE * TILE * 4;
  static constexpr int RING = 232448 - BARS - SIDE_BYTES - 1024;
  static constexpr int SMEM = BARS + RING + SIDE_BYTES + 1024;
};

// A stage holds PLANES query boxes of qbox rows, each rounded up to 1024
// bytes, then the index tile: its bytes.
__host__ __device__ inline int stage_bytes(int planes, int qbox) {
  return planes * ((qbox * ROW + 1023) / 1024 * 1024) + TILE * ROW;
}

// How many stages ring_bytes hold, at most MAX_STAGES.
__host__ __device__ inline int ring_depth(int ring_bytes, int stride) {
  const int n = ring_bytes / stride;
  return n < MAX_STAGES ? n : MAX_STAGES;
}

// ------------------------------------------------------------- PTX pieces
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// box (KC elements of d, box rows) at element (c0 along d, c1 along rows);
// rows and columns past the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// a box of n 4-byte elements at element c0 of a 1-D map; elements past
// the tensor arrive as zeros
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows as TMA's 128-byte
// swizzle leaves it: 8-row atoms 1024 bytes apart (the stride byte offset),
// the leading byte offset unused, layout type 1 (128B swizzle). A k16 step
// inside the 128-byte row adds 32 bytes to the start address (2 in its
// 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// m64nNk16, f32 += A (smem, K-major) x B (smem, K-major); one thread's
// N/2 accumulators: d[i] sits at row 16*warp + lane/4 + 8*((i/2)%2) and
// column 8*(i/4) + 2*(lane%4) + i%2 of the warpgroup's 64 x N tile
__device__ __forceinline__ void wgmma_n256_bf16(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256_f16(float (&d)[128], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128_f16(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n256k32, s32 += A (smem, K-major s8) x B (smem, K-major s8): the
// integer form takes only scale-d (no scale or transpose immediates, both
// operands K-major); its s32 fragment layout is the f32 one above
__device__ __forceinline__ void wgmma_n256_s8(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
        "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
        "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
        "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
        "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------ the pipeline
// Units u = u0, u0 + step, ... < u1 each stand for (query tile u % q_tiles,
// index tile u / q_tiles); both roles walk the same sequence.
struct Units {
  long long u0, u1, step;
  int q_tiles;
};

struct Ring {
  unsigned char* stages;
  uint64_t* full;   // count 1: the producer's expect_tx, then TMA's bytes
  uint64_t* empty;  // count CONSUMERS: every consumer thread releases
  int n;            // stages
  int plane;        // bytes of a query plane's box in a stage
  int stride;       // bytes of a stage
};

// The 1024-byte-aligned layout: the barriers (BARS bytes), then as many
// stages of qbox query rows as ring_bytes hold; the caller's own buffers
// follow at stages + ring_bytes.
template <int PLANES>
__device__ __forceinline__ Ring carve(unsigned char* smem_raw, int ring_bytes,
                                      int qbox) {
  unsigned char* base = align1024(smem_raw);
  auto* full = reinterpret_cast<uint64_t*>(base);
  const int stride = stage_bytes(PLANES, qbox);
  return Ring{base + BARS,
              full,
              full + MAX_STAGES,
              ring_depth(ring_bytes, stride),
              (qbox * ROW + 1023) / 1024 * 1024,
              stride};
}

// Thread 0 initialises the barriers; the caller follows with
// __syncthreads().
__device__ __forceinline__ void init_ring(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.n; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
}

// What the 16-bit scans' stages hold: PLANES query boxes of qbox rows at
// the unit's first query row, then the index tile. The barrier counts the
// whole boxes' bytes, zero-filled parts included; the query box may hold
// fewer than QROWS rows (qbox: a batch smaller than a tile), and a
// warpgroup's rows past it then read other bytes of the stage, which only
// reach rows past b.
template <class C, int PLANES>
struct PlaneLoads {
  const CUtensorMap *mq0, *mq1, *me;
  int qbox;
  __device__ uint32_t bytes() const { return PLANES * qbox * ROW + C::B_BYTES; }
  // nothing beside the stages
  __device__ void unit(long long, int) const {}
  __device__ void stage(unsigned char* st, int plane, uint64_t* bar, int kc,
                        int q0, int n0) const {
    tma_load(st, mq0, bar, kc * C::KE, q0);
    if constexpr (PLANES == 2) tma_load(st + plane, mq1, bar, kc * C::KE, q0);
    tma_load(st + PLANES * plane, me, bar, kc * C::KE, n0);
  }
};

// The producer (one thread): for every unit, loads.unit(i, n0) (what the
// unit's epilogue reads beside the stages; i: the unit's place in this
// block's walk, n0: its first index row), then ceil(d / C::KE) stages,
// each loads.stage(...) at A row q0 and index row n0, counted as
// loads.bytes() on the stage's full barrier.
template <class C, class Loads>
__device__ __forceinline__ void produce(const Ring& r, const Loads& loads,
                                        int n_k, const Units& w) {
  const uint32_t bytes = loads.bytes();
  int s = 0;
  uint32_t ph = 0;
  long long i = 0;
  for (long long u = w.u0; u < w.u1; u += w.step, ++i) {
    const int q0 = static_cast<int>(u % w.q_tiles) * C::QROWS;
    const int n0 = static_cast<int>(u / w.q_tiles) * TILE;
    loads.unit(i, n0);
    for (int kc = 0; kc < n_k; ++kc) {
      mbar_wait(&r.empty[s], ph ^ 1u);
      mbar_expect_tx(&r.full[s], bytes);
      loads.stage(r.stages + s * r.stride, r.plane, &r.full[s], kc, q0, n0);
      if (++s == r.n) {
        s = 0;
        ph ^= 1u;
      }
    }
  }
}

template <bool F16, int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (N == 256) {
    if constexpr (F16)
      wgmma_n256_f16(d, da, db);
    else
      wgmma_n256_bf16(d, da, db);
  } else {
    static_assert(F16 && N == 128, "n128 is the fp16 two-accumulator shape");
    wgmma_n128_f16(d, da, db);
  }
}

// One consumer warpgroup's product for one unit, over the ring from stage
// (s, ph) on: acc[a] (a < ACCS) = the warpgroup's 64 query rows against its
// NW index columns (f32 sums of 16-bit products, or s32 sums of int8 ones
// for CfgS8; F16 picks fp16 over bf16 and is unused there). A warpgroup
// whose queries all lie past b (`active` false) waits and releases the
// stages without multiplying.
template <bool F16, int PLANES, class C>
__device__ __forceinline__ void mma_unit(
    typename C::Acc (&acc)[C::ACCS][C::NW / 2], const Ring& r, int& s,
    uint32_t& ph, int n_k, int wg, bool active) {
#pragma unroll
  for (int a = 0; a < C::ACCS; ++a) {
#pragma unroll
    for (int i = 0; i < C::NW / 2; ++i) acc[a][i] = 0;
    fence_regs(acc[a]);
  }
  const int a_off = C::ACCS == 1 ? wg * 64 * ROW : 0;
  const int b_off = PLANES * r.plane + (C::ACCS == 2 ? wg * 128 * ROW : 0);
  int prev = -1;
  for (int kc = 0; kc < n_k; ++kc) {
    mbar_wait(&r.full[s], ph);
    if (active) {
      const unsigned char* st = r.stages + s * r.stride;
      const uint64_t da0 = sw128_desc(st + a_off);
      const uint64_t da1 = sw128_desc(st + r.plane + a_off);
      const uint64_t db = sw128_desc(st + b_off);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < ROW / 32; ++kk) {  // +32 bytes a k-step
        if constexpr (C::S8) {
          wgmma_n256_s8(acc[0], da0 + 2 * kk, db + 2 * kk);
        } else if constexpr (C::ACCS == 2) {
          mma<F16, C::NW>(acc[0], da0 + 2 * kk, db + 2 * kk);
          mma<F16, C::NW>(acc[C::ACCS - 1], da1 + 2 * kk, db + 2 * kk);
        } else {
          mma<F16, C::NW>(acc[0], da0 + 2 * kk, db + 2 * kk);
          if constexpr (PLANES == 2)
            mma<F16, C::NW>(acc[0], da1 + 2 * kk, db + 2 * kk);
        }
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done
    }
    if (prev >= 0) mbar_arrive(&r.empty[prev]);
    prev = s;
    if (++s == r.n) {
      s = 0;
      ph ^= 1u;
    }
  }
  if (active) wg_wait<0>();
  if (prev >= 0) mbar_arrive(&r.empty[prev]);
#pragma unroll
  for (int a = 0; a < C::ACCS; ++a) fence_regs(acc[a]);
}

// The per-tile top-T of one warp's query rows from the registers. With
// R = 128 (two rows a thread): v[i] holds row (lane/4 + 8h) at column
// 8j + 2*(lane%4) + e of the unit's 256, i = 4j + 2h + e; with R = 64 (one
// row a thread, B1's interleaved planes): row lane/4 at i = 2j + e. Scores
// already masked; the emit tile is the columns with j0 <= j < j1. T
// extract-max passes per row on the row's thread quad: first the thread's
// own best (columns ascend with i, so ">" keeps the first), then the
// quad's, ties to the lower column (topt_emit.cuh's order); id -1 once the
// tile has no scorable column.
// q_row: the query of h = 0, rows at or past b are not written; out index
// ((nt_out * b + q) * t_per_tile + t); ids n0 + column.
template <int R>
__device__ __forceinline__ void emit_quads(float (&v)[R], int j0, int j1,
                                           int q_row, int b, int n0,
                                           long long nt_out, int t_per_tile,
                                           float* __restrict__ out_s,
                                           int* __restrict__ out_i) {
  static_assert(R == 128 || R == 64, "two rows a thread, or one");
  constexpr int H = R / 64;  // rows a thread holds
  const int lane = threadIdx.x & 31, tig = lane & 3;
  for (int t = 0; t < t_per_tile; ++t) {
    const float below = __int_as_float(0xff800000);  // -inf < NEG_INF
    float bv[H];
    int bc[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      bv[h] = below;
      bc[h] = TILE;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = i / (2 * H), h = (i >> 1) % H, e = i & 1;
      if (j >= j0 && j < j1 && v[i] > bv[h]) {
        bv[h] = v[i];
        bc[h] = 8 * j + 2 * tig + e;
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(FULL, bv[h], off);
        const int oc = __shfl_xor_sync(FULL, bc[h], off);
        if (ov > bv[h] || (ov == bv[h] && oc < bc[h])) {
          bv[h] = ov;
          bc[h] = oc;
        }
      }
      const int q = q_row + 8 * h;
      if (tig == 0 && q < b) {
        const size_t o = ((size_t)nt_out * b + q) * t_per_tile + t;
        out_s[o] = bv[h];
        out_i[o] = bv[h] > NEG_INF * 0.5f ? n0 + bc[h] : -1;
      }
    }
    // the owner clears the emitted column
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = i / (2 * H), h = (i >> 1) % H, e = i & 1;
      if (bc[h] == 8 * j + 2 * tig + e) v[i] = NEG_INF;
    }
  }
}

// --------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The query rows a unit's TMA box takes: a whole tile, or for a batch
// within one tile its rows rounded up to 8 (the stage's other rows are not
// loaded at all).
inline int query_box(int b, int qrows) {
  return b >= qrows ? qrows : (b + 7) / 8 * 8;
}

// The TMA map of a row-major (rows, d) matrix of `type` elements of
// elem_bytes, boxes of (ROW bytes of d, box_rows) under the 128-byte
// swizzle. -> 0, or a non-zero code: cudaErrorNotSupported without the
// entry point, 10000 + the CUresult of a refused encode.
inline int make_map_of(CUtensorMap* m, const void* base,
                       CUtensorMapDataType type, int elem_bytes, int d,
                       long long rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(m, type, 2, const_cast<void*>(base), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// a 16-bit matrix: fp16 (f16) or bf16
inline int make_map(CUtensorMap* m, const void* base, bool f16, int d,
                    long long rows, int box_rows) {
  return make_map_of(m, base,
                     f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     2, d, rows, box_rows);
}

// a 1-D f32 vector of n elements, boxes of box elements, no swizzle
inline int make_map_1d_f32(CUtensorMap* m, const void* base, long long n,
                           int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};  // unused
  const cuuint32_t boxd[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem[1] = {1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
         strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// an int8 matrix (TMA moves it as bytes)
inline int make_map_s8(CUtensorMap* m, const void* base, int d,
                       long long rows, int box_rows) {
  return make_map_of(m, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, d, rows,
                     box_rows);
}

inline int sm_count(int* sms) {
  int dev;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

}  // namespace wgs
