// Tensor-core attention core shared by the bf16 prefill kernels K2
// (flash_prefill_tc.cu) and K3 (paged_prefill_tc.cu), sm_90a.
//
// One block owns 64 queries of one (row, head); its four warps are one
// warpgroup, and warp w holds query rows 16w .. 16w + 15 in registers.
// Per key tile of BK keys:
//   * S = Q.K^T on the tensor cores: wgmma m64nBKk16, Q and K read from
//     shared memory (both K-major), bf16 in, f32 accumulators;
//   * scale, the optional tanh softcap (before the mask), then the
//     causal / length / window mask, applied only on tiles that cross a
//     frontier: interior tiles run unmasked;
//   * the online softmax in f32 registers, the running max seeded at
//     -1e30 as in the TPU kernel; the row sums stay per thread until the
//     end;
//   * P rounded to bf16 in registers (the TPU kernel rounds the
//     probabilities to the value dtype before P.V): the S accumulators
//     are, element for element, wgmma's register A fragment; then
//     O += P.V with wgmma m64nDk16, V read from its [key, d] rows in
//     shared memory under the transpose flag.
// The epilogue divides by the row sum and stores bf16 rows through
// shared memory as 16-byte words; query rows past the valid run are
// zeros.
//
// K/V tiles reach shared memory through a producer (the kernel's only
// difference): a two-stage ring of 16-byte cp.async copies, tile j + 1
// in flight while tile j is multiplied. Rows past the live range are
// zero-filled by the copy itself (src-size 0), so masked probabilities
// (exact zeros) never meet stale shared memory. A 1-byte (e5m2) pool is
// copied raw into the ring and widened to bf16 in shared memory before
// the products (exact: every e5m2 value is a bf16 value).
//
// Shared tiles hold D / 64 column blocks of [rows][64] bf16 (128-byte
// rows) with the 16-byte chunk index XORed with row % 8: the 128-byte
// swizzle that wgmma's descriptors name, on 1,024-byte aligned blocks.
//
// An mma.sync m16n8k16 + ldmatrix build of the same kernels, run in turns
// with this one on an H100 at chip_smoke.py's phase-2 shapes, was slower
// on every K2 and K3 case (PERF.md, section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // queries per block
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // running-max seed, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Keys per tile: 64 at head_dim 64 / 128; 32 at 256, where the O
// accumulator alone takes 128 registers a thread. Two ring stages: a
// third (tried at d = 128, where two blocks still share an SM) was no
// faster, so the copies are not what bounds these kernels.
template <int D>
struct Tile {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr size_t kQBytes = (size_t)kBQ * D * sizeof(bf16);
  static constexpr size_t kKVBytes = (size_t)BK * D * sizeof(bf16);  // one K or V tile
};

// Dynamic shared memory of a block: the Q tile, the ring (K then V per
// stage, in the pool's element width), the widened K/V tiles of a 1-byte
// pool; the producer's own bytes follow at tile_bytes(). The kernels
// declare it aligned to 1,024 bytes, the swizzle's period, so a tile
// address's bits 7-9 are its row % 8.
template <int D>
__host__ __device__ constexpr size_t tile_bytes(int kv_bytes) {
  return Tile<D>::kQBytes + Tile<D>::kStages * 2 * (size_t)Tile<D>::BK * D * kv_bytes +
         (kv_bytes == 1 ? 2 * Tile<D>::kKVBytes : 0);
}

// Element offset of (row, col) in a swizzled bf16 tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * (ROWS * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) +
         (col & 7);
}

// 16 bytes global -> shared, asynchronous; zeros when !pred (nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two e5m2 bytes (low byte first) -> two bf16. Each byte is the top byte
// of an fp16, and every fp16 with e5m2's two mantissa bits is a bf16.
__device__ __forceinline__ uint32_t e5m2x2_to_bf16x2(uint32_t two) {
  const uint32_t h2 = ((two & 0xFFu) << 8) | ((two & 0xFF00u) << 16);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return pack_bf16(f.x, f.y);
}

// Widen one ring stage of raw e5m2 K and V tiles ([BK][D] bytes each) into
// the swizzled bf16 tiles at `dst` (K, then V).
template <int D>
__device__ __forceinline__ void widen_e5m2(const uint8_t* raw, bf16* dst) {
  constexpr int BK = Tile<D>::BK;
  constexpr int kChunks = D / 16;  // 16-byte chunks of a raw row
#pragma unroll
  for (int it = 0; it < 2 * BK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int tile = i / (BK * kChunks), rem = i % (BK * kChunks);
    const int r = rem / kChunks, c = rem % kChunks;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + (size_t)tile * BK * D + r * D + c * 16);
    const uint4 lo = make_uint4(e5m2x2_to_bf16x2(w.x), e5m2x2_to_bf16x2(w.x >> 16),
                                e5m2x2_to_bf16x2(w.y), e5m2x2_to_bf16x2(w.y >> 16));
    const uint4 hi = make_uint4(e5m2x2_to_bf16x2(w.z), e5m2x2_to_bf16x2(w.z >> 16),
                                e5m2x2_to_bf16x2(w.w), e5m2x2_to_bf16x2(w.w >> 16));
    bf16* t = dst + (size_t)tile * BK * D;
    *reinterpret_cast<uint4*>(t + swz<BK>(r, c * 16)) = lo;
    *reinterpret_cast<uint4*>(t + swz<BK>(r, c * 16 + 8)) = hi;
  }
}

// S = Q K^T and O += P V with wgmma: the block's four warps are one
// warpgroup, which issues each product of the 64-row tile at once. Q and
// K are K-major (rows [., d]) and V MN-major ([key, d], the transpose
// flag) in the swizzled tiles; P comes from registers. Descriptor: start
// address, leading and stride byte offsets (16-byte units), 128-byte
// swizzle. Shared tiles written by threads are fenced to the async proxy
// that wgmma reads through.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The instructions, one per shape (S: n = BK; O: n = D). scale_d = 0
// overwrites the accumulators; P.V always accumulates (trans-b = 1).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
struct Wgmma {
  static constexpr int BK = Tile<D>::BK;
  __device__ static void after_smem_writes() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __device__ static void qk(float (&s)[BK / 8][4], const bf16* q_s, const bf16* kt) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 16 of d: 32 bytes into a 128-byte row
      const uint64_t da = gmma_desc(q_s + (kk >> 2) * kBQ * 64 + (kk & 3) * 16, 16, 1024);
      const uint64_t db = gmma_desc(kt + (kk >> 2) * BK * 64 + (kk & 3) * 16, 16, 1024);
      if constexpr (BK == 64) {
        wgmma_ss_n64(s, da, db, kk > 0);
      } else {
        wgmma_ss_n32(s, da, db, kk > 0);
      }
    }
    wgmma_commit_wait();
  }
  __device__ static void pv(float (&o)[D / 8][4], const uint32_t (&p)[BK / 16][4],
                            const bf16* vt) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys: 16 rows of each 64-column block
      const uint64_t db = gmma_desc(vt + kk * 16 * 64, BK * 128, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64(o, p[kk], db);
      } else if constexpr (D == 128) {
        wgmma_rs_n128(o, p[kk], db);
      } else {
        wgmma_rs_n256(o, p[kk], db);
      }
    }
    wgmma_commit_wait();
  }
};

// Where a block's queries sit and which keys are live for them.
struct Frontier {
  long long qbase;  // absolute position of query row 0
  int n_q;  // valid query rows: a leading run, 0..kBQ
  long long k_lo, k_hi;  // live keys [k_lo, k_hi)
  long long window;  // key kpos is seen by query qpos iff qpos - window < kpos <= qpos
};

// The attention of one 64-query tile.
//   q_rows: query row 0 of this tile and head; row r at q_rows + r * q_st.
//   out_rows: output row 0; o_st its row stride; out_n rows exist there.
//   src: the K/V producer, with
//     prime(k0)                 the first S tiles' addressing (before any issue),
//     issue(stage, slot, k0)    cp.async of the keys [k0, k0 + BK) into `stage`,
//     fetch(k0) -> int          addressing of the tile S ahead, started early,
//     publish(slot, k0, x)      and stored after the products
//   (S = Tile<D>::kStages; tile j uses ring stage and slot j % S).
//   smem: the block's shared memory, 1,024-byte aligned.
template <int D, bool kWiden, class Src>
__device__ __forceinline__ void attend(char* smem, const bf16* q_rows, long long q_st,
                                       const Frontier& f, float scale, float softcap,
                                       Src& src, bf16* out_rows, long long o_st, int out_n) {
  constexpr int BK = Tile<D>::BK;
  constexpr int S = Tile<D>::kStages;
  constexpr int kStageBytes = 2 * BK * D * (kWiden ? 1 : 2);  // K and V of one ring stage
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  char* ring = smem + Tile<D>::kQBytes;
  bf16* wide = reinterpret_cast<bf16*>(ring + S * kStageBytes);  // kWiden only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

#pragma unroll
  for (int it = 0; it < kBQ * (D / 8) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < f.n_q;
    cp_async16(q_s + swz<kBQ>(r, c * 8), q_rows + (ok ? r * q_st + c * 8 : 0), ok);
  }
  const long long span = f.k_hi - f.k_lo;
  const int n_tiles = f.n_q > 0 && span > 0 ? (int)((span + BK - 1) / BK) : 0;
  if (n_tiles > 0) {
    src.prime(f.k_lo);
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {  // tiles 0 .. S - 2, one group each (Q in the first)
    if (t < n_tiles) src.issue(ring + t * kStageBytes, t, f.k_lo + (long long)t * BK);
    cp_async_commit();
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;  // this thread's share of their sums
  const int g = lane >> 2, t4 = lane & 3;
  const long long qp0 = f.qbase + warp * 16 + g, qp1 = qp0 + 8;
  const long long q_last = f.qbase + f.n_q - 1;

  for (int j = 0; j < n_tiles; ++j) {
    const long long k0 = f.k_lo + (long long)j * BK;
    const int next = (j + S - 1) % S;
    if (j + S - 1 < n_tiles) src.issue(ring + next * kStageBytes, next, k0 + (S - 1) * BK);
    cp_async_commit();
    const int ahead = src.fetch(k0 + S * BK);
    cp_async_wait<S - 1>();  // tile j's group is complete
    Wgmma<D>::after_smem_writes();
    __syncthreads();
    const bf16* kt;
    if constexpr (kWiden) {
      widen_e5m2<D>(reinterpret_cast<const uint8_t*>(ring + (j % S) * kStageBytes), wide);
      Wgmma<D>::after_smem_writes();
      __syncthreads();
      kt = wide;
    } else {
      kt = reinterpret_cast<const bf16*>(ring + (j % S) * kStageBytes);
    }
    const bf16* vt = kt + BK * D;

    // S = Q K^T: this warp's 16 rows x BK keys.
    float s[BK / 8][4];
    Wgmma<D>::qk(s, q_s, kt);

    // Scale, softcap, mask (frontier tiles only), online softmax.
    const bool edge = !(k0 + BK <= f.k_hi && k0 + BK - 1 <= f.qbase && k0 > q_last - f.window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const long long kp = k0 + nb * 8 + 2 * t4 + (e & 1);
          const long long qp = e < 2 ? qp0 : qp1;
          if (!(kp < f.k_hi && kp <= qp && kp > qp - f.window)) x = -INFINITY;
        }
        s[nb][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {  // the quad shares a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - n0) * kLog2e), alpha1 = exp2f((m1 - n1) * kLog2e);
    m0 = n0;
    m1 = n1;
    const float b0 = n0 * kLog2e, b1 = n1 * kLog2e;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] = exp2f(fmaf(s[nb][0], kLog2e, -b0));
      s[nb][1] = exp2f(fmaf(s[nb][1], kLog2e, -b0));
      s[nb][2] = exp2f(fmaf(s[nb][2], kLog2e, -b1));
      s[nb][3] = exp2f(fmaf(s[nb][3], kLog2e, -b1));
      ls0 += s[nb][0] + s[nb][1];
      ls1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha0;
      o[i][1] *= alpha0;
      o[i][2] *= alpha1;
      o[i][3] *= alpha1;
    }

    // O += P V, P rounded to bf16: the S accumulators of key blocks
    // 2kk, 2kk + 1 are exactly the A fragment of key step kk.
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    Wgmma<D>::pv(o, p, vt);
    src.publish(j % S, k0 + S * BK, ahead);
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // Epilogue: O / l through this warp's own (now unread) Q rows.
  cp_async_wait<0>();
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float inv0 = r0 < f.n_q && l0 > 0.f ? 1.f / l0 : 0.f;  // padding rows: zeros
  const float inv1 = r1 < f.n_q && l1 > 0.f ? 1.f / l1 : 0.f;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    *reinterpret_cast<uint32_t*>(q_s + swz<kBQ>(r0, i * 8 + 2 * t4)) =
        pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    *reinterpret_cast<uint32_t*>(q_s + swz<kBQ>(r1, i * 8 + 2 * t4)) =
        pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * (D / 8) / 32; ++it) {
    const int i = lane + it * 32;
    const int r = warp * 16 + i / (D / 8), c = i % (D / 8);
    if (r < out_n)
      *reinterpret_cast<uint4*>(out_rows + r * o_st + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz<kBQ>(r, c * 8));
  }
}

}  // namespace attn_tc
