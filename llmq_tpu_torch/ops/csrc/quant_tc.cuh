// Shared pieces of the tensor-core routes of the weight-only quantized
// matmuls for Hopper (sm_90a): K7 (int4_matmul_tc.cu) and K6
// (int8_matmul_tc.cu). Both multiply bf16 x tiles by weights widened to
// bf16 in fast memory, on mma.sync (decode sizes) or wgmma (prefill sizes),
// with f32 accumulators added into a running sum with Kahan compensation.
// Here: the copy, mma and wgmma primitives, the x tile's swizzled staging
// and its A fragments, and the 64-row k-tile they share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtc {

using bf16 = __nv_bfloat16;

constexpr int kKT = 64;              // contraction rows per k-tile
constexpr float kMagic = 8388608.f;  // 2^23: a byte c in the mantissa reads 2^23 + c

// ---- small helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16 x 16, row) . b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float p) {
  const float y = p - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rows [m0, m0 + ROWS) x [k0, k0 + kKT) into a swizzled bf16 tile: 8
// chunks of 16 bytes a row, chunk c of row r stored at c ^ (r & 7), so
// ldmatrix's eight row addresses of one matrix hit eight bank groups.
template <int ROWS, int THREADS>
__device__ __forceinline__ void issue_x(bf16* x_s, const bf16* x, int m0, int k0, int M, int K,
                                        bool vec) {
  for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
    const int r = i / 8, c = i % 8;
    const int m = m0 + r, k = k0 + 8 * c;
    bf16* dst = x_s + r * kKT + ((c ^ (r & 7)) << 3);
    if (vec) {
      const bool ok = m < M && k < K;
      cp_async16(dst, x + (ok ? (long long)m * K + k : 0), ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (m < M && k + e < K) ? x[(long long)m * K + k + e] : __float2bfloat16(0.f);
    }
  }
}

// A fragment of rows [r0, r0 + 16) and k16 step s of a swizzled x tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x_s, int r0, int s) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 15), c = 2 * s + (lane >> 4);
  ldmatrix_x4(a, x_s + r * kKT + ((c ^ (r & 7)) << 3));
}

// Warpgroup products (wgmma) for the prefill kernel: A (x) and B (the
// decoded weights) both from shared memory in the 128-byte swizzle, A
// K-major, B MN-major (rows of k, 64-column blocks) under the transpose
// flag: the layouts attn_tc.cuh's wgmma reads for Q and for V. A
// descriptor holds the start address, the leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Writes by threads to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 128).
__device__ __forceinline__ void wgmma_m64n128(float (&d)[16][4], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}


}  // namespace qtc
