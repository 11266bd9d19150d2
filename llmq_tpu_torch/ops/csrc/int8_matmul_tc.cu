// Weight-only int8 matmul (K6), tensor-core route, for Hopper (sm_90a).
//
// Replaces: llmq_tpu/ops/pallas_matmul.py, int8_matmul_pallas (kernel body
// _int8_matmul_kernel). Plain version: llmq_tpu_torch/ops/matmul.py,
// int8_matmul. This source serves bf16 activations (scale f32 or bf16); f32
// activations stay on the exact CUDA-core kernel in int8_matmul.cu
// (cuda_matmul.int8_route chooses by dtype).
//
// Contract (the same as int8_matmul.cu): out[M, N] = (x[M, K] @ q[K, N]) *
// scale[N] in bf16; q int8, row-major, read as it is stored (quantized
// trees and layer-slice views work unchanged); one scale per output
// column. Every int8 value is exact in bf16, so the tensor cores multiply
// the plain version's values into f32. A fresh accumulator covers 128 rows
// (decode) or 512 (prefill) and is added into the running sum with Kahan
// compensation, as the TPU kernel's _kahan_add does across K blocks;
// split-K partials are combined in order with the same compensation. The
// scale is applied once, in f32, to the finished sum. Ragged M, N and K and
// rows at any byte alignment are handled: rows everywhere 16-byte aligned
// (N % 16 == 0, K % 8 == 0, aligned bases) arrive by TMA,
// others 16-byte cp.async copies or plain predicated loads into the same
// layouts; everything outside the matrix is zero-filled, so it multiplies
// as zero.
//
// The widening of a byte: c ^ 0x80 is c + 128 in [0, 255]; a byte permute
// puts it in the mantissa of the float 2^23 (one PRMT), one FADD of
// -(2^23 + 128) leaves c exactly, and the top halves of two such floats
// (one more PRMT) are the bf16 pair of a B-fragment register: every integer
// of [-128, 127] is exact in bf16, so dropping the low half rounds nothing.
//
// Bound on the H100 and the design:
//   * decode sizes (M <= 16): the weight bytes, one a weight. Kernel
//     int8_decode: a block of 8 warps owns 256 columns (32 a warp) and a
//     16-row M tile; 64-row k-tiles of the weight (16 KB) stream through a
//     ring 2 to 6 stages deep beside the x tile, and split-K over whole
//     k-tiles puts two blocks on every SM (the planner,
//     ops/cuda_matmul.int8_tc_plan). K7's decode kernel, which copies its
//     tiles in 16-byte cp.async pieces, read only ~1 TB/s (PERF.md §6), so
//     here one thread issues three TMA loads a stage (the tile's two
//     128-column halves and the x tile), completing on an mbarrier. An
//     m16n8k16 B register holds rows 2t, 2t + 1 of one column: two bytes a
//     row apart, so a thread loads one 4-byte word of each of its four rows
//     (its four columns are adjacent: the column order inside an mma
//     n-block is permuted, which only permutes the output columns) and
//     builds its eight B registers from them. TMA's 128-byte swizzle
//     (16-byte chunk c of row r at c ^ (r & 7)) puts the four rows a warp
//     reads at once in disjoint bank groups. There are no scale rows in the
//     ring: the scale is read once per column, in the epilogue.
//   * prefill sizes (M > 16): the operations, 2 M K N at the bf16 rate.
//     Kernel int8_prefill: 128 x 128 output tiles, two warpgroups,
//     wgmma m64n128k16. K7's prefill kernel showed that 128-byte rows
//     copied at large strides bound such a kernel (PERF.md §6), so here
//     one thread issues two 2-D TMA loads a k-tile, the x tile
//     (128 x 64 bf16) and the weight tile (64 x 128 bytes), both in the
//     128-byte swizzle, completing on an mbarrier; a 6-stage ring keeps
//     five tiles in flight. The product is taken transposed, out^T = q^T .
//     x^T: each warpgroup's 64 weight columns are wgmma's A operand,
//     widened from the staged bytes straight into registers, and the x
//     tile is its B operand, read where TMA put it; so no widened copy of
//     the weights passes through shared memory (a first form that widened
//     into shared memory for a B operand could not overlap the widening
//     with the products: PERF.md §6). Each k-tile's A fragments are
//     widened while the tensor cores multiply the previous tile's, and
//     each tile's products are queued behind the previous tile's before
//     the block waits for those, so the tensor cores do not idle at the
//     tile's barrier. The Kahan compensations live in shared memory,
//     which leaves the registers to the accumulators and two k-tiles of A
//     fragments. The copies then hide entirely; the products and the
//     widening, which does not hide fully under them, bound the kernel.
//   * both: the sums are staged through shared memory and stored a row at
//     a time, 16 bytes a thread (scattered 4-byte stores of the partials
//     had taken a third of the decode kernel's time: PERF.md §6).

#include <cuda.h>

#include "quant_tc.cuh"

namespace {

using namespace qtc;

constexpr float kBias = kMagic + 128.f;  // 2^23 + (c + 128) - kBias = c
constexpr uint32_t kFlip = 0x80808080u;   // c ^ 0x80 on each byte of a word
constexpr int kKahanTiles = 2;            // k-tiles per fresh mma accumulator: 128 rows

// Byte J of `flipped` (a word of c ^ 0x80 bytes) as the float c, exactly.
// `magic` holds 2^23's bytes in a register (magic_register), which keeps
// the selector an immediate.
template <int J>
__device__ __forceinline__ uint32_t widen_byte(uint32_t flipped, uint32_t magic) {
  return __float_as_uint(__uint_as_float(__byte_perm(magic, flipped, 0x3104u + J)) - kBias);
}
__device__ __forceinline__ uint32_t magic_register() {
  uint32_t magic = 0x4B000000u;
  asm volatile("" : "+r"(magic));
  return magic;
}
// The bf16 pair (lo, hi) of two integer-valued floats: their top halves.
__device__ __forceinline__ uint32_t top_halves(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}
// The two B registers of mma n-block J (column J of a thread's four): rows
// 2 t4, 2 t4 + 1 (words w0, w1) and 2 t4 + 8, 2 t4 + 9 (w2, w3).
template <int J>
__device__ __forceinline__ void b_frag(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                       uint32_t magic, uint32_t (&b)[2]) {
  b[0] = top_halves(widen_byte<J>(w0, magic), widen_byte<J>(w1, magic));
  b[1] = top_halves(widen_byte<J>(w2, magic), widen_byte<J>(w3, magic));
}

// The block's finished sums, staged in shared memory as `tile` (ROWS rows
// of `pitch` floats, 16-byte aligned), written in row order four columns a
// thread at a time, so a warp's stores are contiguous: the scaled bf16
// output when the launch has one split, its f32 partials otherwise.
template <int ROWS, int COLS, int THREADS, typename TS>
__device__ __forceinline__ void store_tile(const float* tile, int pitch, const TS* scale,
                                           bf16* out, float* part, int m0, int n0, int M,
                                           int N) {
  const bool vec = N % 4 == 0;
  for (int i = threadIdx.x; i < ROWS * COLS / 4; i += THREADS) {
    const int r = i / (COLS / 4), c = 4 * (i % (COLS / 4));
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + r * pitch + c);
    const float f[4] = {v.x, v.y, v.z, v.w};
    if (gridDim.z == 1) {
      bf16* dst = out + (long long)m * N + n;
      if (vec) {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16(f[0] * to_f32(scale[n]), f[1] * to_f32(scale[n + 1])),
                       pack_bf16(f[2] * to_f32(scale[n + 2]), f[3] * to_f32(scale[n + 3])));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) dst[e] = __float2bfloat16(f[e] * to_f32(scale[n + e]));
      }
    } else {
      float* dst = part + ((long long)blockIdx.z * M + m) * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) dst[e] = f[e];
      }
    }
  }
}

// ---- asynchronous tile copies: TMA completing on an mbarrier ---------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// A 2-D box of `map` at (c0 innermost, c1) into shared memory, completing
// on `bar`; coordinates past the tensor read as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- decode sizes: int8_decode ---------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecNC = 4;                   // columns a thread (one 4-byte load a row)
constexpr int kDecWN = 8 * kDecNC;          // columns a warp
constexpr int kDecBN = kDecWN * kDecWarps;  // 256 columns a block
constexpr int kDecM = 16;
constexpr int kDecHalf = kKT * 128;  // 128 columns of a k-tile: 64 rows of 128 bytes, swizzled
constexpr int kDecW = 2 * kDecHalf;  // a stage's weight tile
constexpr int kDecStage = kDecW + kDecM * kKT * 2;  // + the x tile (1,024-byte multiples)

template <int STAGES>
constexpr int dec_bytes() {  // + a TMA barrier a stage, + 1 KB to align to the swizzle
  return STAGES * kDecStage + 8 * STAGES + 1024;
}

// Grid (ceil(N / 256), ceil(M / 16), splits); splits > 1 writes f32
// partials [split][M][N] for combine_kernel. kTma: the weight halves and
// the x tile arrive by TMA (tmap_q, tmap_x) in the 128-byte swizzle;
// otherwise by 16-byte cp.async (vec_w / vec_x) or plain loads, in the
// same layout.
template <typename TS, int STAGES, bool kTma>
__global__ void __launch_bounds__(kDecThreads) int8_decode_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_q,
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const TS* __restrict__ scale,
    bf16* __restrict__ out, float* __restrict__ part, int M, int N, int K, int tiles_per_split,
    int vec_w, int vec_x) {
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * kDecStage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kDecBN, m0 = blockIdx.y * kDecM;
  const int n_tiles = (K + kKT - 1) / kKT;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_local = max(0, t_end - t_begin);

  if (kTma && tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto stage = [&](int s) { return smem + s * kDecStage; };
  auto issue = [&](int j) {  // local tile j into its stage
    const int s = j % STAGES;
    char* st = stage(s);
    const int k0 = (t_begin + j) * kKT;
    if constexpr (kTma) {
      if (tid == 0) {  // a half wholly past N is not fetched: its columns are never stored
        const bool second = n0 + 128 < N;
        mbar_expect_tx(full + s, kDecStage - (second ? 0 : kDecHalf));
        tma_load_2d(st, &tmap_q, n0, k0, full + s);
        if (second) tma_load_2d(st + kDecHalf, &tmap_q, n0 + 128, k0, full + s);
        tma_load_2d(st + kDecW, &tmap_x, k0, m0, full + s);
      }
    } else {
      for (int i = tid; i < kKT * (kDecBN / 16); i += kDecThreads) {
        const int r = i / (kDecBN / 16), c = i % (kDecBN / 16);
        const int k = k0 + r, n = n0 + 16 * c;
        char* dst = st + (c >> 3) * kDecHalf + r * 128 + (((c & 7) ^ (r & 7)) << 4);
        if (vec_w) {
          const bool ok = k < K && n < N;
          cp_async16(dst, q + (ok ? (long long)k * N + n : 0), ok);
        } else {
#pragma unroll 4
          for (int e = 0; e < 16; ++e)
            dst[e] = (k < K && n + e < N) ? (char)q[(long long)k * N + n + e] : (char)0;
        }
      }
      issue_x<kDecM, kDecThreads>(reinterpret_cast<bf16*>(st + kDecW), x, m0, k0, M, K, vec_x);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_local) issue(j);
    if (!kTma) cp_async_commit();
  }

  float fresh[kDecNC][4], run[kDecNC][4], comp[kDecNC][4];
#pragma unroll
  for (int c = 0; c < kDecNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) fresh[c][e] = run[c][e] = comp[c][e] = 0.f;
  // This thread's B columns wc .. wc + 3 (block-local): their 4-byte word
  // in row r of the swizzled tile sits at (wc / 128) * kDecHalf + 128 r +
  // 16 ((chunk ^ (r & 7))) + wc % 16; rows 16 s + 2 t4 + {0, 8} share one
  // swizzle, rows + 1 the other.
  const int wc = warp * kDecWN + kDecNC * g;
  const int chunk = (wc & 127) >> 4;
  const int base = (wc >> 7) * kDecHalf + (wc & 15);
  const int off0 = base + 2 * t4 * 128 + ((chunk ^ (2 * t4)) << 4);
  const int off1 = base + (2 * t4 + 1) * 128 + ((chunk ^ (2 * t4 + 1)) << 4);
  const uint32_t magic = magic_register();

  for (int j = 0; j < n_local; ++j) {
    if constexpr (kTma) {
      mbar_wait(full + j % STAGES, (j / STAGES) & 1);  // tile j has landed
    } else {
      cp_async_wait<STAGES - 2>();  // tile j has landed (this thread's copies)
    }
    __syncthreads();  // everyone's copies; stage j - 1 is free
    if (j + STAGES - 1 < n_local) issue(j + STAGES - 1);
    if (!kTma) cp_async_commit();
    const char* st = stage(j % STAGES);
    const bf16* x_s = reinterpret_cast<const bf16*>(st + kDecW);
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s) {
      uint32_t a[4];
      load_a(a, x_s, 0, s);
      const char* rows = st + 16 * s * 128;  // rows 2 t4 (+1, +8, +9) of k16 step s
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + off0) ^ kFlip;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + off1) ^ kFlip;
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(rows + 8 * 128 + off0) ^ kFlip;
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(rows + 8 * 128 + off1) ^ kFlip;
      uint32_t b[kDecNC][2];
      b_frag<0>(w0, w1, w2, w3, magic, b[0]);
      b_frag<1>(w0, w1, w2, w3, magic, b[1]);
      b_frag<2>(w0, w1, w2, w3, magic, b[2]);
      b_frag<3>(w0, w1, w2, w3, magic, b[3]);
#pragma unroll
      for (int c = 0; c < kDecNC; ++c) mma16816(fresh[c], a, b[c][0], b[c][1]);
    }
    if ((j + 1) % kKahanTiles == 0 || j + 1 == n_local) {
#pragma unroll
      for (int c = 0; c < kDecNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kahan_add(run[c][e], comp[c][e], fresh[c][e]);
          fresh[c][e] = 0.f;
        }
    }
  }
  if (!kTma) cp_async_wait<0>();
  __syncthreads();  // the ring is free: it stages the block's sums

  // mma n-block c, n-index i holds block column warp * kDecWN + kDecNC * i
  // + c: this thread's accumulators are columns warp * kDecWN + kDecNC *
  // (2 t4 + (e & 1)) + c of rows g (e < 2) and g + 8.
  constexpr int kPitch = kDecBN + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < kDecNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(g + (e >> 1) * 8) * kPitch + warp * kDecWN + kDecNC * (2 * t4 + (e & 1)) + c] =
          run[c][e];
  __syncthreads();
  store_tile<kDecM, kDecBN, kDecThreads>(tile, kPitch, scale, out, part, m0, n0, M, N);
}

// ---- prefill sizes: int8_prefill -------------------------------------------

constexpr int kPreWG = 2;  // warpgroups a block, 64 weight columns each
constexpr int kPreThreads = 128 * kPreWG;
constexpr int kPreBM = 128, kPreBN = 64 * kPreWG;  // 128 tokens x 128 columns
constexpr int kPreKahanTiles = 8;  // k-tiles per fresh accumulator: 512 rows, the TPU
                                   // kernel's largest K block
constexpr int kPreStages = 6;      // k-tiles in the ring: five in flight while one is used
constexpr int kPreX = kPreBM * kKT * 2;  // a stage's x tile (16 KB, 1,024-byte multiple)
constexpr int kPreQ = kKT * kPreBN;      // its weight tile, 128 bytes a row, swizzled
constexpr int kPreStage = kPreX + kPreQ;
constexpr int kPreComp = 64 * kPreThreads * 4;  // the Kahan compensations, in shared memory
constexpr int kPreBytes = kPreStages * kPreStage + kPreComp + 8 * kPreStages + 1024;

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16, bf16 in registers:
// the m16n8k16 A fragment of each warp's 16 rows) . B (16 x 128, from
// shared memory, K-major in the 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of `r` across this point
// (a register an in-flight wgmma still reads or writes).
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Grid (ceil(N / 128), ceil(M / 128), splits), two warpgroups. The product
// is taken transposed, out^T = q^T . x^T: the weights are wgmma's A operand,
// widened from the staged bytes straight into registers (no widened copy in
// shared memory), and the x tile is its B operand, read by wgmma where TMA
// put it. Warp w of warpgroup wg holds A rows 16 w + g and + 8; they stand
// for the adjacent weight columns 64 wg + 16 w + 2 g and + 1, so a thread's
// two bytes of a k row are one 2-byte load. A k-tile's A fragments are
// widened while the tensor cores multiply the previous tile's.
// kTma: tiles arrive by TMA (tmap_x, tmap_q); otherwise every thread loads
// its share of them with plain predicated loads, in the same layouts.
template <typename TS, bool kTma>
__global__ void __launch_bounds__(kPreThreads, 1) int8_prefill_kernel(
    const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_q,
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const TS* __restrict__ scale,
    bf16* __restrict__ out, float* __restrict__ part, int M, int N, int K, int tiles_per_split) {
  extern __shared__ __align__(1024) char smem_raw[];
  // TMA's and wgmma's 128-byte swizzle works on 1,024-byte aligned tiles.
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~uintptr_t(1023));
  char* ring = smem;
  float* comp_s = reinterpret_cast<float*>(smem + kPreStages * kPreStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPreStages * kPreStage + kPreComp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2, w = warp & 3;
  const int n0 = blockIdx.x * kPreBN, m0 = blockIdx.y * kPreBM;
  const int n_tiles = (K + kKT - 1) / kKT;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_local = max(0, t_end - t_begin);

  if (kTma && tid == 0) {
#pragma unroll
    for (int s = 0; s < kPreStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 64 * kPreThreads; i += kPreThreads) comp_s[i] = 0.f;
  __syncthreads();

  auto issue = [&](int j) {  // local tile j into stage j % kPreStages
    const int s = j % kPreStages;
    char* st = ring + s * kPreStage;
    const int k0 = (t_begin + j) * kKT;
    if constexpr (kTma) {
      if (tid == 0) {
        mbar_expect_tx(full + s, kPreStage);
        tma_load_2d(st, &tmap_x, k0, m0, full + s);
        tma_load_2d(st + kPreX, &tmap_q, n0, k0, full + s);
      }
    } else {
      issue_x<kPreBM, kPreThreads>(reinterpret_cast<bf16*>(st), x, m0, k0, M, K, false);
      char* q_s = st + kPreX;
      for (int i = tid; i < kPreQ; i += kPreThreads) {
        const int r = i / kPreBN, c = i % kPreBN;
        const int k = k0 + r, n = n0 + c;
        q_s[r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))] =
            (k < K && n < N) ? (char)q[(long long)k * N + n] : (char)0;
      }
      fence_async_shared();  // these writes, for wgmma's reads after the next barrier
    }
  };
  auto wait = [&](int j) {  // tile j has landed (plain loads: at the last barrier)
    if constexpr (kTma) mbar_wait(full + j % kPreStages, (j / kPreStages) & 1);
  };

  // This thread's bytes of k row r of the swizzled weight tile: columns
  // 16 (4 wg + w) + 2 g and + 1, in chunk 4 wg + w, at 128 r +
  // 16 (chunk ^ (r & 7)) + 2 g; rows 2 t4 + {0, 8} (+ 16 s) share one
  // swizzle, rows + 1 the other.
  const int chunk = 4 * wg + w;
  const int off0 = 2 * t4 * 128 + ((chunk ^ (2 * t4)) << 4) + 2 * g;
  const int off1 = (2 * t4 + 1) * 128 + ((chunk ^ (2 * t4 + 1)) << 4) + 2 * g;
  const uint32_t magic = magic_register();
  // A fragments of local tile j: per k16 step s, rows g (columns n, even)
  // and g + 8 (n + 1) at k 2 t4, 2 t4 + 1 (a[s][0], a[s][1]) and + 8.
  auto widen_a = [&](int j, uint32_t (&a)[4][4]) {
    const char* q_s = ring + (j % kPreStages) * kPreStage + kPreX;
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s) {
      const char* rows = q_s + 16 * s * 128;
      const uint32_t lo = (*reinterpret_cast<const uint16_t*>(rows + off0) |
                           (uint32_t)*reinterpret_cast<const uint16_t*>(rows + off1) << 16) ^
                          kFlip;
      const uint32_t hi = (*reinterpret_cast<const uint16_t*>(rows + 8 * 128 + off0) |
                           (uint32_t)*reinterpret_cast<const uint16_t*>(rows + 8 * 128 + off1)
                               << 16) ^
                          kFlip;
      a[s][0] = top_halves(widen_byte<0>(lo, magic), widen_byte<2>(lo, magic));
      a[s][1] = top_halves(widen_byte<1>(lo, magic), widen_byte<3>(lo, magic));
      a[s][2] = top_halves(widen_byte<0>(hi, magic), widen_byte<2>(hi, magic));
      a[s][3] = top_halves(widen_byte<1>(hi, magic), widen_byte<3>(hi, magic));
    }
  };

  float acc[16][4], run[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = run[i][e] = 0.f;

  auto multiply = [&](int j, uint32_t (&a)[4][4]) {  // tile j's products, asynchronously
    const bf16* x_s = reinterpret_cast<const bf16*>(ring + (j % kPreStages) * kPreStage);
    const bool first = j % kPreKahanTiles == 0;  // a fresh accumulator
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s)
      wgmma_m64n128_rs(acc, a[s], gmma_desc(x_s + s * 16, 16, 1024), !(first && s == 0));
    wgmma_commit();
  };
  // One k-tile. On entry tile j's products are in flight and tile j + 1's
  // A fragments are in `a_next`. Tile j + 1's products are queued behind
  // tile j's on the same accumulators before waiting for tile j, unless a
  // fresh accumulator starts there (then tile j's sum is added into the
  // running sum first), so the tensor cores do not idle at the barrier;
  // then tile j's stage is refilled and tile j + 2 widened into `a_cur`
  // while tile j + 1 multiplies.
  auto step = [&](int j, uint32_t (&a_cur)[4][4], uint32_t (&a_next)[4][4]) {
    const bool fresh = (j + 1) % kPreKahanTiles == 0 || j + 1 == n_local;
    if (!fresh) {
      multiply(j + 1, a_next);
      wgmma_wait<1>();  // tile j done
    } else {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(acc[i][e]);
          float& c = comp_s[(4 * i + e) * kPreThreads + tid];
          float cv = c;
          kahan_add(run[i][e], cv, acc[i][e]);
          c = cv;
        }
    }
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_operand(a_cur[s][r]);
    __syncthreads();  // every thread is done with tile j's stage
    if (j + kPreStages < n_local && (!kTma || tid == 0)) issue(j + kPreStages);
    if (fresh && j + 1 < n_local) multiply(j + 1, a_next);
    if (j + 2 < n_local) {
      wait(j + 2);
      widen_a(j + 2, a_cur);
    }
  };

  uint32_t a0[4][4], a1[4][4];  // A fragments of two k-tiles: one multiplied, one widened
#pragma unroll
  for (int j = 0; j < kPreStages; ++j)
    if (j < n_local && (!kTma || tid == 0)) issue(j);
  if (!kTma) __syncthreads();
  if (n_local > 0) {
    wait(0);
    widen_a(0, a0);
    multiply(0, a0);
  }
  if (n_local > 1) {
    wait(1);
    widen_a(1, a1);
  }
  for (int j = 0; j < n_local; j += 2) {
    step(j, a0, a1);
    if (j + 1 < n_local) step(j + 1, a1, a0);
  }

  // D row 16 w + g (e < 2) or + 8 of warp w is weight column n0 + 64 wg +
  // 16 w + 2 g (+ 1); its columns 8 i + 2 t4 + (e & 1) are tokens. Staged
  // as [token][column] f32.
  constexpr int kPitch = kPreBN + 4;
  float* tile = reinterpret_cast<float*>(smem);
  const int col = 64 * wg + 16 * w + 2 * g;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = 8 * i + 2 * t4;
    *reinterpret_cast<float2*>(tile + m * kPitch + col) = make_float2(run[i][0], run[i][2]);
    *reinterpret_cast<float2*>(tile + (m + 1) * kPitch + col) = make_float2(run[i][1], run[i][3]);
  }
  __syncthreads();
  store_tile<kPreBM, kPreBN, kPreThreads>(tile, kPitch, scale, out, part, m0, n0, M, N);
}

// Grid over M * N outputs: the splits' sums added in order, compensated,
// then scaled.
template <typename TS>
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ part,
                                                     const TS* __restrict__ scale,
                                                     bf16* __restrict__ out, long long MN, int N,
                                                     int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float acc = 0.f, comp = 0.f;
  for (int s = 0; s < splits; ++s) kahan_add(acc, comp, part[s * MN + idx]);
  out[idx] = __float2bfloat16(acc * to_f32(scale[idx % N]));
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] tensor's map: boxes of box_rows x box_cols.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int item, const void* base, int rows,
              int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * item};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TS, int STAGES, bool kTma>
cudaError_t launch_decode(const CUtensorMap& tx, const CUtensorMap& tq, const bf16* x,
                          const int8_t* q, const TS* scale, bf16* out, float* part, int M, int N,
                          int K, int per, int splits, int vec_w, int vec_x,
                          cudaStream_t stream) {
  constexpr int bytes = dec_bytes<STAGES>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_decode_kernel<TS, STAGES, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + kDecBN - 1) / kDecBN, (M + kDecM - 1) / kDecM, splits);
  int8_decode_kernel<TS, STAGES, kTma><<<grid, kDecThreads, bytes, stream>>>(
      tx, tq, x, q, scale, out, part, M, N, K, per, vec_w, vec_x);
  return cudaGetLastError();
}

template <typename TS, bool kTma>
cudaError_t launch_decode_stages(int stages, const CUtensorMap& tx, const CUtensorMap& tq,
                                 const bf16* x, const int8_t* q, const TS* scale, bf16* out,
                                 float* part, int M, int N, int K, int per, int splits,
                                 int vec_w, int vec_x, cudaStream_t stream) {
  switch (stages) {
    case 2:
      return launch_decode<TS, 2, kTma>(tx, tq, x, q, scale, out, part, M, N, K, per, splits,
                                        vec_w, vec_x, stream);
    case 3:
      return launch_decode<TS, 3, kTma>(tx, tq, x, q, scale, out, part, M, N, K, per, splits,
                                        vec_w, vec_x, stream);
    case 4:
      return launch_decode<TS, 4, kTma>(tx, tq, x, q, scale, out, part, M, N, K, per, splits,
                                        vec_w, vec_x, stream);
    case 6:
      return launch_decode<TS, 6, kTma>(tx, tq, x, q, scale, out, part, M, N, K, per, splits,
                                        vec_w, vec_x, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TS, bool kTma>
cudaError_t launch_prefill(const CUtensorMap& tx, const CUtensorMap& tq, const bf16* x,
                           const int8_t* q, const TS* scale, bf16* out, float* part, int M, int N,
                           int K, int per, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_prefill_kernel<TS, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + kPreBN - 1) / kPreBN, (M + kPreBM - 1) / kPreBM, splits);
  int8_prefill_kernel<TS, kTma><<<grid, kPreThreads, kPreBytes, stream>>>(
      tx, tq, x, q, scale, out, part, M, N, K, per);
  return cudaGetLastError();
}

template <typename TS>
cudaError_t run(int kind, const void* x, const void* q, const void* scale, void* out,
                float* part, int M, int N, int K, int splits, int stages, int vec_w, int vec_x,
                cudaStream_t stream) {
  const int n_tiles = (K + kKT - 1) / kKT;
  const int per = (n_tiles + splits - 1) / splits;
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const TS* sb = static_cast<const TS*>(scale);
  bf16* ob = static_cast<bf16*>(out);
  // TMA where every row is 16-byte aligned: x tiles of 128 (prefill) or 16
  // (decode) rows x 64 bf16 and weight tiles of 64 rows x 128 bytes, all in
  // the 128-byte swizzle.
  // A map that cannot be made is an error, not a reason to copy otherwise.
  const int bm = kind == 1 ? kPreBM : kDecM;
  CUtensorMap tx = {}, tq = {};
  const bool tma = vec_w && vec_x && K > 0;
  if (tma && !(make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, bm, kKT,
                        CU_TENSOR_MAP_SWIZZLE_128B) &&
               make_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N, kKT, 128,
                        CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kind == 1) {
    err = tma ? launch_prefill<TS, true>(tx, tq, xb, qb, sb, ob, part, M, N, K, per, splits,
                                         stream)
              : launch_prefill<TS, false>(tx, tq, xb, qb, sb, ob, part, M, N, K, per, splits,
                                          stream);
  } else {
    err = tma ? launch_decode_stages<TS, true>(stages, tx, tq, xb, qb, sb, ob, part, M, N, K,
                                               per, splits, vec_w, vec_x, stream)
              : launch_decode_stages<TS, false>(stages, tx, tq, xb, qb, sb, ob, part, M, N, K,
                                                per, splits, vec_w, vec_x, stream);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long MN = (long long)M * N;
  combine_kernel<TS><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(part, sb, ob, MN, N,
                                                                      splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). x and out bf16; scale_bf16: 1 =
// bf16 scale, 0 = f32. kind: 0 = int8_decode (16-row M tiles, `stages` ring
// stages of 2, 3, 4 or 6), 1 = int8_prefill (128 x 128 tiles; `stages`
// unused). splits > 1 cuts the 64-row k-tiles into that many runs and needs
// `partials`, f32 scratch of splits * M * N values. The launches are
// asynchronous on `stream`.
int llmq_int8_matmul_tc(const void* x, const void* q, const void* scale, void* out,
                        void* partials, int scale_bf16, int kind, int M, int N, int K,
                        int splits, int stages, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0 || splits < 1 || (splits > 1 && partials == nullptr) ||
      (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_w = aligned(q) && N % 16 == 0;
  const int vec_x = aligned(x) && K % 8 == 0;
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      scale_bf16 ? run<bf16>(kind, x, q, scale, out, part, M, N, K, splits, stages, vec_w,
                             vec_x, st)
                 : run<float>(kind, x, q, scale, out, part, M, N, K, splits, stages, vec_w,
                              vec_x, st);
  return (int)err;
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
