// Weight-only int4 group matmul (K7), tensor-core route, for Hopper
// (sm_90a).
//
// Replaces: llmq_tpu/ops/pallas_matmul.py, int4_matmul_pallas (kernel body
// _int4_matmul_kernel). Plain version: llmq_tpu_torch/ops/matmul.py,
// int4_matmul. This source serves bf16 activations (scales and zeros f32 or
// bf16); f32 activations stay on the exact CUDA-core kernel in
// int4_matmul.cu (cuda_matmul.int4_route chooses by dtype).
//
// Contract (the same as int4_matmul.cu): out[M, N] = x[M, K] @ w[K, N] in
// bf16, w[k, n] = (code(k, n) - zero[g, n]) * scale[g, n] with
// g = k / group. q [K/2, N] uint8 packs two codes per byte along K, the
// even row in the low nibble: JAX's layout, read as it is (no repack, so
// quantized trees and layer-slice views work unchanged). Each weight is
// rebuilt in f32 and rounded once to bf16, exactly as
// models/quant.py::dequantize_int4_parts; the tensor cores then multiply
// the same bf16 values the plain version multiplies, into f32. A fresh
// mma accumulator covers 128 rows (decode) or 256 (prefill) and is added into
// the running sum with Kahan compensation, as the TPU kernel's _kahan_add
// does across K blocks; split-K partials are combined in order with the
// same compensation. Ragged M, N and K, any group, and rows at any byte
// alignment are handled here: 16-byte aligned rows (N % 16 == 0, aligned
// bases) go through a ring of 16-byte cp.async copies, other rows through
// plain predicated loads into the same ring; everything outside the
// matrix is zero-filled, so it multiplies as zero.
//
// The decode of a packed byte: its two nibbles become the f32 values
// 2^23 + code by a byte permute into the mantissa (one PRMT each); one
// FADD of (2^23 + zero) leaves code - zero exactly; one FMUL by the scale
// and one pack to bf16x2 give the B-fragment register of mma.m16n8k16,
// whose rows 2t, 2t + 1 of one column are exactly one packed byte.
//
// Bound on the H100 and the design:
//   * decode sizes (M <= 16): the weight bytes. Kernel int4_decode: a
//     block of 8 warps owns 256 columns (32 a warp) and one M tile of 16
//     rows; the packed weight streams through a ring of 16-byte cp.async
//     copies (9 KB of weight per stage, with the x tile and the tile's
//     scale and zero rows beside it); each warp loads its B bytes from
//     shared memory (one 4-byte load per packed row: a thread's four
//     columns are adjacent, the column order inside an mma n-block being
//     permuted, which only permutes the output columns) and decodes them
//     in registers; x comes through ldmatrix. Scale and zero are read
//     once per (group, column) from the staged rows. A warp's k16 step is
//     a long dependent chain (loads, decode, mma), so the SM needs many
//     warps: 8 a block, two blocks an SM. Split-K over whole k-tiles
//     fills the SMs (llama3.1-8b's down_proj has only 16 tiles of 256
//     columns) without putting a third block on some SMs (an SM's blocks
//     share it, so the fullest SM sets the time); the planner in
//     ops/cuda_matmul.py picks the splits and stages.
//   * prefill sizes: the operations. Kernel int4_prefill: 128 x 128 output
//     tiles, two warpgroups of 64 rows; each k-tile's weights are decoded
//     ONCE per block into shared memory, in the MN-major 128-byte-swizzled
//     layout wgmma reads (double-buffered), and multiplied by wgmma
//     m64n128k16 with x from a 6-stage cp.async ring, also swizzled. The
//     wgmma is asynchronous: each thread decodes tile j + 1 while the
//     tensor cores multiply tile j, one barrier a tile. TMA and a
//     producer warp are later work.

#include "quant_tc.cuh"

namespace {

using namespace qtc;

constexpr int kKahanTiles = 2;     // k-tiles per fresh mma accumulator: 128 rows (decode)
constexpr int kSZRows = kKT / 16;  // group rows a k-tile can touch when group % 16 == 0

// A column's zero and scale as the decode uses them: 2^23 + zero, scale.
template <int NC>
struct ZS {
  float z[NC], s[NC];
};

// NC packed bytes (columns c .. c + NC - 1 of one packed row; word i holds
// columns 4i .. 4i + 3) -> NC bf16x2 words (the even and odd row of each
// column), bit-identical to ((float)code - zero) * scale rounded to bf16:
// each nibble becomes the float 2^23 + code by a byte permute into the
// mantissa (the register holding 2^23's bytes keeps the selector an
// immediate), one FADD of 2^23 + zero leaves code - zero exactly, one
// FMUL rounds the product, a pack rounds it to bf16.
template <int NC>
__device__ __forceinline__ void dequant(const uint32_t (&u)[NC / 4], const ZS<NC>& zs,
                                        uint32_t (&w)[NC]) {
  uint32_t lo[NC / 4], hi[NC / 4];
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) {
    lo[i] = u[i] & 0x0F0F0F0Fu;
    hi[i] = (u[i] >> 4) & 0x0F0F0F0Fu;
  }
  uint32_t magic = 0x4B000000u;
  asm volatile("" : "+r"(magic));
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const uint32_t sel = 0x3104u + (j & 3);  // [byte j of the code word, 0, 0, 0x4B]
    const float e = __uint_as_float(__byte_perm(magic, lo[j >> 2], sel)) - zs.z[j];
    const float o = __uint_as_float(__byte_perm(magic, hi[j >> 2], sel)) - zs.z[j];
    w[j] = pack_bf16(e * zs.s[j], o * zs.s[j]);
  }
}

// The same weight rebuilt from global memory, for groups that are not a
// multiple of 16 (a k16 step may cross them): slow, exact.
template <typename TS>
__device__ __forceinline__ float weight_at(const TS* scale, const TS* zero, int code, int k,
                                           int n, int K, int N, int group) {
  if (k >= K || n >= N) return 0.f;
  const long long gi = (long long)(k / group) * N + n;
  return ((float)code - to_f32(zero[gi])) * to_f32(scale[gi]);
}

// N 32-bit words from 4N-byte-aligned shared memory, in 8- or 16-byte loads.
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[N]) {
  if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}

// Zero and scale of NC columns at staged row `row` (sz_s: scale rows
// then zero rows, kSZRows x pitch values each), as dequant takes them:
// each row's NC values come in one or two vector loads.
template <int NC, typename TS>
__device__ __forceinline__ void load_sz(const TS* sz_s, int pitch, int row, int col, ZS<NC>& zs) {
  constexpr int kWords = NC * (int)sizeof(TS) / 4;
  uint32_t sw[kWords], zw[kWords];
  load_words<kWords>(sz_s + row * pitch + col, sw);
  load_words<kWords>(sz_s + (kSZRows + row) * pitch + col, zw);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float sf, zf;
    if constexpr (sizeof(TS) == 2) {  // a bf16 is the top half of its f32
      sf = __uint_as_float(j & 1 ? sw[j >> 1] & 0xFFFF0000u : sw[j >> 1] << 16);
      zf = __uint_as_float(j & 1 ? zw[j >> 1] & 0xFFFF0000u : zw[j >> 1] << 16);
    } else {
      sf = __uint_as_float(sw[j]);
      zf = __uint_as_float(zw[j]);
    }
    zs.s[j] = sf;
    zs.z[j] = kMagic + zf;
  }
}

template <int NC>
__device__ __forceinline__ void zero_sz(ZS<NC>& zs) {
#pragma unroll
  for (int j = 0; j < NC; ++j) zs.z[j] = zs.s[j] = 0.f;  // (2^23 + code) * 0 = 0
}

// Issue (cp.async when vec, plain loads otherwise) of one k-tile's packed
// weight rows [kp0, kp0 + kKT/2) x columns [n0, n0 + BN) into `w_s` (row
// pitch WP bytes), and of its scale / zero rows into `sz_s`.
template <int BN, int WP, int THREADS, typename TS>
__device__ __forceinline__ void issue_weights(uint8_t* w_s, TS* sz_s, const uint8_t* q,
                                              const TS* scale, const TS* zero, int k0, int n0,
                                              int K, int N, int group, bool fast, bool vec) {
  constexpr int kChunks = BN / 16;  // 16-byte chunks of a staged packed row
  const int kp0 = k0 / 2, KP = K / 2;
  const int tid = threadIdx.x;
  for (int i = tid; i < (kKT / 2) * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const int kp = kp0 + r, n = n0 + 16 * c;
    uint8_t* dst = w_s + r * WP + 16 * c;
    if (vec) {
      const bool ok = kp < KP && n < N;
      cp_async16(dst, q + (ok ? (long long)kp * N + n : 0), ok);
    } else {
#pragma unroll 4
      for (int e = 0; e < 16; ++e)
        dst[e] = (kp < KP && n + e < N) ? q[(long long)kp * N + n + e] : (uint8_t)0;
    }
  }
  if (!fast) return;  // other groups read their scales from global memory
  const int g0 = k0 / group;
  const int last = (k0 + kKT < K ? k0 + kKT : K) - 1;
  const int rows = k0 < K ? last / group - g0 + 1 : 0;
  constexpr int kPer = 16 / (int)sizeof(TS);  // values per 16-byte chunk
  constexpr int kRowChunks = BN / kPer;
  for (int i = tid; i < 2 * rows * kRowChunks; i += THREADS) {
    const int which = i / (rows * kRowChunks), rem = i % (rows * kRowChunks);
    const int r = rem / kRowChunks, c = rem % kRowChunks;
    const int n = n0 + kPer * c;
    const TS* src = which ? zero : scale;
    TS* dst = sz_s + (which * kSZRows + r) * BN + kPer * c;
    const long long at = (long long)(g0 + r) * N + n;
    if (vec) {
      cp_async16(dst, src + (n < N ? at : 0), n < N);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[e] = n + e < N ? src[at + e] : TS(0.f);
    }
  }
}

// ---- decode sizes: int4_decode -------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecNC = 4;                // columns a thread decodes (one 4-byte load a row)
constexpr int kDecWN = 8 * kDecNC;       // columns a warp
constexpr int kDecBN = kDecWN * kDecWarps;  // 256 columns a block
constexpr int kDecWP = kDecBN + 32;      // staged row pitch: the 4 rows a warp reads per
                                         // load land in 4 disjoint bank groups
constexpr int kDecM = 16;

template <typename TS>
struct DecLayout {
  static constexpr int kW = (kKT / 2) * kDecWP;
  static constexpr int kX = kDecM * kKT * 2;
  static constexpr int kSZ = 2 * kSZRows * kDecBN * (int)sizeof(TS);
  static constexpr int kStage = kW + kX + kSZ;
};

// Grid (ceil(N / 256), ceil(M / 16), splits); splits > 1 writes f32
// partials [split][M][N] for combine_kernel.
template <typename TS, int STAGES, bool kFast>
__global__ void __launch_bounds__(kDecThreads) int4_decode_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q, const TS* __restrict__ scale,
    const TS* __restrict__ zero, bf16* __restrict__ out, float* __restrict__ part, int M, int N,
    int K, int group, int tiles_per_split, int vec_w, int vec_x) {
  using Lay = DecLayout<TS>;
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kDecBN, m0 = blockIdx.y * kDecM;
  const int n_tiles = (K + kKT - 1) / kKT;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_local = max(0, t_end - t_begin);

  auto stage = [&](int s) { return smem + s * Lay::kStage; };
  auto issue = [&](int j) {  // local tile j into its stage
    char* st = stage(j % STAGES);
    const int k0 = (t_begin + j) * kKT;
    issue_weights<kDecBN, kDecWP, kDecThreads>(
        reinterpret_cast<uint8_t*>(st), reinterpret_cast<TS*>(st + Lay::kW + Lay::kX), q,
        scale, zero, k0, n0, K, N, group, kFast, vec_w);
    issue_x<kDecM, kDecThreads>(reinterpret_cast<bf16*>(st + Lay::kW), x, m0, k0, M, K, vec_x);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_local) issue(j);
    cp_async_commit();
  }

  float fresh[kDecNC][4], run[kDecNC][4], comp[kDecNC][4];
#pragma unroll
  for (int j = 0; j < kDecNC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fresh[j][e] = run[j][e] = comp[j][e] = 0.f;
  ZS<kDecNC> zs;
  const int wc = warp * kDecWN + kDecNC * g;  // this thread's B columns (block-local)
  // Group of the current k16 step and the row where the next one starts
  // (kFast: groups are multiples of 16, so a step never crosses one).
  int gcur = kFast ? t_begin * kKT / group : 0;
  int g_next = kFast ? gcur * group : 0;  // the first step loads its group

  for (int j = 0; j < n_local; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();              // everyone's copies; stage j - 1 is free
    if (j + STAGES - 1 < n_local) issue(j + STAGES - 1);
    cp_async_commit();
    const char* st = stage(j % STAGES);
    const uint8_t* w_s = reinterpret_cast<const uint8_t*>(st);
    const bf16* x_s = reinterpret_cast<const bf16*>(st + Lay::kW);
    const TS* sz_s = reinterpret_cast<const TS*>(st + Lay::kW + Lay::kX);
    const int k0 = (t_begin + j) * kKT;
    const int g0 = kFast ? k0 / group : 0;  // the stage's first scale row
#pragma unroll
    for (int s = 0; s < kKT / 16; ++s) {
      const int k = k0 + 16 * s;
      if (kFast && k >= g_next) {
        gcur = k / group;
        g_next = (gcur + 1) * group;
        if (k < K) {
          load_sz(sz_s, kDecBN, gcur - g0, wc, zs);
        } else {
          zero_sz(zs);
        }
      }
      uint32_t a[4];
      load_a(a, x_s, 0, s);
      const uint32_t u0[1] = {*reinterpret_cast<const uint32_t*>(w_s + (8 * s + t4) * kDecWP + wc)};
      const uint32_t u1[1] = {
          *reinterpret_cast<const uint32_t*>(w_s + (8 * s + 4 + t4) * kDecWP + wc)};
      uint32_t b0[kDecNC], b1[kDecNC];
      if constexpr (kFast) {
        dequant(u0, zs, b0);
        dequant(u1, zs, b1);
      } else {
        const int nb = n0 + wc;
        const int ka = k + 2 * t4, kb = ka + 8;
#pragma unroll
        for (int c = 0; c < kDecNC; ++c) {
          const uint32_t ba = (u0[0] >> (8 * c)) & 0xFFu;
          const uint32_t bb = (u1[0] >> (8 * c)) & 0xFFu;
          b0[c] = pack_bf16(weight_at(scale, zero, ba & 15, ka, nb + c, K, N, group),
                            weight_at(scale, zero, ba >> 4, ka + 1, nb + c, K, N, group));
          b1[c] = pack_bf16(weight_at(scale, zero, bb & 15, kb, nb + c, K, N, group),
                            weight_at(scale, zero, bb >> 4, kb + 1, nb + c, K, N, group));
        }
      }
#pragma unroll
      for (int c = 0; c < kDecNC; ++c) mma16816(fresh[c], a, b0[c], b1[c]);
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
  cp_async_wait<0>();

  // mma n-block c, n-index i holds block column warp * kDecWN + kDecNC * i
  // + c: this thread's accumulators are columns warp * kDecWN + kDecNC *
  // (2 t4 + (e & 1)) + c of rows g (e < 2) and g + 8.
#pragma unroll
  for (int c = 0; c < kDecNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + (e >> 1) * 8;
      const int n = n0 + warp * kDecWN + kDecNC * (2 * t4 + (e & 1)) + c;
      if (m >= M || n >= N) continue;
      if (gridDim.z == 1)
        out[(long long)m * N + n] = __float2bfloat16(run[c][e]);
      else
        part[((long long)blockIdx.z * M + m) * N + n] = run[c][e];
    }
}

// ---- prefill sizes: int4_prefill ----------------------------------------------

constexpr int kPreWG = 2;                 // warpgroups a block, 64 rows each
constexpr int kPreThreads = 128 * kPreWG;
constexpr int kPreBM = 64 * kPreWG, kPreBN = 128;  // 128 x 128 output tiles
constexpr int kPreWP = kPreBN + 16;      // raw row pitch (16-byte multiple)
constexpr int kPreKahanTiles = 4;        // k-tiles per fresh accumulator: 256 rows
constexpr int kPreStages = 6;  // 4 tiles in flight while one is decoded and one multiplied
constexpr int kPreNB = kPreBN / 8;       // column octets of a block tile
// One k-tile's decoded weights: kKT rows of k, kPreBN / 64 blocks of 64
// columns, each row 128 bytes with its 16-byte chunks swizzled by row.
constexpr int kFragBytes = kKT * kPreBN * 2;

template <typename TS>
struct PreLayout {
  static constexpr int kX = kPreBM * kKT * 2;  // 1,024-byte multiple
  static constexpr int kW = 5 * 1024;          // 32 packed rows at kPreWP, padded
  static constexpr int kSZ = 4096;             // four scale and four zero rows (f32 at most)
  static constexpr int kStage = kX + kW + kSZ;
  static constexpr int kBytes = 2 * kFragBytes + kPreStages * kStage + 1024;  // + alignment
  static_assert((kKT / 2) * kPreWP <= kW && 2 * kSZRows * kPreBN * sizeof(TS) <= kSZ, "");
};

// Decode the staged tile at k0 into `frag` in wgmma's MN-major layout:
// lane p takes packed row p (k rows 2p, 2p + 1), the warps the column
// octets; each octet's eight bf16x2 words (even row, odd row) are
// regrouped into one 16-byte chunk per row.
template <typename TS, bool kFast>
__device__ __forceinline__ void decode_tile(bf16* frag, const uint8_t* w_s, const TS* sz_s,
                                            const TS* scale, const TS* zero, int k0, int n0,
                                            int K, int N, int group) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane;
  const int k = k0 + 2 * p;
  const int row = kFast && k < K ? k / group - k0 / group : 0;  // staged scale row
#pragma unroll
  for (int i = 0; i < kPreNB / (kPreThreads / 32); ++i) {  // column octets, two a warp
    const int o = warp + i * (kPreThreads / 32);
    const uint2 u2 = *reinterpret_cast<const uint2*>(w_s + p * kPreWP + 8 * o);
    const uint32_t u[2] = {u2.x, u2.y};
    uint32_t w[8];
    if constexpr (kFast) {
      ZS<8> zs;
      if (k < K) {
        load_sz(sz_s, kPreBN, row, 8 * o, zs);
      } else {
        zero_sz(zs);
      }
      dequant(u, zs, w);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t b = (u[c >> 2] >> (8 * (c & 3))) & 0xFFu;
        const int n = n0 + 8 * o + c;
        w[c] = pack_bf16(weight_at(scale, zero, b & 15, k, n, K, N, group),
                         weight_at(scale, zero, b >> 4, k + 1, n, K, N, group));
      }
    }
    const uint4 even = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                                  __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
    const uint4 odd = make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                                 __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
    const int r0 = 2 * p, r1 = r0 + 1;
    bf16* blk = frag + (o >> 3) * (kKT * 64);
    *reinterpret_cast<uint4*>(blk + r0 * 64 + (((o & 7) ^ (r0 & 7)) << 3)) = even;
    *reinterpret_cast<uint4*>(blk + r1 * 64 + (((o & 7) ^ (r1 & 7)) << 3)) = odd;
  }
}

// Grid (ceil(N / 128), ceil(M / 128), splits), two warpgroups of 64 rows.
template <typename TS, bool kFast>
__global__ void __launch_bounds__(kPreThreads, 1) int4_prefill_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ q, const TS* __restrict__ scale,
    const TS* __restrict__ zero, bf16* __restrict__ out, float* __restrict__ part, int M, int N,
    int K, int group, int tiles_per_split, int vec_w, int vec_x) {
  using Lay = PreLayout<TS>;
  extern __shared__ __align__(1024) char smem_raw[];
  // wgmma's 128-byte swizzle works on 1,024-byte aligned tiles.
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~uintptr_t(1023));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int n0 = blockIdx.x * kPreBN, m0 = blockIdx.y * kPreBM;
  const int n_tiles = (K + kKT - 1) / kKT;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_local = max(0, t_end - t_begin);
  bf16* frag = reinterpret_cast<bf16*>(smem);  // two decoded tiles
  char* ring = smem + 2 * kFragBytes;

  auto stage = [&](int s) { return ring + s * Lay::kStage; };
  auto issue = [&](int j) {
    char* st = stage(j % kPreStages);
    const int k0 = (t_begin + j) * kKT;
    issue_x<kPreBM, kPreThreads>(reinterpret_cast<bf16*>(st), x, m0, k0, M, K, vec_x);
    issue_weights<kPreBN, kPreWP, kPreThreads>(
        reinterpret_cast<uint8_t*>(st + Lay::kX),
        reinterpret_cast<TS*>(st + Lay::kX + Lay::kW), q, scale, zero, k0, n0, K, N, group,
        kFast, vec_w);
  };
  auto decode = [&](int j) {  // local tile j's weights into frag buffer j % 2
    const char* st = stage(j % kPreStages);
    decode_tile<TS, kFast>(frag + (j & 1) * (kFragBytes / 2),
                           reinterpret_cast<const uint8_t*>(st + Lay::kX),
                           reinterpret_cast<const TS*>(st + Lay::kX + Lay::kW), scale, zero,
                           (t_begin + j) * kKT, n0, K, N, group);
  };

#pragma unroll
  for (int j = 0; j < kPreStages - 1; ++j) {
    if (j < n_local) issue(j);
    cp_async_commit();
  }
  if (n_local > 0) {
    cp_async_wait<kPreStages - 2>();  // tile 0
    __syncthreads();
    decode(0);
  }

  float acc[16][4], run[16][4], comp[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = run[i][e] = comp[i][e] = 0.f;

  for (int j = 0; j < n_local; ++j) {
    cp_async_wait<kPreStages - 3>();  // tile j + 1 has landed
    fence_async_shared();             // this thread's copies and decode, for wgmma
    __syncthreads();  // frag j complete; tile j - 1's stage and frag buffer are free
    if (j + kPreStages - 1 < n_local) issue(j + kPreStages - 1);
    cp_async_commit();
    // The products of tile j run on the tensor cores while this
    // thread decodes tile j + 1 into the other buffer.
    const bf16* x_s = reinterpret_cast<const bf16*>(stage(j % kPreStages)) + wg * 64 * kKT;
    const bf16* b_s = frag + (j & 1) * (kFragBytes / 2);
    const bool first = j % kPreKahanTiles == 0;  // a fresh accumulator
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk)
      wgmma_m64n128(acc, gmma_desc(x_s + kk * 16, 16, 1024),
                    gmma_desc(b_s + kk * 16 * 64, kKT * 128, 1024), !(first && kk == 0));
    wgmma_commit();
    if (j + 1 < n_local) decode(j + 1);
    wgmma_wait_all();
    if ((j + 1) % kPreKahanTiles == 0 || j + 1 == n_local) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) kahan_add(run[i][e], comp[i][e], acc[i][e]);
    }
  }
  cp_async_wait<0>();

  // Warp w of warpgroup wg holds rows 64 wg + 16 (w % 4) + g (e < 2) and
  // + 8, columns 8 i + 2 t4 + (e & 1).
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 64 * wg + 16 * (warp & 3) + g + (e >> 1) * 8;
      const int n = n0 + 8 * i + 2 * t4 + (e & 1);
      if (m >= M || n >= N) continue;
      if (gridDim.z == 1)
        out[(long long)m * N + n] = __float2bfloat16(run[i][e]);
      else
        part[((long long)blockIdx.z * M + m) * N + n] = run[i][e];
    }
}

// Grid over M * N outputs: the splits' sums added in order, compensated.
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ part,
                                                     bf16* __restrict__ out, long long MN,
                                                     int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float acc = 0.f, comp = 0.f;
  for (int s = 0; s < splits; ++s) kahan_add(acc, comp, part[s * MN + idx]);
  out[idx] = __float2bfloat16(acc);
}

template <typename TS, int STAGES, bool kFast>
cudaError_t launch_decode(const bf16* x, const uint8_t* q, const TS* scale, const TS* zero,
                          bf16* out, float* part, int M, int N, int K, int group, int per,
                          int splits, int vec_w, int vec_x, cudaStream_t stream) {
  constexpr int bytes = STAGES * DecLayout<TS>::kStage;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_decode_kernel<TS, STAGES, kFast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + kDecBN - 1) / kDecBN, (M + kDecM - 1) / kDecM, splits);
  int4_decode_kernel<TS, STAGES, kFast><<<grid, kDecThreads, bytes, stream>>>(
      x, q, scale, zero, out, part, M, N, K, group, per, vec_w, vec_x);
  return cudaGetLastError();
}

template <typename TS, bool kFast>
cudaError_t launch_prefill(const bf16* x, const uint8_t* q, const TS* scale, const TS* zero,
                           bf16* out, float* part, int M, int N, int K, int group, int per,
                           int splits, int vec_w, int vec_x, cudaStream_t stream) {
  constexpr int bytes = PreLayout<TS>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_prefill_kernel<TS, kFast>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + kPreBN - 1) / kPreBN, (M + kPreBM - 1) / kPreBM, splits);
  int4_prefill_kernel<TS, kFast><<<grid, kPreThreads, bytes, stream>>>(
      x, q, scale, zero, out, part, M, N, K, group, per, vec_w, vec_x);
  return cudaGetLastError();
}

template <typename TS, bool kFast>
cudaError_t run_group(int kind, const bf16* x, const uint8_t* q, const TS* scale,
                      const TS* zero, bf16* out, float* part, int M, int N, int K, int group,
                      int per, int splits, int stages, int vec_w, int vec_x,
                      cudaStream_t stream) {
  switch (kind == 1 ? 1 : 10 + stages) {
    case 1:
      return launch_prefill<TS, kFast>(x, q, scale, zero, out, part, M, N, K, group, per,
                                       splits, vec_w, vec_x, stream);
    case 12:
      return launch_decode<TS, 2, kFast>(x, q, scale, zero, out, part, M, N, K, group, per,
                                         splits, vec_w, vec_x, stream);
    case 13:
      return launch_decode<TS, 3, kFast>(x, q, scale, zero, out, part, M, N, K, group, per,
                                         splits, vec_w, vec_x, stream);
    case 14:
      return launch_decode<TS, 4, kFast>(x, q, scale, zero, out, part, M, N, K, group, per,
                                         splits, vec_w, vec_x, stream);
    case 16:
      return launch_decode<TS, 6, kFast>(x, q, scale, zero, out, part, M, N, K, group, per,
                                         splits, vec_w, vec_x, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Groups that are a multiple of 16 take the fast kernels (scales staged,
// read once per group); any other group the slow exact path.
template <typename TS>
cudaError_t run(int kind, const void* x, const void* q, const void* scale, const void* zero,
                void* out, float* part, int M, int N, int K, int group, int splits,
                int stages, int vec_w, int vec_x, cudaStream_t stream) {
  const int n_tiles = (K + kKT - 1) / kKT;
  const int per = (n_tiles + splits - 1) / splits;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const TS* sb = static_cast<const TS*>(scale);
  const TS* zb = static_cast<const TS*>(zero);
  bf16* ob = static_cast<bf16*>(out);
  const cudaError_t err =
      group % 16 == 0
          ? run_group<TS, true>(kind, xb, qb, sb, zb, ob, part, M, N, K, group, per, splits,
                                stages, vec_w, vec_x, stream)
          : run_group<TS, false>(kind, xb, qb, sb, zb, ob, part, M, N, K, group, per, splits,
                                 stages, vec_w, vec_x, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long MN = (long long)M * N;
  combine_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(part, ob, MN, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). x and out bf16; scale_bf16:
// 1 = bf16 scale and zero, 0 = f32. kind: 0 = int4_decode (16-row M
// tiles, `stages` ring stages of 2, 3, 4 or 6), 1 = int4_prefill (128 x
// 128 tiles; `stages` unused). K must be even and `group` must divide it.
// splits > 1 cuts the 64-row k-tiles into that many runs and needs
// `partials`, f32 scratch of splits * M * N values. The launches are
// asynchronous on `stream`.
int llmq_int4_matmul_tc(const void* x, const void* q, const void* scale, const void* zero,
                        void* out, void* partials, int scale_bf16, int kind, int M, int N,
                        int K, int group, int splits, int stages, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0 || K % 2 || group < 1 || K % group || splits < 1 ||
      (splits > 1 && partials == nullptr) || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_w = aligned(q) && aligned(scale) && aligned(zero) && N % 16 == 0;
  const int vec_x = aligned(x) && K % 8 == 0;
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      scale_bf16 ? run<bf16>(kind, x, q, scale, zero, out, part, M, N, K, group, splits, stages,
                             vec_w, vec_x, st)
                 : run<float>(kind, x, q, scale, zero, out, part, M, N, K, group, splits,
                              stages, vec_w, vec_x, st);
  return (int)err;
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
