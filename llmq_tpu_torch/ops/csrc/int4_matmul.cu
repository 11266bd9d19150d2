// Weight-only int4 group matmul (K7) for Hopper, sm_90a.
//
// Replaces: llmq_tpu/ops/pallas_matmul.py, int4_matmul_pallas (kernel body
// _int4_matmul_kernel). Plain version: llmq_tpu_torch/ops/matmul.py,
// int4_matmul.
//
// Contract: out[M, N] = x[M, K] @ w[K, N] in x's dtype (f32 or bf16), where
// w[k, n] = (code(k, n) - zero[g, n]) * scale[g, n] with g = k / group,
// group = K / G. q [K/2, N] uint8 packs two 4-bit codes per byte along K:
// the even row in the low nibble, the odd row in the high one. scale and
// zero [G, N] are f32 or bf16 (both the same). Each weight element is
// rebuilt in f32, as models/quant.py::dequantize_int4_parts does, and
// rounded to the activation dtype; the products are summed in f32 with
// Kahan compensation across K tiles (quant_matmul.cuh). The K tiles of
// kBK = 32 rows align with groups: the group is a power of two (128, or
// gcd(K, 128) for small K), so a tile lies inside one group or holds
// whole ones.
//
// Bound on the H100: at decode sizes (M = 16) the weight bytes, half a
// byte a weight plus the groups' scales and zeros; at prefill sizes the
// operations, which this first kernel runs on the CUDA cores (see
// int8_matmul.cu). The design: a tile of 16 packed rows x 64 columns is
// read as one 4-byte vector a thread (4 columns, 2 rows each), decoded in
// registers while the previous tile is multiplied, and stored to shared
// memory as f32. Later work, not done here: mma/wgmma, TMA.

#include "quant_matmul.cuh"

namespace {

using qmm::kBK;
using qmm::kBN;
using qmm::kThreads;

template <typename TX, typename TS>
struct Int4Weights {
  const uint8_t* __restrict__ q;
  const TS* __restrict__ scale;
  const TS* __restrict__ zero;
  int K, N, group;
  bool vec;  // packed rows start 4-byte aligned: q aligned and N % 4 == 0

  // Thread tid holds packed row tid / 16 (tile rows 2r and 2r + 1) and
  // columns 4 (tid % 16) .. + 3: v[0..3] the even row, v[4..7] the odd one.
  struct Frag {
    float v[8];
  };
  static_assert(kBK / 2 * kBN == kThreads * 4, "one 4-byte vector a thread");

  __device__ __forceinline__ void fetch(Frag& f, int k0, int n0, int tid) const {
    const int pr = tid >> 4, c = (tid & 15) * 4;
    const int kp = k0 / 2 + pr, n = n0 + c;
    const int k_even = 2 * kp;
    uint8_t b[4];
    if (vec && k_even < K && n + 4 <= N) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(q + (long long)kp * N + n);
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = (uint8_t)(u >> (8 * e));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[e] = (k_even < K && n + e < N) ? q[(long long)kp * N + n + e] : (uint8_t)0;
    }
    const long long g_even = (long long)(k_even / group) * N;
    const long long g_odd = (long long)((k_even + 1) / group) * N;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k_even < K && n + e < N) {
        const float lo = (float)(b[e] & 0xF), hi = (float)(b[e] >> 4);
        f.v[e] = qmm::round_to<TX>((lo - qmm::to_f32(zero[g_even + n + e])) *
                                   qmm::to_f32(scale[g_even + n + e]));
        f.v[4 + e] = qmm::round_to<TX>((hi - qmm::to_f32(zero[g_odd + n + e])) *
                                       qmm::to_f32(scale[g_odd + n + e]));
      } else {
        f.v[e] = f.v[4 + e] = 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(const Frag& f, float (*ws)[kBN], int tid) const {
    const int pr = tid >> 4, c = (tid & 15) * 4;
    *reinterpret_cast<float4*>(&ws[2 * pr][c]) = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
    *reinterpret_cast<float4*>(&ws[2 * pr + 1][c]) = make_float4(f.v[4], f.v[5], f.v[6], f.v[7]);
  }
  // The groups' scales are already in the weights: the sum is the output.
  __device__ __forceinline__ float col_scale(int) const { return 1.f; }
};

template <typename TX, typename TS>
cudaError_t run(const void* x, const void* q, const void* scale, const void* zero, void* out,
                void* partials, int M, int N, int K, int group, int splits,
                cudaStream_t stream) {
  Int4Weights<TX, TS> w{static_cast<const uint8_t*>(q), static_cast<const TS*>(scale),
                        static_cast<const TS*>(zero), K, N, group,
                        reinterpret_cast<uintptr_t>(q) % 4 == 0 && N % 4 == 0};
  return qmm::launch<TX>(x, w, out, partials, M, N, K, splits, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). dtype flags: 1 = bf16, 0 = f32.
// K must be even and `group` must divide it (G = K / group rows of scale
// and zero). splits > 1 cuts the K tiles into that many runs and needs
// `partials`, f32 scratch of splits * M * N values. The launches are
// asynchronous on `stream`.
int llmq_int4_matmul(const void* x, const void* q, const void* scale, const void* zero,
                     void* out, void* partials, int x_bf16, int scale_bf16, int M, int N,
                     int K, int group, int splits, void* stream) {
  if (K % 2 || group < 1 || K % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && scale_bf16)
    err = run<__nv_bfloat16, __nv_bfloat16>(x, q, scale, zero, out, partials, M, N, K, group,
                                            splits, st);
  else if (x_bf16)
    err = run<__nv_bfloat16, float>(x, q, scale, zero, out, partials, M, N, K, group, splits,
                                    st);
  else if (scale_bf16)
    err = run<float, __nv_bfloat16>(x, q, scale, zero, out, partials, M, N, K, group, splits,
                                    st);
  else
    err = run<float, float>(x, q, scale, zero, out, partials, M, N, K, group, splits, st);
  return (int)err;
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
