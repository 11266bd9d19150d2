// Weight-only int8 matmul (K6) for Hopper, sm_90a.
//
// Replaces: llmq_tpu/ops/pallas_matmul.py, int8_matmul_pallas (kernel body
// _int8_matmul_kernel). Plain version: llmq_tpu_torch/ops/matmul.py,
// int8_matmul.
//
// Contract: out[M, N] = (x[M, K] @ q[K, N]) * scale[N], in x's dtype
// (f32 or bf16); q int8, row-major; scale f32 or bf16, one per output
// channel. q is read from device memory as int8 and converted on chip
// (an int8 value is exact in bf16, so the products are the activation
// dtype's, exact in f32), the sum is kept in f32 with Kahan compensation
// across K tiles, and the scale is applied once, in f32, after the last
// tile. The tiling, the split-K combine and the masking of ragged edges
// are in quant_matmul.cuh.
//
// Bound on the H100: at decode sizes (M = 16) the weight bytes, 1 byte a
// weight, and these CUDA-core tiles; at prefill sizes (M ~ 1,024) the
// operations, 2 M K N against the tensor cores' dense bf16 rate, which
// this first kernel does not use (its FMAs run on the CUDA cores: ~15x
// below that rate). The design: a weight tile of kBK x 64 bytes is read as
// one 8-byte vector a thread (one tile row per 8 threads), and the next
// tile's loads are in flight while the current one is multiplied.
// Later work, not done here: mma/wgmma on bf16 tiles, TMA, a persistent
// grid.

#include "quant_matmul.cuh"

namespace {

using qmm::kBK;
using qmm::kBN;
using qmm::kThreads;

template <typename TS>
struct Int8Weights {
  const int8_t* __restrict__ q;
  const TS* __restrict__ scale;
  int K, N;
  bool vec;  // rows start 8-byte aligned: q aligned and N % 8 == 0

  // Thread tid holds tile row tid / 8, columns 8 (tid % 8) .. + 7.
  struct Frag {
    float v[8];
  };
  static_assert(kBK * kBN == kThreads * 8, "one 8-byte vector a thread");

  __device__ __forceinline__ void fetch(Frag& f, int k0, int n0, int tid) const {
    const int r = tid >> 3, c = (tid & 7) * 8;
    const int k = k0 + r, n = n0 + c;
    if (vec && k < K && n + 8 <= N) {
      const uint2 u = *reinterpret_cast<const uint2*>(q + (long long)k * N + n);
      const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) f.v[e] = (float)b[e];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f.v[e] = (k < K && n + e < N) ? (float)q[(long long)k * N + n + e] : 0.f;
    }
  }
  __device__ __forceinline__ void store(const Frag& f, float (*ws)[kBN], int tid) const {
    float4* dst = reinterpret_cast<float4*>(&ws[tid >> 3][(tid & 7) * 8]);
    dst[0] = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
    dst[1] = make_float4(f.v[4], f.v[5], f.v[6], f.v[7]);
  }
  __device__ __forceinline__ float col_scale(int n) const { return qmm::to_f32(scale[n]); }
};

template <typename TX, typename TS>
cudaError_t run(const void* x, const void* q, const void* scale, void* out, void* partials,
                int M, int N, int K, int splits, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(q) % 8 == 0 && N % 8 == 0;
  Int8Weights<TS> w{static_cast<const int8_t*>(q), static_cast<const TS*>(scale), K, N, vec};
  return qmm::launch<TX>(x, w, out, partials, M, N, K, splits, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). dtype flags: 1 = bf16, 0 = f32.
// splits > 1 cuts the K tiles into that many runs and needs `partials`,
// f32 scratch of splits * M * N values. The launches are asynchronous on
// `stream`.
int llmq_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                     void* partials, int x_bf16, int scale_bf16, int M, int N, int K,
                     int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && scale_bf16)
    err = run<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, partials, M, N, K, splits, st);
  else if (x_bf16)
    err = run<__nv_bfloat16, float>(x, q, scale, out, partials, M, N, K, splits, st);
  else if (scale_bf16)
    err = run<float, __nv_bfloat16>(x, q, scale, out, partials, M, N, K, splits, st);
  else
    err = run<float, float>(x, q, scale, out, partials, M, N, K, splits, st);
  return (int)err;
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
