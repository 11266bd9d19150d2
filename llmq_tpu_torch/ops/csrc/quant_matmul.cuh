// Shared tiling of the weight-only quantized matmul kernels (K6, K7) for
// Hopper, sm_90a: the contraction loop, the Kahan accumulation and the
// split-K combine. The weight's decoding is the one part that differs; it
// lives in a loader type in int8_matmul.cu (K6) and int4_matmul.cu (K7).
//
// Output tile: BM x kBN (BM = 16 for decode-sized M, 64 otherwise), one
// block of 256 threads; thread (ty, tx) owns rows ty + 16 i and the four
// adjacent columns 4 tx .. 4 tx + 3. A loop walks the block's K tiles of
// kBK rows: the activation tile is stored transposed in shared memory as
// f32, the weight tile decoded to f32 (the values the activation dtype
// holds) beside it; the next tile's global loads are in registers while
// the current tile is multiplied on the CUDA cores. Each K tile's partial
// product is a plain f32 FMA chain of kBK terms; it is added into the
// accumulator with Kahan compensation, as the TPU kernels' _kahan_add
// does across K blocks, so the compiler must not reassociate (no
// --use_fast_math). Ragged M, N and K are masked here: nothing pads the
// weight.
//
// Split-K: a grid of few output tiles (decode: M = 16) cannot fill 132
// SMs, so the wrapper may cut the K tiles into `splits` contiguous runs,
// one block each. A split writes its f32 sum to scratch, and a combine
// kernel adds the splits in order with the same compensation and applies
// the epilogue (K6's per-column scale, once, in f32). With one split the
// block applies the epilogue itself.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // contraction rows per tile
constexpr int kThreads = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the dtype T holds, as f32 (the MXU operand's value).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ void kahan_add(float& acc, float& comp, float p) {
  const float y = p - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// Registers of one thread's share of an activation tile (BM x kBK).
template <typename TX, int BM>
struct XFrag {
  static constexpr int kN = BM * kBK / kThreads;
  float v[kN];

  __device__ __forceinline__ void fetch(const TX* __restrict__ x, int M, int K, int m0, int k0,
                                        int tid) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / kBK, c = idx % kBK;  // a warp reads one row's kBK values
      const int m = m0 + r, k = k0 + c;
      v[e] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
  }
  __device__ __forceinline__ void store(float (*xs)[BM + 1], int tid) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int idx = tid + e * kThreads;
      xs[idx % kBK][idx / kBK] = v[e];  // transposed; pitch BM + 1: no bank conflict
    }
  }
};

// Grid (ceil(N / kBN), ceil(M / BM), splits). Loader: the weight
// (typename Loader::Frag, fetch(frag, k0, n0, tid), store(frag, ws, tid),
// col_scale(n)).
template <typename TX, int BM, typename Loader>
__global__ void __launch_bounds__(kThreads) qmm_kernel(const TX* __restrict__ x, Loader w,
                                                      TX* __restrict__ out,
                                                      float* __restrict__ part, int M, int N,
                                                      int K, int tiles_per_split) {
  constexpr int RM = BM / 16;
  __shared__ float xs[kBK][BM + 1];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int n_tiles = (K + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = t_begin + tiles_per_split < n_tiles ? t_begin + tiles_per_split : n_tiles;

  float acc[RM][4], comp[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = comp[i][j] = 0.f;

  XFrag<TX, BM> xf;
  typename Loader::Frag wf;
  if (t_begin < t_end) {
    xf.fetch(x, M, K, m0, t_begin * kBK, tid);
    w.fetch(wf, t_begin * kBK, n0, tid);
  }
  for (int t = t_begin; t < t_end; ++t) {
    xf.store(xs, tid);
    w.store(wf, ws, tid);
    __syncthreads();
    if (t + 1 < t_end) {  // in flight while this tile is multiplied
      xf.fetch(x, M, K, m0, (t + 1) * kBK, tid);
      w.fetch(wf, (t + 1) * kBK, n0, tid);
    }
    float p[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xv = xs[kk][ty + 16 * i];
        p[i][0] = fmaf(xv, wv.x, p[i][0]);
        p[i][1] = fmaf(xv, wv.y, p[i][1]);
        p[i][2] = fmaf(xv, wv.z, p[i][2]);
        p[i][3] = fmaf(xv, wv.w, p[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kahan_add(acc[i][j], comp[i][j], p[i][j]);
    __syncthreads();  // the tile is read out before the next one is stored
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      if (gridDim.z == 1)
        out[(long long)m * N + n] = from_f32<TX>(acc[i][j] * w.col_scale(n));
      else
        part[((long long)blockIdx.z * M + m) * N + n] = acc[i][j];
    }
  }
}

// Grid over M * N outputs: the splits' sums added in order, compensated,
// then the epilogue.
template <typename TX, typename Loader>
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ part, Loader w,
                                                     TX* __restrict__ out, int M, int N,
                                                     int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long MN = (long long)M * N;
  if (idx >= MN) return;
  float acc = 0.f, comp = 0.f;
  for (int s = 0; s < splits; ++s) kahan_add(acc, comp, part[s * MN + idx]);
  out[idx] = from_f32<TX>(acc * w.col_scale((int)(idx % N)));
}

template <typename TX, int BM, typename Loader>
cudaError_t launch_bm(const void* x, const Loader& w, void* out, float* part, int M, int N,
                      int K, int splits, cudaStream_t stream) {
  const int n_tiles = (K + kBK - 1) / kBK;
  const int per = (n_tiles + splits - 1) / splits;
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  qmm_kernel<TX, BM, Loader><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), w, static_cast<TX*>(out), part, M, N, K, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long MN = (long long)M * N;
  combine_kernel<TX, Loader><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      part, w, static_cast<TX*>(out), M, N, splits);
  return cudaGetLastError();
}

// Checks shared by the two entry points, then the launch at the block
// height that suits M.
template <typename TX, typename Loader>
cudaError_t launch(const void* x, const Loader& w, void* out, void* partials, int M, int N,
                   int K, int splits, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K < 0 || splits < 1 || (splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  if (M <= 16) return launch_bm<TX, 16, Loader>(x, w, out, part, M, N, K, splits, stream);
  return launch_bm<TX, 64, Loader>(x, w, out, part, M, N, K, splits, stream);
}

}  // namespace qmm
