// Paged decode attention (K1) for Hopper, sm_90a.
//
// Replaces: llmq_tpu/ops/pallas_attention.py, paged_decode_attention_pallas
// (kernel body _paged_decode_kernel). Plain version:
// llmq_tpu_torch/ops/attention.py, paged_decode_attention.
//
// Contract: one query row per sequence, q [S, H, D], against that
// sequence's pages of the layer-stacked pool [L, P, page, n_kv, D],
// addressed through block_tables [S, pages_per_seq] and a layer index.
// context_lens [S] includes the new token; keys in
// [max(0, ctx - window), ctx) attend. Scores are scaled, take an
// optional tanh softcap (applied before the mask), and go through an
// online softmax in f32; q, k and v are upcast to f32 as the TPU kernel
// does. The pool is f32, bf16 or float8_e5m2 (an fp8 KV cache: each
// element widens exactly, to the query dtype's value and on to f32).
// GQA: the group = H / n_kv query heads of one KV head share it.
// A row with ctx == 0 writes exact zeros. The output has q's dtype.
//
// Bound on the H100: the KV bytes read. Each live key and value row is
// read once per (sequence, KV head) and reused by all `group` query
// heads; the work is ~2 * group FLOPs per byte, far below the ~295
// FLOP/byte at which the tensor cores would be the limit. The design
// follows from that:
//   * one block per (sequence, KV head, split), D threads, so a group's
//     query heads read each K/V row once;
//   * split-KV: a row's live keys are cut into `num_splits` spans, one
//     block each, so a batch of 16 rows still fills the 132 SMs; a small
//     combine kernel merges the spans' (acc, max, sum) partials;
//   * the loop visits only live keys, [max(0, ctx - window), ctx): the
//     TPU kernel's fixed grid fetched dead pages, this loop never does;
//   * pool rows are addressed in place, ((layer*P + page)*page + t)*n_kv
//     + g; the pool is never sliced or copied per layer;
//   * a tile of 32 K and V rows is loaded by all threads at once
//     (thread d reads column d of every row: coalesced, independent
//     loads), then scored from shared memory, one (head, key) pair per
//     thread, with a row pitch of D + 1 words so no two lanes share a bank.
// Later work, not done here: cp.async/TMA double buffering of the tiles
// and bf16 tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // never -inf: keeps the softmax NaN-free
constexpr int kTile = 32;          // keys per online-softmax step
constexpr int kMaxGroup = 16;      // query heads per KV head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  // e5m2 is the top byte of an fp16: the widening is exact.
  return __half2float(__ushort_as_half((unsigned short)((unsigned)x.__x << 8)));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // q rows, K tile, V tile (pitch D + 1), probabilities, m / l / alpha
  // (3 * kMaxGroup floats keep the row offsets after them 8-byte aligned),
  // the tile's row offsets.
  return sizeof(float) * ((size_t)kMaxGroup * D + 2 * (size_t)kTile * (D + 1) +
                          (size_t)kMaxGroup * kTile + 3 * kMaxGroup) +
         sizeof(long long) * kTile;
}

// Grid (S, n_kv, num_splits), block D threads. Split z of a row walks its
// share of the live keys; thread d owns output column d of every query
// head of the group. With one split the block writes the output; with
// more it writes its unnormalised partial (acc, m, l) for the combine.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, TQ* __restrict__ out,
    float* __restrict__ part, int n_heads, int n_kv, int num_pages, int page_size,
    int pages_per_seq, int layer, int window, float scale, float softcap) {
  constexpr int LD = D + 1;  // tile row pitch: lanes on 32 rows hit 32 banks
  constexpr int kWarps = D / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kMaxGroup][D]
  float* k_s = q_s + kMaxGroup * D;     // [kTile][LD]
  float* v_s = k_s + kTile * LD;        // [kTile][LD]
  float* p_s = v_s + kTile * LD;        // [kMaxGroup][kTile]
  float* m_s = p_s + kMaxGroup * kTile; // [kMaxGroup]
  float* l_s = m_s + kMaxGroup;
  float* a_s = l_s + kMaxGroup;
  long long* row_s = reinterpret_cast<long long*>(a_s + kMaxGroup);  // [kTile]

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int num_splits = gridDim.z;
  const int group = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long ctx = context_lens[s];
  const long long max_ctx = (long long)pages_per_seq * page_size;
  const long long hi_row = ctx < max_ctx ? ctx : max_ctx;
  long long lo_row = ctx - (long long)window;  // signed: window may be huge
  if (lo_row < 0) lo_row = 0;
  // This split's share of the live keys, in whole tiles.
  long long span = hi_row > lo_row ? (hi_row - lo_row + num_splits - 1) / num_splits : 0;
  span = (span + kTile - 1) / kTile * kTile;
  const long long lo = lo_row + split * span;
  const long long hi = lo + span < hi_row ? lo + span : hi_row;

  const long long q_row0 = (long long)s * n_heads + (long long)g * group;
  for (int h = 0; h < group; ++h) q_s[h * D + tid] = to_f32(q[(q_row0 + h) * D + tid]);
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) acc[h] = 0.f;

  const int* bt = block_tables + (long long)s * pages_per_seq;
  const long long layer_base = (long long)layer * num_pages;

  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    const int n_valid = (int)((hi - t0) < kTile ? (hi - t0) : kTile);
    __syncthreads();  // the previous tile's readers are done
    // 1. K and V rows of the tile into shared memory. The tile's row
    // offsets come first (one block-table read per key, in parallel),
    // then thread d loads column d of every row: 2 * kTile independent,
    // coalesced loads in flight per thread.
    if (tid < kTile) {
      const int t = (int)t0 + tid;  // ctx is int32, so t fits
      row_s[tid] = tid < n_valid
          ? (((layer_base + bt[t / page_size]) * page_size + t % page_size) * n_kv + g) * D
          : 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < n_valid) {
        const long long row = row_s[j];
        k_s[j * LD + tid] = to_f32(k_pool[row + tid]);
        v_s[j * LD + tid] = to_f32(v_pool[row + tid]);
      }
    }
    __syncthreads();
    // 2. Scores: one (head, key) pair per thread and pass.
    for (int pidx = tid; pidx < group * kTile; pidx += D) {
      const int h = pidx / kTile, j = pidx % kTile;
      if (j < n_valid) {
        const float* qr = q_s + h * D;
        const float* kr = k_s + j * LD;
        float dot = 0.f;
#pragma unroll 16
        for (int e = 0; e < D; ++e) dot += qr[e] * kr[e];
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);  // before the mask
        p_s[h * kTile + j] = sc;
      }
    }
    __syncthreads();
    // 3. Online softmax update: one warp per query head, a lane per key.
    for (int h = warp; h < group; h += kWarps) {
      const bool valid = lane < n_valid;
      const float sc = valid ? p_s[h * kTile + lane] : kNegInf;
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float tot = warp_sum(p);
      p_s[h * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[h] = alpha;
        l_s[h] = alpha * l_s[h] + tot;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    // 4. P.V: thread d accumulates column d of every query head.
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h)
      if (h < group) acc[h] *= a_s[h];
    for (int j = 0; j < n_valid; ++j) {
      const float vv = v_s[j * LD + tid];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < group) acc[h] += p_s[h * kTile + j] * vv;
    }
  }
  __syncthreads();

#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h < group) {
      const long long r = q_row0 + h;
      if (num_splits == 1) {
        float l = l_s[h];
        if (l == 0.f) l = 1.f;  // ctx == 0: acc is 0, the output exact zeros
        out[r * D + tid] = from_f32<TQ>(acc[h] / l);
      } else {
        float* pr = part + (r * num_splits + split) * (D + 2);
        pr[tid] = acc[h];
        if (tid == 0) {
          pr[D] = m_s[h];
          pr[D + 1] = l_s[h];
        }
      }
    }
  }
}

// Grid (S * H), block D: merges the splits' partials of one query row.
template <typename TQ, int D>
__global__ void __launch_bounds__(D) combine_kernel(const float* __restrict__ part,
                                                    TQ* __restrict__ out, int num_splits) {
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pr = part + r * num_splits * (D + 2);
  float m = kNegInf;
  for (int k = 0; k < num_splits; ++k) m = fmaxf(m, pr[k * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int k = 0; k < num_splits; ++k) {
    const float w = expf(pr[k * (D + 2) + D] - m);
    num += w * pr[k * (D + 2) + tid];
    den += w * pr[k * (D + 2) + D + 1];
  }
  if (den == 0.f) den = 1.f;  // ctx == 0: every split empty, exact zeros
  out[r * D + tid] = from_f32<TQ>(num / den);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* bt, const int* ctx, void* out, float* part, int num_seqs,
                   int n_heads, int n_kv, int num_pages, int page_size,
                   int pages_per_seq, int layer, int window, float scale,
                   float softcap, int num_splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(num_seqs, n_kv, num_splits);
  paged_decode_kernel<TQ, TKV, D><<<grid, D, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), bt, ctx, static_cast<TQ*>(out), part, n_heads,
      n_kv, num_pages, page_size, pages_per_seq, layer, window, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_splits == 1) return err;
  combine_kernel<TQ, D><<<num_seqs * n_heads, D, 0, stream>>>(part, static_cast<TQ*>(out),
                                                             num_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dim(int head_dim, const void* q, const void* k_pool,
                       const void* v_pool, const int* bt, const int* ctx,
                       void* out, float* part, int num_seqs, int n_heads, int n_kv,
                       int num_pages, int page_size, int pages_per_seq,
                       int layer, int window, float scale, float softcap,
                       int num_splits, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<TQ, TKV, 64>(q, k_pool, v_pool, bt, ctx, out, part, num_seqs, n_heads,
                                 n_kv, num_pages, page_size, pages_per_seq, layer, window,
                                 scale, softcap, num_splits, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k_pool, v_pool, bt, ctx, out, part, num_seqs, n_heads,
                                  n_kv, num_pages, page_size, pages_per_seq, layer, window,
                                  scale, softcap, num_splits, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k_pool, v_pool, bt, ctx, out, part, num_seqs, n_heads,
                                  n_kv, num_pages, page_size, pages_per_seq, layer, window,
                                  scale, softcap, num_splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). q_bf16: 1 = bf16, 0 = f32;
// kv_dtype: 0 = f32, 1 = bf16, 2 = float8_e5m2. softcap <= 0 means no
// softcap. num_splits > 1 splits each row's keys over
// that many blocks and needs `partials`, f32 scratch of
// num_seqs * n_heads * num_splits * (head_dim + 2) values. The launches are
// asynchronous on `stream`.
int llmq_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                      const void* block_tables, const void* context_lens,
                      void* out, void* partials, int q_bf16, int kv_dtype, int num_seqs,
                      int n_heads, int n_kv, int head_dim, int num_pages,
                      int page_size, int pages_per_seq, int layer, int window,
                      float scale, float softcap, int num_splits, void* stream) {
  if (num_seqs == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxGroup || num_splits < 1 ||
      (num_splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto q_type, auto kv_type) {
    using TQ = decltype(q_type);
    using TKV = decltype(kv_type);
    return launch_dim<TQ, TKV>(head_dim, q, k_pool, v_pool, bt, ctx, out, part, num_seqs,
                               n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                               window, scale, softcap, num_splits, st);
  };
  cudaError_t err;
  switch (kv_dtype) {
    case 0:
      err = q_bf16 ? run(__nv_bfloat16(), float()) : run(float(), float());
      break;
    case 1:
      err = q_bf16 ? run(__nv_bfloat16(), __nv_bfloat16()) : run(float(), __nv_bfloat16());
      break;
    case 2:
      err = q_bf16 ? run(__nv_bfloat16(), __nv_fp8_e5m2()) : run(float(), __nv_fp8_e5m2());
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
