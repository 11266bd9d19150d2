// Paged chunked-prefill attention (K3), exact route, for Hopper, sm_90a.
//
// Replaces: llmq_tpu/ops/pallas_attention.py, paged_prefill_attention_pallas
// (kernel body _paged_prefill_kernel). Plain version:
// llmq_tpu_torch/ops/attention.py, paged_prefill_attention. This source
// serves f32 q over any pool and bf16 q over an f32 pool (the math
// promotes to f32), exactly; bf16 q over a bf16 or e5m2 pool runs on the
// tensor cores in paged_prefill_tc.cu (cuda_attention.prefill_route
// chooses by dtype).
//
// Contract: C chunk queries per row, q [B, C, H, D] (read through its
// batch, time and head strides; the head dimension contiguous), against
// the row's pages of the layer-stacked pool [L, P, page, n_kv, D], which
// already hold the chunk's own K/V (the model writes them first, on the
// same stream). A row's valid queries are a leading contiguous run given
// as (chunk_start[b], num_valid[b]): query t < num_valid sits at absolute
// position chunk_start + t and attends cached keys in
// (pos - window, pos], read through block_tables [B, pages_per_seq] at
// layer `layer`. Scores are scaled, take an optional tanh softcap (before
// the mask) and go through an online softmax in f32. Products are taken
// in the promoted dtype of q and the pool (_mul_dtype: an f32 pool
// promotes, a float8_e5m2 pool widens exactly to q's dtype), summed in f32 (bf16 x bf16
// products are exact in f32, as the TPU kernel's
// preferred_element_type=f32); probabilities stay in the promoted dtype,
// f32 on this route, before P.V, as the TPU kernel does. GQA: head h reads KV head
// h / (H / n_kv), no repeat. Query rows past num_valid are padding: the
// kernel writes zeros there (the plain version leaves a finite average);
// callers never read them. The output [B, C, H, D] is contiguous, in q's
// dtype.
//
// Bound on the H100: a chunk of C queries over a context of N keys moves
// its q/out rows and the live K/V rows once and does ~4 * C * N * H * D
// flops. At the prefix-cache serve's shapes (qwen2.5-3b, 16 query heads
// over 2 KV heads, ~100-256 queries at contexts ~1,100) that is 400-700
// FLOP per byte, above the ~295 FLOP/byte ridge of the bf16 tensor
// cores: the operations bound it, the bytes only at short contexts. This
// kernel is K2's exact tiled design on the CUDA cores:
//   * grid (ceil(C/64), H, B); a 64-query tile stays in shared memory
//     while a loop walks 64-key tiles of the paged cache (the TPU grid's
//     page axis becomes this loop);
//   * the loop covers only keys in [max(0, first query pos - window + 1),
//     last valid query pos]: the counterpart of _kv_index's clamp, so
//     dead pages cost no load; an all-padding query tile returns at once;
//   * each key tile first resolves its 64 pool row offsets through the
//     block table into shared memory (chunk_start need not be page
//     aligned: after a prefix hit a chunk starts mid-page), then every
//     thread loads contiguous head rows from those offsets;
//   * tiles are held as f32 with a row pitch of D + 1 words.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // running-max seed, as in the TPU kernel
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each

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
  // q tile, K tile, V tile (pitch D + 1), scores (pitch kBK + 1),
  // m / l / alpha, then the key tile's pool row offsets.
  return sizeof(float) *
             ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) + (size_t)kBQ * (kBK + 1) +
              3 * kBQ) +
         sizeof(long long) * kBK;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ chunk_start, const int* __restrict__ num_valid,
    TQ* __restrict__ out, int chunk, int n_heads, int n_kv, int num_pages, int page_size,
    int pages_per_seq, int layer, long long q_sb, long long q_st, long long q_sh,
    int window, float scale, float softcap) {
  constexpr int LD = D + 1;    // tile row pitch (words)
  constexpr int LP = kBK + 1;  // score row pitch (words)
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;             // [kBQ][LD]
  float* k_s = q_s + kBQ * LD;   // [kBK][LD]
  float* v_s = k_s + kBK * LD;   // [kBK][LD]
  float* p_s = v_s + kBK * LD;   // [kBQ][LP] scores, then probabilities
  float* m_s = p_s + kBQ * LP;   // [kBQ] running max
  float* l_s = m_s + kBQ;        // [kBQ] running denominator
  float* a_s = l_s + kBQ;        // [kBQ] rescale factor of this tile
  long long* row_s = reinterpret_cast<long long*>(a_s + kBQ);  // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int nv = num_valid[b];
  if (nv > chunk) nv = chunk;

  const TQ* qb = q + b * q_sb + h * q_sh;
  const long long o_st = (long long)n_heads * D;
  TQ* ob = out + (long long)b * chunk * o_st + (long long)h * D;

  if (q0 >= nv) {  // all-padding query tile
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      if (q0 + r < chunk) ob[(q0 + r) * o_st + c] = from_f32<TQ>(0.f);
    }
    return;
  }
  const int n_here = nv - q0 < kBQ ? nv - q0 : kBQ;  // valid queries of this tile

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    q_s[r * LD + c] = r < n_here ? to_f32(qb[(long long)(q0 + r) * q_st + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // Live keys of this tile: [first query pos - window + 1, last query pos].
  const long long pos0 = (long long)chunk_start[b] + q0;  // query row 0's position
  const long long max_ctx = (long long)pages_per_seq * page_size;
  long long k_lo = pos0 - (long long)window + 1;
  if (k_lo < 0) k_lo = 0;
  long long k_hi = pos0 + n_here;  // one past the last query's position
  if (k_hi > max_ctx) k_hi = max_ctx;
  const int* bt = block_tables + (long long)b * pages_per_seq;
  const long long layer_base = (long long)layer * num_pages;

  for (long long k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int n_k = (int)(k_hi - k0 < kBK ? k_hi - k0 : kBK);
    __syncthreads();  // the previous tile's readers are done
    if (tid < kBK) {
      const long long kpos = k0 + tid;
      row_s[tid] = tid < n_k
          ? (((layer_base + bt[kpos / page_size]) * page_size + kpos % page_size) * n_kv +
             kvh) * D
          : -1;
    }
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const long long row = row_s[r];
      k_s[r * LD + c] = row >= 0 ? to_f32(k_pool[row + c]) : 0.f;
      v_s[r * LD + c] = row >= 0 ? to_f32(v_pool[row + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16i, columns tx + 16j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const long long qpos = pos0 + r, kpos = k0 + c;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before the mask
        const bool ok = r < n_here && c < n_k && kpos <= qpos && kpos > qpos - (long long)window;
        p_s[r * LP + c] = ok ? x : -INFINITY;  // -inf marks "masked" here only
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, a lane two columns.
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * 8 + rr;
      const float x0 = p_s[r * LP + lane];
      const float x1 = p_s[r * LP + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float e0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      const float e1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      const float tot = warp_sum(e0 + e1);
      p_s[r * LP + lane] = e0;  // the promoted dtype is f32 on this route
      p_s[r * LP + lane + 32] = e1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + tot;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16i, columns tx + 16j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < n_k; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = v_s[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= chunk) continue;
    float l = l_s[r];
    if (l == 0.f) l = 1.f;
    const bool valid = r < n_here;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      ob[(q0 + r) * o_st + c] = from_f32<TQ>(valid ? acc[i][j] / l : 0.f);
    }
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                   const int* start, const int* nvalid, void* out, int batch, int chunk,
                   int n_heads, int n_kv, int num_pages, int page_size, int pages_per_seq,
                   int layer, const long long* q_strides, int window, float scale,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(paged_prefill_kernel<TQ, TKV, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((chunk + kBQ - 1) / kBQ, n_heads, batch);
  paged_prefill_kernel<TQ, TKV, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), bt, start, nvalid, static_cast<TQ*>(out), chunk,
      n_heads, n_kv, num_pages, page_size, pages_per_seq, layer, q_strides[0], q_strides[1],
      q_strides[2], window, scale, softcap);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dim(int head_dim, const void* q, const void* k_pool, const void* v_pool,
                       const int* bt, const int* start, const int* nvalid, void* out,
                       int batch, int chunk, int n_heads, int n_kv, int num_pages,
                       int page_size, int pages_per_seq, int layer,
                       const long long* q_strides, int window, float scale, float softcap,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<TQ, TKV, 64>(q, k_pool, v_pool, bt, start, nvalid, out, batch, chunk,
                                 n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                                 q_strides, window, scale, softcap, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k_pool, v_pool, bt, start, nvalid, out, batch, chunk,
                                  n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                                  q_strides, window, scale, softcap, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k_pool, v_pool, bt, start, nvalid, out, batch, chunk,
                                  n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                                  q_strides, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). q_bf16: 1 = bf16, 0 = f32;
// kv_dtype: 0 = f32, 1 = bf16, 2 = float8_e5m2; bf16 q takes only an f32
// pool here (the tensor-core route takes the others). q strides in elements
// (batch, time, head). softcap <= 0 means no softcap. The launch is
// asynchronous on `stream`.
int llmq_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* chunk_start,
                       const void* num_valid, void* out, int q_bf16, int kv_dtype, int batch,
                       int chunk, int n_heads, int n_kv, int head_dim, int num_pages,
                       int page_size, int pages_per_seq, int layer, long long q_sb,
                       long long q_st, long long q_sh, int window, float scale,
                       float softcap, void* stream) {
  if (batch == 0 || chunk == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || window < 1) return (int)cudaErrorInvalidValue;
  const long long q_strides[3] = {q_sb, q_st, q_sh};
  const int* bt = static_cast<const int*>(block_tables);
  const int* st = static_cast<const int*>(chunk_start);
  const int* nv = static_cast<const int*>(num_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto q_type, auto kv_type) {
    using TQ = decltype(q_type);
    using TKV = decltype(kv_type);
    return launch_dim<TQ, TKV>(head_dim, q, k_pool, v_pool, bt, st, nv, out, batch, chunk,
                               n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                               q_strides, window, scale, softcap, s);
  };
  cudaError_t err;
  switch (kv_dtype) {
    case 0:
      err = q_bf16 ? run(__nv_bfloat16(), float()) : run(float(), float());
      break;
    case 1:
      err = q_bf16 ? cudaErrorInvalidValue : run(float(), __nv_bfloat16());
      break;
    case 2:
      err = q_bf16 ? cudaErrorInvalidValue : run(float(), __nv_fp8_e5m2());
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
