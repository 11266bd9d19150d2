// Flash prefill attention (K2), exact route, for Hopper, sm_90a.
//
// Replaces: llmq_tpu/ops/pallas_attention.py, flash_prefill_attention_pallas
// (kernel body _flash_prefill_kernel). Plain version:
// llmq_tpu_torch/ops/attention.py, full_prefill_attention. This source
// serves f32 q/k/v, exactly (the f32 parity of the serving paths holds
// logits within 1e-4, which bf16 or TF32 tensor cores cannot); bf16 runs
// on the tensor cores in flash_prefill_tc.cu (cuda_attention.prefill_route
// chooses by dtype).
//
// Contract: causal self-attention over a right-padded bucket. q is
// [B, T, H, D], k and v are [B, T, n_kv, D], read through their batch,
// time and head strides (the head dimension must be contiguous), so the
// JAX wrapper's transpose and pad are not needed. Per-row ragged
// `lengths`, a sliding window (kpos > qpos - window), an optional tanh
// softcap and GQA (KV head h / (H / n_kv)) are applied in the kernel.
// Products of the input dtype are summed in f32 (bf16 x bf16 products are
// exact in f32, as the Pallas kernel's preferred_element_type=f32);
// softmax statistics stay f32; probabilities are rounded to v's dtype
// before P.V, as the TPU kernel does. Rows past a row's length are
// padding: the kernel writes zeros there (finite, never read).
//
// Bound on the H100: the work per byte grows with the prompt. Each key
// and value row meets up to T queries of each of its H / n_kv heads, so
// prefill attention does ~T/2 * 4 * (H / n_kv) FLOPs per K/V byte pair.
// At the main path's bucket (qwen2.5-3b, T = 224, four ragged prompts)
// that is ~60 FLOP per byte of q, k, v and out, under the ~295 FLOP/byte
// ridge of the bf16 tensor cores: the bytes bound it. Full rows past ~700
// tokens make the bf16 FLOPs the bound. This kernel does not reach the
// tensor cores: it is a simple, exact tiled kernel on the CUDA cores.
//   * grid (ceil(T/64), H, B); a 64-query tile stays in shared memory
//     while a loop walks 64-key tiles, replacing the TPU grid's
//     sequential kv axis;
//   * the loop runs only from the window's first tile to
//     min(q_end, length): tiles outside the causal, length or window
//     frontier cost nothing, and an all-padding query tile returns at once;
//   * tiles are held as f32 with a row pitch of D + 1 words, so the
//     16 distinct key rows a warp reads at one depth hit 16 banks.

#include <cuda_bf16.h>
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
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, int seq_len, int n_heads,
    int n_kv, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int window, float scale,
    float softcap) {
  constexpr int LD = D + 1;   // tile row pitch (words)
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

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int length = lengths[b];
  if (length > seq_len) length = seq_len;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  T* ob = out + b * o_sb + h * o_sh;

  if (q0 >= length) {  // all-padding query tile
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      if (q0 + r < seq_len) ob[(long long)(q0 + r) * o_st + c] = from_f32<T>(0.f);
    }
    return;
  }

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qpos = q0 + r;
    q_s[r * LD + c] = qpos < seq_len ? to_f32(qb[(long long)qpos * q_st + c]) : 0.f;
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

  const int q_last = (q0 + kBQ < length ? q0 + kBQ : length) - 1;
  long long first = (long long)q0 - (long long)window + 1;  // window frontier
  if (first < 0) first = 0;
  const int k_begin = (int)(first / kBK) * kBK;

  for (int k0 = k_begin; k0 <= q_last; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int kpos = k0 + r;
      const bool in = kpos < length;
      k_s[r * LD + c] = in ? to_f32(kb[(long long)kpos * k_st + c]) : 0.f;
      v_s[r * LD + c] = in ? to_f32(vb[(long long)kpos * v_st + c]) : 0.f;
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
        const long long qpos = q0 + r, kpos = k0 + c;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before the mask
        const bool ok = kpos <= qpos && kpos < length && qpos < length &&
                        kpos > qpos - (long long)window;
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
      // P.V multiplies probabilities rounded to v's dtype.
      p_s[r * LP + lane] = to_f32(from_f32<T>(e0));
      p_s[r * LP + lane + 32] = to_f32(from_f32<T>(e1));
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
    for (int c = 0; c < kBK; ++c) {
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
    const int qpos = q0 + r;
    if (qpos >= seq_len) continue;
    float l = l_s[r];
    if (l == 0.f) l = 1.f;
    const bool valid = qpos < length;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      ob[(long long)qpos * o_st + c] = from_f32<T>(valid ? acc[i][j] / l : 0.f);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* out, int batch, int seq_len, int n_heads, int n_kv,
                   const long long* strides, int window, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((seq_len + kBQ - 1) / kBQ, n_heads, batch);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), seq_len, n_heads, n_kv, strides[0], strides[1], strides[2],
      strides[3], strides[4], strides[5], strides[6], strides[7], strides[8], strides[9],
      strides[10], strides[11], window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k, const void* v,
                       const int* lengths, void* out, int batch, int seq_len, int n_heads,
                       int n_kv, const long long* strides, int window, float scale,
                       float softcap, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, batch, seq_len, n_heads, n_kv, strides,
                           window, scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, batch, seq_len, n_heads, n_kv, strides,
                            window, scale, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, out, batch, seq_len, n_heads, n_kv, strides,
                            window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). f32 q, k, v and out.
// strides (elements): q (batch, time, head), k (...), v (...), out (...).
// softcap <= 0 means no softcap. The launch is asynchronous on `stream`.
int llmq_flash_prefill(const void* q, const void* k, const void* v, const void* lengths,
                       void* out, int batch, int seq_len, int n_heads,
                       int n_kv, int head_dim, long long q_sb, long long q_st,
                       long long q_sh, long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh, long long o_sb,
                       long long o_st, long long o_sh, int window, float scale,
                       float softcap, void* stream) {
  if (batch == 0 || seq_len == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                                 v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_dim<float>(head_dim, q, k, v, len, out, batch, seq_len, n_heads, n_kv,
                                strides, window, scale, softcap, st);
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
