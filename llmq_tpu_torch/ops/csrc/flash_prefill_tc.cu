// Flash prefill attention (K2), tensor-core route, for Hopper (sm_90a).
//
// Replaces: llmq_tpu/ops/pallas_attention.py, flash_prefill_attention_pallas
// (kernel body _flash_prefill_kernel). Plain version:
// llmq_tpu_torch/ops/attention.py, full_prefill_attention. This source
// serves bf16 q/k/v; f32 stays on the exact CUDA-core kernel in
// flash_prefill.cu (cuda_attention.prefill_route chooses by dtype).
//
// Contract (the same as flash_prefill.cu): causal self-attention over a
// right-padded bucket. q is [B, T, H, D], k and v are [B, T, n_kv, D],
// read through their batch, time and head strides (the head dimension
// contiguous; rows and bases 16-byte aligned, which the wrapper checks),
// so q/k/v may be views of one fused projection. Per-row ragged
// `lengths`, a sliding window (kpos > qpos - window), an optional tanh
// softcap and GQA (KV head h / (H / n_kv), no copy). Rows past a row's
// length are zeros.
//
// Bound on the H100: at the main path's bucket (qwen2.5-3b, T = 224,
// four ragged prompts) prefill attention does ~60 FLOP per byte of q, k,
// v and out, under the ~295 FLOP/byte ridge of the bf16 tensor cores: the
// bytes bound it. The design (attn_tc.cuh) keeps every byte on chip once
// it is read: grid (ceil(T/64), H, B), a 64-query tile held in shared
// memory while 64-key tiles stream through a two-stage cp.async ring,
// the products on the tensor cores (wgmma), the softmax in registers.
// The key loop runs only from the window's first key to the causal /
// length frontier, and a query tile past the row's length only writes
// zeros.

#include "attn_tc.cuh"

namespace {

using attn_tc::bf16;
using attn_tc::kBQ;

// K/V rows b, t, kv_head read through their strides.
template <int D>
struct StridedRows {
  static constexpr int BK = attn_tc::Tile<D>::BK;
  const bf16* k;  // row 0 of this (batch, kv head)
  const bf16* v;
  long long k_st, v_st, k_hi;

  __device__ void prime(long long) const {}
  __device__ int fetch(long long) const { return 0; }
  __device__ void publish(int, long long, int) const {}
  __device__ void issue(char* stage, int, long long k0) const {
    bf16* kd = reinterpret_cast<bf16*>(stage);
    bf16* vd = kd + BK * D;
#pragma unroll
    for (int it = 0; it < BK * (D / 8) / attn_tc::kThreads; ++it) {
      const int i = threadIdx.x + it * attn_tc::kThreads;
      const int r = i / (D / 8), c = i % (D / 8);
      const long long kp = k0 + r;
      const bool ok = kp < k_hi;
      const int at = attn_tc::swz<BK>(r, c * 8);
      attn_tc::cp_async16(kd + at, k + (ok ? kp * k_st + c * 8 : 0), ok);
      attn_tc::cp_async16(vd + at, v + (ok ? kp * v_st + c * 8 : 0), ok);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(attn_tc::kThreads) flash_prefill_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, int seq_len, int n_heads,
    int n_kv, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int window, float scale,
    float softcap) {
  extern __shared__ __align__(1024) char smem[];
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int length = min(lengths[b], seq_len);

  attn_tc::Frontier f;
  f.qbase = q0;
  f.n_q = max(0, min(kBQ, length - q0));
  f.window = window;
  f.k_lo = max(0LL, (long long)q0 - window + 1);
  f.k_hi = q0 + f.n_q;
  StridedRows<D> src{k + b * k_sb + kvh * k_sh, v + b * v_sb + kvh * v_sh, k_st, v_st,
                     f.k_hi};
  attn_tc::attend<D, false>(smem, q + b * q_sb + h * q_sh + q0 * q_st, q_st, f, scale,
                            softcap, src, out + b * o_sb + h * o_sh + q0 * o_st, o_st,
                            min(kBQ, seq_len - q0));
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* out, int batch, int seq_len, int n_heads, int n_kv,
                   const long long* s, int window, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = attn_tc::tile_bytes<D>(sizeof(bf16));
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((seq_len + kBQ - 1) / kBQ, n_heads, batch);
  flash_prefill_tc_kernel<D><<<grid, attn_tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lengths, static_cast<bf16*>(out), seq_len, n_heads, n_kv, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8], s[9], s[10], s[11], window, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). bf16 q, k, v and out.
// strides (elements): q (batch, time, head), k (...), v (...), out (...).
// softcap <= 0 means no softcap. The launch is asynchronous on `stream`.
int llmq_flash_prefill_tc(const void* q, const void* k, const void* v, const void* lengths,
                          void* out, int batch, int seq_len, int n_heads, int n_kv,
                          int head_dim, long long q_sb, long long q_st, long long q_sh,
                          long long k_sb, long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, long long o_sb, long long o_st,
                          long long o_sh, int window, float scale, float softcap,
                          void* stream) {
  if (batch == 0 || seq_len == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || window < 1) return (int)cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 64:
      err = launch<64>(q, k, v, len, out, batch, seq_len, n_heads, n_kv, s, window, scale,
                       softcap, st);
      break;
    case 128:
      err = launch<128>(q, k, v, len, out, batch, seq_len, n_heads, n_kv, s, window, scale,
                        softcap, st);
      break;
    case 256:
      err = launch<256>(q, k, v, len, out, batch, seq_len, n_heads, n_kv, s, window, scale,
                        softcap, st);
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
