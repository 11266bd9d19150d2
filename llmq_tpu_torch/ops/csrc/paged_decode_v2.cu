// Chunked paged decode attention (K5) and its fused-KV-write form (K4)
// for Hopper, sm_90a: one source, templated on FUSED_WRITE, as the TPU
// kernels are one Pallas body with a flag.
//
// Replaces: llmq_tpu/ops/pallas_attention.py,
//   K5: paged_decode_attention_pallas_v2 (FUSED_WRITE = false),
//   K4: paged_decode_attention_pallas_v3 (FUSED_WRITE = true),
// both with kernel body _paged_decode_kernel_v2. Plain versions:
// llmq_tpu_torch/ops/attention.py, paged_decode_attention (K5) and
// paged_decode_attention_fused_write (K4).
//
// Contract (K1's, exactly): one query row per sequence, q [S, H, D],
// against its pages of the layer-stacked pool [L, P, page, n_kv, D]
// through block_tables [S, pages_per_seq] and a layer index.
// context_lens [S] includes the new token; keys in
// [max(0, ctx - window), ctx) attend (the window clamp in 64-bit).
// Scores are scaled, take an optional tanh softcap and go through an
// online softmax in f32, with q, k and v upcast to f32 as the TPU kernel
// does. The pool is f32, bf16 or float8_e5m2 (an fp8 KV cache: each
// element widens exactly, to the query dtype's value and on to f32).
// GQA: the H / n_kv query heads of a KV head share it. A row with
// ctx == 0 writes exact zeros. The output has q's dtype.
//
// K4 additionally stores the step's new rows k_new / v_new [S, n_kv, D]
// (q's dtype, cast to the pool's with round to nearest even; an fp8 pool
// takes +-inf past its range, never a saturated +-57344) at position
// ctx - 1: page
// block_tables[s, (ctx-1) / page], slot (ctx-1) % page. The new row
// stands in for the pool's copy of that key in this step's attention.
// Rows with ctx == 0, or whose position lies past the page map, write
// nothing. Exactly one block writes a given (sequence, KV head) row, and
// no block reads that position from the pool, so the launch has no race.
// The pools then equal write_kv_pages + K1 bit for bit (page 0 aside,
// which the plain scatter dirties with inactive rows).
//
// Bound on the H100: the KV bytes read, as for K1 (~2 * group FLOPs per
// byte, far below the ~295 FLOP/byte ridge). The design:
//   * a chunk is pages_per_chunk pages (the wrapper sizes it to a shared
//     memory budget); a block walks its chunks in order and, while it
//     computes one, stages the next chunk's live rows into the other half
//     of a double buffer with cp.async (16-byte copies, nothing staged for
//     dead rows): the Hopper counterpart of the TPU kernel's manual DMA
//     double buffer. The block table needs no padding to a chunk multiple:
//     chunk bounds are clipped to the page map;
//   * split-KV over chunks, one block per (sequence, KV head, split), and
//     K1's combine kernel merging the splits' (acc, max, sum) partials;
//   * rows are staged in the pool's dtype with a pitch of D elements plus
//     16 bytes, and a score reads its key row as 16-byte vectors: the 8
//     lanes of each vector phase hit 8 distinct bank quads;
//   * one (head, key) score pair per thread; the softmax update a warp per
//     head; P.V with thread d owning output column d of every head.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // never -inf: keeps the softmax NaN-free
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
template <>
__device__ __forceinline__ __nv_fp8_e5m2 from_f32<__nv_fp8_e5m2>(float x) {
  // Round to nearest even, overflow to +-inf (__NV_NOSAT), as torch's and
  // JAX's casts do; the __nv_fp8_e5m2(float) constructor would saturate
  // to +-57344 instead, and the pools would differ from write_kv_pages.
  __nv_fp8_e5m2 r;
  r.__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E5M2);
  return r;
}

// 16 bytes of the pool's dtype as floats.
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const __nv_fp8_e5m2*) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = __half2float(__ushort_as_half((unsigned short)((unsigned)b[i] << 8)));
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: q [kMaxGroup][D] f32, scores [kMaxGroup][chunk_keys] f32,
// m / l / alpha [kMaxGroup], then 2 stages x (K, V) x chunk_keys rows of
// `pitch` bytes.
__host__ __device__ constexpr size_t row_pitch(int head_dim, int kv_bytes) {
  return (size_t)head_dim * kv_bytes + 16;
}
__host__ __device__ constexpr size_t float_region(int head_dim, int chunk_keys) {
  // Rounded up to 16 bytes so the staged rows start aligned.
  return ((sizeof(float) * ((size_t)kMaxGroup * head_dim + (size_t)kMaxGroup * chunk_keys +
                            3 * kMaxGroup)) + 15) / 16 * 16;
}
size_t smem_size(int head_dim, int kv_bytes, int chunk_keys) {
  return float_region(head_dim, chunk_keys) + 4 * (size_t)chunk_keys * row_pitch(head_dim, kv_bytes);
}

// Grid (S, n_kv, num_splits), block D threads. Split z walks a contiguous
// run of the chunks that overlap the row's live keys. With one split the
// block writes the output; with more it writes its unnormalised partial
// (acc, m, l) for the combine.
template <typename TQ, typename TKV, int D, bool FUSED_WRITE>
__global__ void __launch_bounds__(D) paged_decode_v2_kernel(
    const TQ* __restrict__ q, TKV* __restrict__ k_pool, TKV* __restrict__ v_pool,
    const TQ* __restrict__ k_new, const TQ* __restrict__ v_new,
    const int* __restrict__ block_tables, const int* __restrict__ context_lens,
    TQ* __restrict__ out, float* __restrict__ part, int n_heads, int n_kv, int num_pages,
    int page_size, int pages_per_seq, int pages_per_chunk, int layer, int window,
    float scale, float softcap) {
  constexpr int kWarps = D / 32;
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte copy
  constexpr int kPieces = D / kVec;       // 16-byte pieces per row
  const int chunk_keys = pages_per_chunk * page_size;
  const size_t pitch = row_pitch(D, sizeof(TKV));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [kMaxGroup][D]
  float* p_s = q_s + kMaxGroup * D;                  // [kMaxGroup][chunk_keys]
  float* m_s = p_s + kMaxGroup * chunk_keys;
  float* l_s = m_s + kMaxGroup;
  float* a_s = l_s + kMaxGroup;
  unsigned char* kv_s = smem_raw + float_region(D, chunk_keys);
  // Stage st, tensor kv (0 = K, 1 = V), chunk row r.
  auto srow = [&](int st, int kv, int r) -> unsigned char* {
    return kv_s + ((size_t)(st * 2 + kv) * chunk_keys + r) * pitch;
  };

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
  // This split's run of chunks, and the live keys [lo, hi) inside it.
  long long lo = 0, hi = 0;
  if (hi_row > lo_row) {
    const long long c_first = lo_row / chunk_keys, c_last = (hi_row - 1) / chunk_keys;
    const long long per = (c_last - c_first + num_splits) / num_splits;
    const long long c_begin = c_first + split * per;
    const long long c_end = c_begin + per < c_last + 1 ? c_begin + per : c_last + 1;
    if (c_begin < c_end) {
      lo = c_begin * chunk_keys > lo_row ? c_begin * chunk_keys : lo_row;
      hi = c_end * chunk_keys < hi_row ? c_end * chunk_keys : hi_row;
    }
  }

  const int* bt = block_tables + (long long)s * pages_per_seq;
  const long long layer_base = (long long)layer * num_pages;
  auto pool_row = [&](long long kpos) -> long long {  // element offset of (kpos, g)
    return (((layer_base + bt[kpos / page_size]) * page_size + kpos % page_size) * n_kv + g) * D;
  };

  // K4: the new row, at position ctx - 1, belongs to exactly one split.
  const long long p_new = ctx - 1;
  const bool new_here = FUSED_WRITE && ctx > 0 && p_new < max_ctx && p_new >= lo && p_new < hi;
  if (new_here) {  // persist it; no block of this launch reads it from the pool
    const long long row = pool_row(p_new);
    const long long src = ((long long)s * n_kv + g) * D + tid;
    k_pool[row + tid] = from_f32<TKV>(to_f32(k_new[src]));
    v_pool[row + tid] = from_f32<TKV>(to_f32(v_new[src]));
  }

  const long long q_row0 = (long long)s * n_heads + (long long)g * group;
  for (int h = 0; h < group; ++h) q_s[h * D + tid] = to_f32(q[(q_row0 + h) * D + tid]);
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) acc[h] = 0.f;

  // Stage the live rows of the chunk starting at key c0 into stage st.
  auto issue = [&](long long c0, int st) {
    const long long klo = c0 > lo ? c0 : lo;
    const long long khi = c0 + chunk_keys < hi ? c0 + chunk_keys : hi;
    const int n_rows = (int)(khi - klo);
    for (int idx = tid; idx < 2 * n_rows * kPieces; idx += D) {
      const int kv = idx / (n_rows * kPieces);
      const int rem = idx - kv * n_rows * kPieces;
      const int r = rem / kPieces, piece = rem % kPieces;
      const long long kpos = klo + r;
      if (FUSED_WRITE && kpos == p_new) continue;  // patched from k_new below
      const TKV* src = (kv ? v_pool : k_pool) + pool_row(kpos) + piece * kVec;
      cp_async16(srow(st, kv, (int)(kpos - c0)) + piece * 16, src);
    }
    cp_async_commit();
  };

  const long long c_lo = lo / chunk_keys * chunk_keys;  // first chunk's first key
  if (lo < hi) issue(c_lo, 0);
  int it = 0;
  for (long long c0 = c_lo; c0 < hi; c0 += chunk_keys, ++it) {
    const int st = it & 1;
    if (c0 + chunk_keys < hi) {
      issue(c0 + chunk_keys, st ^ 1);  // in flight while this chunk computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const long long klo = c0 > lo ? c0 : lo;
    const long long khi = c0 + chunk_keys < hi ? c0 + chunk_keys : hi;
    const int n = (int)(khi - klo);
    const int j0 = (int)(klo - c0);  // chunk row of the first live key
    if (FUSED_WRITE && new_here && p_new >= klo && p_new < khi) {
      const long long src = ((long long)s * n_kv + g) * D + tid;
      const int r = (int)(p_new - c0);
      reinterpret_cast<TKV*>(srow(st, 0, r))[tid] = from_f32<TKV>(to_f32(k_new[src]));
      reinterpret_cast<TKV*>(srow(st, 1, r))[tid] = from_f32<TKV>(to_f32(v_new[src]));
    }
    __syncthreads();  // the stage's rows (and the patched row) are visible

    // 1. Scores: one (head, key) pair per thread and pass.
    for (int pidx = tid; pidx < group * n; pidx += D) {
      const int h = pidx / n, j = pidx % n;
      const float* qr = q_s + h * D;
      const uint4* kr = reinterpret_cast<const uint4*>(srow(st, 0, j0 + j));
      float dot = 0.f;
#pragma unroll 4
      for (int pc = 0; pc < kPieces; ++pc) {
        float f[kVec];
        unpack16(kr[pc], f, static_cast<const TKV*>(nullptr));
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot += qr[pc * kVec + e] * f[e];
      }
      float sc = dot * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      p_s[h * chunk_keys + j] = sc;
    }
    __syncthreads();
    // 2. Online softmax update: a warp per query head, lanes over keys.
    for (int h = warp; h < group; h += kWarps) {
      float* ph = p_s + h * chunk_keys;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ph[j]);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float tot = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(ph[j] - m_new);
        ph[j] = p;
        tot += p;
      }
      tot = warp_sum(tot);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[h] = alpha;
        l_s[h] = alpha * l_s[h] + tot;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    // 3. P.V: thread d accumulates column d of every query head.
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h)
      if (h < group) acc[h] *= a_s[h];
    for (int j = 0; j < n; ++j) {
      const float vv = to_f32(reinterpret_cast<const TKV*>(srow(st, 1, j0 + j))[tid]);
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < group) acc[h] += p_s[h * chunk_keys + j] * vv;
    }
    __syncthreads();  // this stage is read out before it is staged again
  }

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

struct Args {
  const void* q;
  void* k_pool;
  void* v_pool;
  const void* k_new;
  const void* v_new;
  const int* bt;
  const int* ctx;
  void* out;
  float* part;
  int num_seqs, n_heads, n_kv, num_pages, page_size, pages_per_seq, pages_per_chunk, layer,
      window, num_splits;
  float scale, softcap;
};

template <typename TQ, typename TKV, int D, bool FUSED_WRITE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = paged_decode_v2_kernel<TQ, TKV, D, FUSED_WRITE>;
  const size_t smem = smem_size(D, sizeof(TKV), a.pages_per_chunk * a.page_size);
  static int configured = 0;  // largest dynamic shared memory allowed so far
  if ((int)smem > configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = (int)smem;
  }
  dim3 grid(a.num_seqs, a.n_kv, a.num_splits);
  kernel<<<grid, D, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<TKV*>(a.k_pool), static_cast<TKV*>(a.v_pool),
      static_cast<const TQ*>(a.k_new), static_cast<const TQ*>(a.v_new), a.bt, a.ctx,
      static_cast<TQ*>(a.out), a.part, a.n_heads, a.n_kv, a.num_pages, a.page_size,
      a.pages_per_seq, a.pages_per_chunk, a.layer, a.window, a.scale, a.softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.num_splits == 1) return err;
  combine_kernel<TQ, D><<<a.num_seqs * a.n_heads, D, 0, stream>>>(
      a.part, static_cast<TQ*>(a.out), a.num_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool FUSED_WRITE>
cudaError_t launch_dim(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<TQ, TKV, 64, FUSED_WRITE>(a, stream);
    case 128:
      return launch<TQ, TKV, 128, FUSED_WRITE>(a, stream);
    case 256:
      return launch<TQ, TKV, 256, FUSED_WRITE>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, bool FUSED_WRITE>
cudaError_t launch_kv(int kv_dtype, int head_dim, const Args& a, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_dim<TQ, float, FUSED_WRITE>(head_dim, a, stream);
    case 1:
      return launch_dim<TQ, __nv_bfloat16, FUSED_WRITE>(head_dim, a, stream);
    case 2:
      return launch_dim<TQ, __nv_fp8_e5m2, FUSED_WRITE>(head_dim, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool FUSED_WRITE>
cudaError_t launch_types(int q_bf16, int kv_dtype, int head_dim, const Args& a,
                         cudaStream_t stream) {
  return q_bf16 ? launch_kv<__nv_bfloat16, FUSED_WRITE>(kv_dtype, head_dim, a, stream)
                : launch_kv<float, FUSED_WRITE>(kv_dtype, head_dim, a, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). q_bf16: 1 = bf16, 0 = f32;
// kv_dtype: 0 = f32, 1 = bf16, 2 = float8_e5m2. fused_write = 1 launches
// K4 (k_new / v_new in q's dtype, [S, n_kv, D]), 0 launches K5 (k_new /
// v_new unused). softcap <= 0 means no softcap.
// num_splits > 1 needs `partials`, f32 scratch of
// num_seqs * n_heads * num_splits * (head_dim + 2) values. The pools must
// be 16-byte aligned. The launches are asynchronous on `stream`.
int llmq_paged_decode_v2(const void* q, void* k_pool, void* v_pool, const void* k_new,
                         const void* v_new, const void* block_tables,
                         const void* context_lens, void* out, void* partials, int q_bf16,
                         int kv_dtype, int fused_write, int num_seqs, int n_heads, int n_kv,
                         int head_dim, int num_pages, int page_size, int pages_per_seq,
                         int pages_per_chunk, int layer, int window, float scale,
                         float softcap, int num_splits, void* stream) {
  if (num_seqs == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxGroup || num_splits < 1 ||
      pages_per_chunk < 1 || window < 1 || (num_splits > 1 && partials == nullptr) ||
      (fused_write && (k_new == nullptr || v_new == nullptr)) ||
      (reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, k_new, v_new, static_cast<const int*>(block_tables),
         static_cast<const int*>(context_lens), out, static_cast<float*>(partials),
         num_seqs, n_heads, n_kv, num_pages, page_size, pages_per_seq, pages_per_chunk,
         layer, window, num_splits, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fused_write ? launch_types<true>(q_bf16, kv_dtype, head_dim, a, st)
                                : launch_types<false>(q_bf16, kv_dtype, head_dim, a, st);
  return (int)err;
}

const char* llmq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
