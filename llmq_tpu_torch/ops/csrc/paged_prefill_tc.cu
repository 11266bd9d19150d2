// Paged chunked-prefill attention (K3), tensor-core route, for Hopper
// (sm_90a).
//
// Replaces: llmq_tpu/ops/pallas_attention.py, paged_prefill_attention_pallas
// (kernel body _paged_prefill_kernel, dead-page clamp _kv_index). Plain
// version: llmq_tpu_torch/ops/attention.py, paged_prefill_attention. This
// source serves bf16 q over a bf16 or float8_e5m2 pool; f32 q, or an f32
// pool (which promotes the math to f32), stays on the exact CUDA-core
// kernel in paged_prefill.cu (cuda_attention.prefill_route chooses by
// dtype).
//
// Contract (the same as paged_prefill.cu): C chunk queries per row,
// q [B, C, H, D] (read through its batch, time and head strides; the head
// dimension contiguous, rows 16-byte aligned), against the row's pages of
// the layer-stacked pool [L, P, page, n_kv, D], which already hold the
// chunk's own K/V. A row's valid queries are a leading run given as
// (chunk_start[b], num_valid[b]): query t < num_valid sits at absolute
// position chunk_start + t and attends cached keys in (pos - window, pos],
// read through block_tables [B, pages_per_seq] at layer `layer`. An e5m2
// pool widens exactly to bf16; probabilities are rounded to bf16 before
// P.V. GQA: head h reads KV head h / (H / n_kv). Query rows past
// num_valid are zeros. The output [B, C, H, D] is contiguous bf16.
//
// Bound on the H100: at the prefix-cache serve's shapes (qwen2.5-3b, 16
// query heads over 2 KV heads, chunks of ~100-256 queries at contexts
// ~1,100) a chunk does 400-700 FLOP per byte it must move, above the ~295
// FLOP/byte ridge of the bf16 tensor cores: the operations bound it. The
// design (attn_tc.cuh) puts both products on the tensor cores (wgmma)
// and keeps the next key tile's copies in flight while one is multiplied:
//   * grid (ceil(C/64), H, B); the key loop covers only
//     [first query pos - window + 1, last valid query pos], the
//     counterpart of _kv_index's clamp, so dead pages cost no load;
//   * a key tile's 64 pool rows resolve through the block table (a chunk
//     may start mid-page after a prefix hit; page_size is free), one row
//     per thread; the page numbers of the tile two ahead are loaded before
//     the products and their row offsets stored after them, so the
//     block-table reads never stall an issue;
//   * an e5m2 pool is copied raw by cp.async and widened to bf16 in shared
//     memory, a step per tile, before the products.

#include "attn_tc.cuh"

namespace {

using attn_tc::bf16;
using attn_tc::kBQ;

// K/V rows of one (row, KV head) through the block table. TKV is bf16 or
// uint8_t (the raw bytes of an e5m2 pool).
template <int D, typename TKV>
struct PagedRows {
  static constexpr int BK = attn_tc::Tile<D>::BK;
  static constexpr int S = attn_tc::Tile<D>::kStages;
  static constexpr bool kRaw = sizeof(TKV) == 1;
  const TKV* k_pool;
  const TKV* v_pool;
  const int* bt;  // this row's block table
  long long layer_base;  // layer * num_pages
  int page_size, n_kv, kvh;
  long long k_hi;
  int* rows;  // [S][BK] pool rows (of D elements) of a tile's keys; -1: none

  __device__ int row(long long kp, int page) const {
    return (int)(((layer_base + page) * page_size + kp % page_size) * n_kv + kvh);
  }
  __device__ void prime(long long k0) const {
    for (int t = threadIdx.x; t < S * BK; t += attn_tc::kThreads) {
      const long long kp = k0 + t;  // slot t / BK, row t % BK
      rows[t] = kp < k_hi ? row(kp, bt[kp / page_size]) : -1;
    }
  }
  __device__ int fetch(long long k0) const {
    const long long kp = k0 + threadIdx.x;
    return threadIdx.x < BK && kp < k_hi ? bt[kp / page_size] : -1;
  }
  __device__ void publish(int slot, long long k0, int page) const {
    if (threadIdx.x < BK)
      rows[slot * BK + threadIdx.x] = page >= 0 ? row(k0 + threadIdx.x, page) : -1;
  }
  __device__ void issue(char* stage, int slot, long long) const {
    constexpr int kPer = 16 / sizeof(TKV);  // elements per 16-byte copy
    const int* slot_rows = rows + slot * BK;
#pragma unroll
    for (int it = 0; it < BK * (D / kPer) / attn_tc::kThreads; ++it) {
      const int i = threadIdx.x + it * attn_tc::kThreads;
      const int r = i / (D / kPer), c = i % (D / kPer);
      const long long at_row = (long long)slot_rows[r] * D;
      const bool ok = at_row >= 0;
      // raw e5m2: plain [BK][D] bytes, widened later; bf16: the swizzled tile
      const int at = kRaw ? r * D + c * kPer : attn_tc::swz<BK>(r, c * kPer);
      TKV* kd = reinterpret_cast<TKV*>(stage);
      attn_tc::cp_async16(kd + at, k_pool + (ok ? at_row + c * kPer : 0), ok);
      attn_tc::cp_async16(kd + BK * D + at, v_pool + (ok ? at_row + c * kPer : 0), ok);
    }
  }
};

template <int D, typename TKV>
constexpr size_t smem_bytes() {
  return attn_tc::tile_bytes<D>(sizeof(TKV)) +
         attn_tc::Tile<D>::kStages * attn_tc::Tile<D>::BK * sizeof(int);
}

template <int D, typename TKV>
__global__ void __launch_bounds__(attn_tc::kThreads) paged_prefill_tc_kernel(
    const bf16* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ block_tables,
    const int* __restrict__ chunk_start, const int* __restrict__ num_valid,
    bf16* __restrict__ out, int chunk, int n_heads, int n_kv, int num_pages, int page_size,
    int pages_per_seq, int layer, long long q_sb, long long q_st, long long q_sh,
    int window, float scale, float softcap) {
  extern __shared__ __align__(1024) char smem[];
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int nv = min(num_valid[b], chunk);

  attn_tc::Frontier f;
  f.n_q = max(0, min(kBQ, nv - q0));
  f.qbase = (long long)chunk_start[b] + q0;
  f.window = window;
  f.k_lo = max(0LL, f.qbase - window + 1);
  f.k_hi = min(f.qbase + f.n_q, (long long)pages_per_seq * page_size);
  PagedRows<D, TKV> src{k_pool, v_pool, block_tables + (long long)b * pages_per_seq,
                        (long long)layer * num_pages, page_size, n_kv, kvh, f.k_hi,
                        reinterpret_cast<int*>(smem + attn_tc::tile_bytes<D>(sizeof(TKV)))};
  const long long o_st = (long long)n_heads * D;
  attn_tc::attend<D, PagedRows<D, TKV>::kRaw>(
      smem, q + b * q_sb + h * q_sh + q0 * q_st, q_st, f, scale, softcap, src,
      out + (long long)b * chunk * o_st + (long long)h * D + q0 * o_st, o_st,
      min(kBQ, chunk - q0));
}

template <int D, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                   const int* start, const int* nvalid, void* out, int batch, int chunk,
                   int n_heads, int n_kv, int num_pages, int page_size, int pages_per_seq,
                   int layer, const long long* q_strides, int window, float scale,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, TKV>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(paged_prefill_tc_kernel<D, TKV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((chunk + kBQ - 1) / kBQ, n_heads, batch);
  paged_prefill_tc_kernel<D, TKV><<<grid, attn_tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), bt, start, nvalid, static_cast<bf16*>(out), chunk,
      n_heads, n_kv, num_pages, page_size, pages_per_seq, layer, q_strides[0], q_strides[1],
      q_strides[2], window, scale, softcap);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t launch_dim(int head_dim, const void* q, const void* k_pool, const void* v_pool,
                       const int* bt, const int* start, const int* nvalid, void* out,
                       int batch, int chunk, int n_heads, int n_kv, int num_pages,
                       int page_size, int pages_per_seq, int layer,
                       const long long* q_strides, int window, float scale, float softcap,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<64, TKV>(q, k_pool, v_pool, bt, start, nvalid, out, batch, chunk,
                             n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                             q_strides, window, scale, softcap, stream);
    case 128:
      return launch<128, TKV>(q, k_pool, v_pool, bt, start, nvalid, out, batch, chunk,
                              n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                              q_strides, window, scale, softcap, stream);
    case 256:
      return launch<256, TKV>(q, k_pool, v_pool, bt, start, nvalid, out, batch, chunk,
                              n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                              q_strides, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). bf16 q and out; kv_dtype:
// 1 = bf16, 2 = float8_e5m2 pools. q strides in elements (batch, time,
// head). softcap <= 0 means no softcap. The launch is asynchronous on
// `stream`.
int llmq_paged_prefill_tc(const void* q, const void* k_pool, const void* v_pool,
                          const void* block_tables, const void* chunk_start,
                          const void* num_valid, void* out, int kv_dtype, int batch,
                          int chunk, int n_heads, int n_kv, int head_dim, int num_pages,
                          int page_size, int pages_per_seq, int layer, long long q_sb,
                          long long q_st, long long q_sh, int window, float scale,
                          float softcap, void* stream) {
  if (batch == 0 || chunk == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || window < 1 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  const long long q_strides[3] = {q_sb, q_st, q_sh};
  const int* bt = static_cast<const int*>(block_tables);
  const int* st = static_cast<const int*>(chunk_start);
  const int* nv = static_cast<const int*>(num_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kv_dtype) {
    case 1:
      err = launch_dim<bf16>(head_dim, q, k_pool, v_pool, bt, st, nv, out, batch, chunk,
                             n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                             q_strides, window, scale, softcap, s);
      break;
    case 2:
      err = launch_dim<uint8_t>(head_dim, q, k_pool, v_pool, bt, st, nv, out, batch, chunk,
                                n_heads, n_kv, num_pages, page_size, pages_per_seq, layer,
                                q_strides, window, scale, softcap, s);
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
