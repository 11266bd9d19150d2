// Paged decode attention (K1), its fused-KV-write form (K4) and its
// chunked form (K5), tensor-core route, for Hopper (sm_90a): one kernel,
// templated on FUSED_WRITE and on the tiles a ring stage holds (TPS).
//
// Replaces: llmq_tpu/ops/pallas_attention.py,
//   K1: paged_decode_attention_pallas (kernel body _paged_decode_kernel),
//   K4: paged_decode_attention_pallas_v3 (_paged_decode_kernel_v2 with
//       fused_write=True),
//   K5: paged_decode_attention_pallas_v2 (_paged_decode_kernel_v2).
// Plain versions: llmq_tpu_torch/ops/attention.py, paged_decode_attention
// (K1, K5) and paged_decode_attention_fused_write (K4). This source serves
// bf16 q over a bf16 or float8_e5m2 pool; f32 q, or an f32 pool (which
// promotes the math to f32), stays on the exact CUDA-core kernels in
// paged_decode.cu (K1) and paged_decode_v2.cu (K4, K5)
// (cuda_attention.attention_route chooses by dtype).
//
// Contract (the same as paged_decode.cu): one query row per sequence,
// q [S, H, D], against that sequence's pages of the layer-stacked pool
// [L, P, page, n_kv, D], read in place through block_tables
// [S, pages_per_seq] and a layer index. context_lens [S] includes the new
// token; keys in [max(0, ctx - window), ctx) attend. Scores are scaled,
// take an optional tanh softcap (applied before the mask), and go through
// an online softmax in f32 with the running max seeded at -1e30. GQA: the
// group = H / n_kv <= 16 query heads of one KV head share its rows. An
// e5m2 pool widens exactly to bf16. A row with ctx == 0 writes exact
// zeros. D is 64, 128 or 256. The output is bf16.
//
// K4 (FUSED_WRITE) also stores the step's new rows k_new / v_new
// [S, n_kv, D] (bf16) at position ctx - 1: page
// block_tables[s, (ctx - 1) / page], slot (ctx - 1) % page, cast to the
// pool's dtype with round to nearest even (an e5m2 pool takes +-inf past
// its range, as the plain cast does, where the hardware conversion would
// saturate). The new row stands in for the pool's
// copy of that key in this step's attention. Rows with ctx == 0, or whose
// position lies past the page map, write nothing. The one warp whose tile
// holds ctx - 1 (one block of the launch, one per sequence and KV head)
// issues no copy for that row: after its ring wait it writes the converted
// row into its ring slot and into both pools. No block reads that position
// from the pool, so the launch has no race, and the pools equal
// write_kv_pages + K1 bit for bit (page 0 aside, which the plain scatter
// dirties with inactive rows). The store costs one row a (sequence, KV
// head); the bound and the design below are K1's.
//
// K5 (TPS = 2) keeps what defines its TPU kernel, a chunk of whole pages
// staged a step: a warp's ring stage holds TPS of its tiles, so the four
// warps' stage j together hold the span's keys [128 j, 128 j + 128), four
// pages of 32. ops/cuda_attention.decode_tc_tiles_per_stage sizes it from
// pages_per_chunk and takes it only where a double buffer of such stages
// fits beside the SM's other blocks; elsewhere (bf16 rows at the main
// path's grid) K5 launches with TPS = 1, K1's plan, which the H100 ran
// faster than a single-buffered chunk (PERF.md §6). Each warp still
// takes the same tiles in the same order and the merge is the same, so at
// the same split plan K5's output equals K1's bit for bit; only the grain
// of the copies and waits differs.
//
// Bound on the H100: the KV bytes, read once per (sequence, KV head) for
// the whole group. The CUDA-core kernel kept one load in flight per thread
// (about 0.5 KB per SM against the ~20 KB that Little's law asks of
// 3.35 TB/s); this one is built to keep the copies in flight:
//   * grid (sequence, KV head, split), as paged_decode.cu: split-KV cuts
//     a row's live keys into spans so a batch of 16 fills the SMs; each
//     span writes its (acc, max, sum) partials, and the last span of a
//     (sequence, KV head) to finish (an atomic counter, reset by that
//     block for the next launch) merges them, so there is no second
//     launch. (A thread-block cluster of the spans merging through
//     distributed shared memory was slower on the H100: PERF.md §6);
//   * a block of 4 warps; each warp owns every fourth 16-key tile of the
//     block's span, with its own running (m, l, acc) and its own ring of
//     1-3 stages (ops/cuda_attention.decode_tc_plan) of raw K and V rows,
//     filled by 16-byte cp.async copies of the pool's own bytes, so warps
//     never wait on each other inside the loop; they merge once, through
//     shared memory, at the end;
//   * the page numbers of the tile after the next are read from the block
//     table before a tile's products and turned into row offsets when it
//     is issued, so a block-table read never stalls a copy (the first
//     tiles' reads are issued together); only live keys are fetched; rows
//     past the span are zero-filled by the copy itself;
//   * S = Q.K^T on mma.sync m16n8k16: the group's query heads are the 16
//     rows (padded with zeros), bf16 x bf16 products are exact in f32, so
//     the scores are the TPU kernel's f32 scores. The contraction over d
//     is permuted (a thread takes d 32p + 8t .. + 7 of its key and query
//     rows for k-steps 2p and 2p + 1), so each K fragment is one 16-byte
//     (bf16) or 8-byte (e5m2) shared load;
//   * masks only on the span's last tile; the online softmax stays in
//     registers;
//   * O += P.V on the tensor cores with P split into a bf16 hi + lo pair
//     (two products; P good to ~2^-17), so the output keeps the f32
//     math's accuracy; V fragments come from ldmatrix.trans, over bf16
//     rows or over the e5m2 bytes taken in pairs (each 32-bit register
//     then holds two keys at two neighbouring d, which a byte permute
//     splits into the B registers of both);
//   * e5m2 bytes are widened to bf16 when the fragments are formed
//     (exact: each byte is the top byte of an fp16).
// Shared tiles swizzle their 16-byte chunks per row so the fragment loads
// and ldmatrix's eight row addresses fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // running-max seed, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTK = 16;  // keys per warp tile
constexpr int kMaxGroup = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The bf16 pair (hi) nearest to (lo, hi) and the bf16 pair of what is left.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}
// Two e5m2 bytes of `w` (selector SEL puts them in the high bytes of two
// fp16 halves) -> bf16x2; every e5m2 value is an fp16 and a bf16 value.
template <uint32_t SEL>
__device__ __forceinline__ uint32_t widen2(uint32_t w) {
  const uint32_t h2 = __byte_perm(w, 0u, SEL);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return pack_bf16(f.x, f.y);
}
constexpr uint32_t kBytes01 = 0x1404u, kBytes23 = 0x3424u;  // [0, b0, 0, b1], [0, b2, 0, b3]
constexpr uint32_t kBytes02 = 0x2404u, kBytes13 = 0x3414u;  // [0, b0, 0, b2], [0, b1, 0, b3]

// Two floats -> two e5m2 bytes (lo in the low byte), rounded to nearest
// even as the plain cast rounds: the hardware conversion saturates
// (cvt.rn.satfinite), so a value that rounds past the range (|v| >=
// 61,440, where the tie goes to the even infinity) is set to +-inf.
__device__ __forceinline__ uint32_t e5m2x2(float lo, float hi) {
  uint32_t r = __nv_cvt_float2_to_fp8x2(make_float2(lo, hi), __NV_SATFINITE, __NV_E5M2);
  if (fabsf(lo) >= 61440.f) r = (r & 0xFF00u) | (lo < 0.f ? 0xFCu : 0x7Cu);
  if (fabsf(hi) >= 61440.f) r = (r & 0x00FFu) | ((hi < 0.f ? 0xFCu : 0x7Cu) << 8);
  return r;
}

// 16 bytes of a row in the pool's dtype from the bf16 row `src` (chunk
// `chunk` of the pool row): bf16 as it is; e5m2 rounded as e5m2x2 rounds.
__device__ __forceinline__ uint4 pool_chunk(const bf16* src, int chunk, const bf16*) {
  return reinterpret_cast<const uint4*>(src)[chunk];
}
__device__ __forceinline__ uint4 pool_chunk(const bf16* src, int chunk, const uint8_t*) {
  const uint4 h[2] = {reinterpret_cast<const uint4*>(src)[2 * chunk],
                      reinterpret_cast<const uint4*>(src)[2 * chunk + 1]};
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(h);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(v[2 * i]), b = __bfloat1622float2(v[2 * i + 1]);
    w[i] = e5m2x2(a.x, a.y) | (e5m2x2(b.x, b.y) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Chunk position of 16-byte chunk c in row r of a tile with CPR chunks a
// row. CPR >= 8: eight consecutive rows get eight distinct banks groups
// (ldmatrix), and rows 2i, 2i + 1 put chunks 4p .. 4p + 3 in opposite
// halves of the 128-byte bank line (the 16-byte fragment loads); CPR == 4
// (64-byte rows, two a bank line): the same two properties.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CPR >= 8) {
    return c ^ ((r & 7) ^ ((r & 1) << 2));
  } else {
    return c ^ ((((r >> 1) & 1) << 1) | ((r >> 2) & 1));
  }
}

template <typename TKV, int D, int STAGES, int TPS>
struct Layout {
  static constexpr int kRB = D * (int)sizeof(TKV);  // bytes of a K or V row
  static constexpr int kCPR = kRB / 16;
  static constexpr int kTile = kTK * kRB;
  static constexpr int kStage = TPS * 2 * kTile;  // per tile: K then V
  static constexpr int kQ = kMaxGroup * D * 2;
  static constexpr int kRing = kWarps * STAGES * kStage;
  // The end-of-loop merge reuses the ring: per warp its [16][D] f32 acc
  // and (m, l) per row; then per row the warps' weights and the sum.
  static constexpr int kMerge = (kWarps * kMaxGroup * (D + 2) + kMaxGroup * (kWarps + 1)) * 4;
  static constexpr int kBytes = kQ + (kRing > kMerge ? kRing : kMerge) + 16;  // + the flag
};

constexpr int kMaxSplits = 32;

// Grid (S, n_kv, num_splits), 128 threads; 3 blocks an SM at D <= 128.
// With one split the block writes the output; with more, its
// unnormalised (acc, m, l) partials, and the last of them the output.
template <typename TKV, int D, int STAGES, bool FUSED_WRITE, int TPS>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 3 : 2) paged_decode_tc_kernel(
    const bf16* __restrict__ q, TKV* __restrict__ k_pool, TKV* __restrict__ v_pool,
    const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
    const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, bf16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counters, int n_heads, int n_kv, int num_pages, int page_size,
    int pages_per_seq, int layer, int window, float scale, float softcap) {
  using Lay = Layout<TKV, D, STAGES, TPS>;
  constexpr int kKeys = TPS * kTK;  // keys of a warp's ring stage
  static_assert(kKeys <= 32, "a stage's page lookups take one lane a key");
  constexpr bool kFp8 = sizeof(TKV) == 1;
  constexpr int kRB = Lay::kRB, kCPR = Lay::kCPR;
  constexpr int kQC = D * 2 / 16;  // chunks of a bf16 q row
  constexpr bool kQRegs = D <= 128;  // Q fragments held in registers
  extern __shared__ __align__(128) char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  char* ring = smem + Lay::kQ;

  const int s = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int num_splits = gridDim.z;
  const int group = n_heads / n_kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  const long long ctx = context_lens[s];
  const long long max_ctx = (long long)pages_per_seq * page_size;
  const long long hi_row = ctx < max_ctx ? ctx : max_ctx;
  long long lo_row = ctx - (long long)window;
  if (lo_row < 0) lo_row = 0;
  long long span = hi_row > lo_row ? (hi_row - lo_row + num_splits - 1) / num_splits : 0;
  span = (span + kTK - 1) / kTK * kTK;
  const long long lo = lo_row + split * span;
  const long long hi = lo + span < hi_row ? lo + span : hi_row;
  const int n_t = hi > lo ? (int)((hi - lo + kTK - 1) / kTK) : 0;
  const int my_n = n_t > warp ? (n_t - warp + kWarps - 1) / kWarps : 0;
  const int my_st = (my_n + TPS - 1) / TPS;  // this warp's ring stages
  // K4: the new key, stored from k_new / v_new and never copied from the pool.
  const long long p_new = FUSED_WRITE && ctx > 0 && ctx <= max_ctx ? ctx - 1 : -1;

  const long long q_row0 = (long long)s * n_heads + (long long)kvh * group;
  for (int i = tid; i < kMaxGroup * kQC; i += kThreads) {
    const int r = i / kQC, c = i % kQC;
    const bool ok = r < group;
    cp_async16(q_s + r * D + swz<kQC>(r, c) * 8, q + (ok ? (q_row0 + r) * D + c * 8 : 0), ok);
  }
  cp_async_commit();  // group 0: Q

  const int* bt = block_tables + (long long)s * pages_per_seq;
  const long long layer_base = (long long)layer * num_pages;
  auto tile_base = [&](int j) { return lo + (long long)(warp + j * kWarps) * kTK; };
  // Key of lane l < kKeys in this warp's ring stage js: key l % 16 of the
  // warp's tile TPS js + l / 16.
  auto stage_key = [&](int js, int l) { return tile_base(js * TPS + l / kTK) + l % kTK; };
  // Page of this lane's key of stage js (lanes 0 .. kKeys - 1), -1 for none.
  auto lookup = [&](int js) -> int {
    if (lane >= kKeys || js * TPS + lane / kTK >= my_n) return -1;
    const long long key = stage_key(js, lane);
    return key < hi ? bt[key / page_size] : -1;
  };
  auto stage = [&](int js) { return ring + (warp * STAGES + js % STAGES) * Lay::kStage; };
  auto issue = [&](int js, int page) {
    char* st = stage(js);
    const long long key = stage_key(js, lane & (kKeys - 1));
    const long long row =
        page >= 0 && key != p_new
            ? (((layer_base + page) * page_size + key % page_size) * n_kv + kvh) * kRB
            : -1;
#pragma unroll
    for (int i = lane; i < kKeys * kCPR; i += 32) {
      const int r = i / kCPR, c = i % kCPR;
      const long long at_row = __shfl_sync(kFull, row, r);
      const bool ok = at_row >= 0;
      const long long src = ok ? at_row + 16 * c : 0;
      const int tr = r % kTK;  // row r of the stage: row tr of its tile r / 16
      const int at = (r / kTK) * 2 * Lay::kTile + tr * kRB + 16 * swz<kCPR>(tr, c);
      cp_async16(st + at, reinterpret_cast<const char*>(k_pool) + src, ok);
      cp_async16(st + Lay::kTile + at, reinterpret_cast<const char*>(v_pool) + src, ok);
    }
  };

  int pgs[STAGES];  // the first tiles' block-table reads, all in flight at once
#pragma unroll
  for (int j = 0; j < STAGES; ++j) pgs[j] = lookup(j);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < my_st) issue(j, pgs[j]);
    cp_async_commit();
  }
  int pg = pgs[STAGES - 1];
  cp_async_wait<STAGES - 1>();  // Q
  __syncthreads();

  // Q fragments: k-steps 2p, 2p + 1 take d 32p + 8t4 .. + 7 (chunk 4p + t4).
  auto load_q = [&](int p, uint32_t (&a0)[4], uint32_t (&a1)[4]) {
    const uint4 lo4 = *reinterpret_cast<const uint4*>(q_s + g * D + swz<kQC>(g, 4 * p + t4) * 8);
    const uint4 hi4 =
        *reinterpret_cast<const uint4*>(q_s + (g + 8) * D + swz<kQC>(g + 8, 4 * p + t4) * 8);
    a0[0] = lo4.x; a0[1] = hi4.x; a0[2] = lo4.y; a0[3] = hi4.y;
    a1[0] = lo4.z; a1[1] = hi4.z; a1[2] = lo4.w; a1[3] = hi4.w;
  };
  uint32_t qa[kQRegs ? D / 32 : 1][2][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int p = 0; p < D / 32; ++p) load_q(p, qa[p][0], qa[p][1]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;           // this thread's share of their sums

  for (int js = 0; js < my_st; ++js) {
    if (js + STAGES - 1 < my_st) issue(js + STAGES - 1, pg);
    cp_async_commit();
    pg = lookup(js + STAGES);
    cp_async_wait<STAGES - 1>();  // stage js
    __syncwarp();
#pragma unroll
    for (int t = 0; t < TPS; ++t) {
      const int j = js * TPS + t;
      if (j >= my_n) break;
      char* kt = stage(js) + t * 2 * Lay::kTile;
      const char* vt = kt + Lay::kTile;
      const long long base = tile_base(j);
      if (FUSED_WRITE && p_new >= base && p_new < base + kTK) {
        // K4: the new row into its ring slot (zero-filled by the copy) and
        // into both pools, one 16-byte chunk a lane.
        const int r = (int)(p_new - base);
        if (lane < kCPR) {
          const long long src = ((long long)s * n_kv + kvh) * D;
          const uint4 kc = pool_chunk(k_new + src, lane, k_pool);
          const uint4 vc = pool_chunk(v_new + src, lane, v_pool);
          const int at = r * kRB + 16 * swz<kCPR>(r, lane);
          *reinterpret_cast<uint4*>(kt + at) = kc;
          *reinterpret_cast<uint4*>(kt + Lay::kTile + at) = vc;
          const long long page = layer_base + bt[p_new / page_size];
          const long long row =
              ((page * page_size + p_new % page_size) * n_kv + kvh) * kRB + 16 * lane;
          *reinterpret_cast<uint4*>(reinterpret_cast<char*>(k_pool) + row) = kc;
          *reinterpret_cast<uint4*>(reinterpret_cast<char*>(v_pool) + row) = vc;
        }
        __syncwarp();
      }

      // S = Q K^T: 16 heads x 16 keys (n-block nb: keys 8 nb .. 8 nb + 7).
      float sc[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
      for (int p = 0; p < D / 32; ++p) {
        uint32_t a0[4], a1[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a0[e] = qa[p][0][e];
            a1[e] = qa[p][1][e];
          }
        } else {
          load_q(p, a0, a1);
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int r = nb * 8 + g;
          uint32_t b[4];
          if constexpr (kFp8) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                kt + r * kRB + 16 * swz<kCPR>(r, 2 * p + (t4 >> 1)) + 8 * (t4 & 1));
            b[0] = widen2<kBytes01>(u.x);
            b[1] = widen2<kBytes23>(u.x);
            b[2] = widen2<kBytes01>(u.y);
            b[3] = widen2<kBytes23>(u.y);
          } else {
            const uint4 u =
                *reinterpret_cast<const uint4*>(kt + r * kRB + 16 * swz<kCPR>(r, 4 * p + t4));
            b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
          }
          mma16816(sc[nb], a0, b[0], b[1]);
          mma16816(sc[nb], a1, b[2], b[3]);
        }
      }

      // Scale, softcap, mask (the span's last tile only), online softmax.
      const bool edge = base + kTK > hi;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[nb][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);  // before the mask
          if (edge && base + nb * 8 + 2 * t4 + (e & 1) >= hi) x = -INFINITY;
          sc[nb][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[nb][0], sc[nb][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nb][2], sc[nb][3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {  // the quad shares a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, w));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f((m0 - n0) * kLog2e), alpha1 = exp2f((m1 - n1) * kLog2e);
      m0 = n0;
      m1 = n1;
      const float b0 = n0 * kLog2e, b1 = n1 * kLog2e;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        sc[nb][0] = exp2f(fmaf(sc[nb][0], kLog2e, -b0));
        sc[nb][1] = exp2f(fmaf(sc[nb][1], kLog2e, -b0));
        sc[nb][2] = exp2f(fmaf(sc[nb][2], kLog2e, -b1));
        sc[nb][3] = exp2f(fmaf(sc[nb][3], kLog2e, -b1));
        ls0 += sc[nb][0] + sc[nb][1];
        ls1 += sc[nb][2] + sc[nb][3];
      }
      l0 = l0 * alpha0 + ls0;
      l1 = l1 * alpha1 + ls1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] *= alpha0;
        o[i][1] *= alpha0;
        o[i][2] *= alpha1;
        o[i][3] *= alpha1;
      }

      // O += P V with P = hi + lo (bf16 each). The S accumulators of
      // n-blocks 0 and 1 are the A fragment of the tile's one key step.
      uint32_t ph[4], pl[4];
      split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
      split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
      split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
      split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
      const int vr = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row: key
#pragma unroll
      for (int cc = 0; cc < kCPR / 2; ++cc) {
        const int c = 2 * cc + (lane >> 4);
        uint32_t v[4];
        ldmatrix_x4_trans(v, vt + vr * kRB + 16 * swz<kCPR>(vr, c));
        if constexpr (kFp8) {
          // v[0] / v[1]: keys 0-7 / 8-15 at chunk 2cc, v[2] / v[3] at 2cc + 1;
          // each holds d = 16c + 2g (bytes 0, 2) and 16c + 2g + 1 (1, 3).
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t e0 = widen2<kBytes02>(v[2 * h]), e1 = widen2<kBytes02>(v[2 * h + 1]);
            const uint32_t d0 = widen2<kBytes13>(v[2 * h]), d1 = widen2<kBytes13>(v[2 * h + 1]);
            float(&oe)[4] = o[4 * cc + 2 * h];
            float(&od)[4] = o[4 * cc + 2 * h + 1];
            mma16816(oe, ph, e0, e1);
            mma16816(oe, pl, e0, e1);
            mma16816(od, ph, d0, d1);
            mma16816(od, pl, d0, d1);
          }
        } else {
          mma16816(o[2 * cc], ph, v[0], v[1]);
          mma16816(o[2 * cc], pl, v[0], v[1]);
          mma16816(o[2 * cc + 1], ph, v[2], v[3]);
          mma16816(o[2 * cc + 1], pl, v[2], v[3]);
        }
      }
    }
    __syncwarp();  // this stage's reads are done before it is refilled
  }
  cp_async_wait<0>();

  // Merge the warps: each writes its acc rows and (m, l) into the ring.
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, w);
    l1 += __shfl_xor_sync(kFull, l1, w);
  }
  __syncthreads();  // every warp is done with the ring
  float* acc_s = reinterpret_cast<float*>(ring);             // [warp][16][D]
  float* ml_s = acc_s + kWarps * kMaxGroup * D;              // [warp][16][2]
  float* wt_s = ml_s + kWarps * kMaxGroup * 2;               // [16][kWarps + 1]
  float* mine = acc_s + warp * kMaxGroup * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int d;
      if constexpr (kFp8) {
        const int c = 2 * (i >> 2) + ((i & 3) >> 1);
        d = 16 * c + 4 * t4 + 2 * (e & 1) + (i & 1);
      } else {
        d = 8 * i + 2 * t4 + (e & 1);
      }
      mine[(g + 8 * (e >> 1)) * D + d] = o[i][e];
    }
  }
  if (t4 == 0) {
    float* ml = ml_s + warp * kMaxGroup * 2;
    ml[2 * g] = m0;
    ml[2 * g + 1] = l0;
    ml[2 * (g + 8)] = m1;
    ml[2 * (g + 8) + 1] = l1;
  }
  __syncthreads();
  constexpr int kPD = D + 4;  // floats of a partial row: acc, then m and l (16-byte rows)
  if (tid < group) {  // row tid: the warps' weights and the merged (m, l)
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml_s[(w * kMaxGroup + tid) * 2]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f((ml_s[(w * kMaxGroup + tid) * 2] - m) * kLog2e);
      wt_s[tid * (kWarps + 1) + w] = f;
      l += f * ml_s[(w * kMaxGroup + tid) * 2 + 1];
    }
    wt_s[tid * (kWarps + 1) + kWarps] = l;
    if (num_splits > 1) {
      float* pr = part + ((q_row0 + tid) * num_splits + split) * kPD;
      pr[D] = m;
      pr[D + 1] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int h = i / D, d = i % D;
    const float* wt = wt_s + h * (kWarps + 1);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += wt[w] * acc_s[(w * kMaxGroup + h) * D + d];
    const long long r = q_row0 + h;
    if (num_splits == 1) {
      const float l = wt[kWarps];
      out[r * D + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);  // ctx == 0: zeros
    } else {
      part[(r * num_splits + split) * kPD + d] = acc;
    }
  }
  if (num_splits == 1) return;

  // The last span of this (sequence, KV head) to finish merges them all.
  int* last = reinterpret_cast<int*>(smem + Lay::kBytes - 16);
  __threadfence();  // this block's partials are visible before it is counted
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + (long long)s * n_kv + kvh;
    *last = atomicAdd(counter, 1) == num_splits - 1;
    if (*last) *counter = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // Every span's (m, l), one load a thread; then per row the spans'
  // weights; then the rows in float4 chunks, all of a thread's chunks of
  // a span loaded together, so the L2 round trips overlap.
  float* sml = acc_s;                                    // [16][kMaxSplits][2]
  float* sw = sml + kMaxGroup * kMaxSplits * 2;          // [16][kMaxSplits + 1]
  for (int i = tid; i < group * num_splits; i += kThreads) {
    const int h = i / num_splits, k = i % num_splits;
    const float2 v = __ldcg(
        reinterpret_cast<const float2*>(part + ((q_row0 + h) * num_splits + k) * kPD + D));
    sml[(h * kMaxSplits + k) * 2] = v.x;
    sml[(h * kMaxSplits + k) * 2 + 1] = v.y;
  }
  __syncthreads();
  if (tid < group) {
    float m = kNegInf;
    for (int k = 0; k < num_splits; ++k) m = fmaxf(m, sml[(tid * kMaxSplits + k) * 2]);
    float l = 0.f;
    for (int k = 0; k < num_splits; ++k) {
      const float f = exp2f((sml[(tid * kMaxSplits + k) * 2] - m) * kLog2e);
      sw[tid * (kMaxSplits + 1) + k] = f;
      l += f * sml[(tid * kMaxSplits + k) * 2 + 1];
    }
    sw[tid * (kMaxSplits + 1) + kMaxSplits] = l;
  }
  __syncthreads();
  constexpr int kCh = kMaxGroup * D / 4 / kThreads;  // float4 chunks a thread
  float4 acc4[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < num_splits; ++k) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const int i = tid + c * kThreads, h = i / (D / 4), d4 = i % (D / 4);
      if (h < group) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
                                    part + ((q_row0 + h) * num_splits + k) * kPD) + d4);
        const float w = sw[h * (kMaxSplits + 1) + k];
        acc4[c].x += w * v.x;
        acc4[c].y += w * v.y;
        acc4[c].z += w * v.z;
        acc4[c].w += w * v.w;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int i = tid + c * kThreads, h = i / (D / 4), d4 = i % (D / 4);
    if (h >= group) continue;
    const float l = sw[h * (kMaxSplits + 1) + kMaxSplits];
    const float4 a = acc4[c];
    const uint2 o2 = make_uint2(pack_bf16(l > 0.f ? a.x / l : 0.f, l > 0.f ? a.y / l : 0.f),
                                pack_bf16(l > 0.f ? a.z / l : 0.f, l > 0.f ? a.w / l : 0.f));
    *reinterpret_cast<uint2*>(out + (q_row0 + h) * D + 4 * d4) = o2;  // ctx == 0: zeros
  }
}

// The launch arguments after the data pointers, passed through unchanged.
struct Args {
  int num_seqs, n_heads, n_kv, num_pages, page_size, pages_per_seq, layer, window;
  float scale, softcap;
  int num_splits;
};

// The launch's data pointers.
struct Ptrs {
  const void* q;
  void* k_pool;
  void* v_pool;
  const void* k_new;  // K4 only
  const void* v_new;
  const int* bt;
  const int* ctx;
  void* out;
  float* part;
  int* counters;
};

template <typename TKV, int D, int STAGES, bool FUSED_WRITE, int TPS>
cudaError_t launch(const Ptrs& p, const Args& a, cudaStream_t stream) {
  constexpr int smem = Layout<TKV, D, STAGES, TPS>::kBytes;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(paged_decode_tc_kernel<TKV, D, STAGES, FUSED_WRITE, TPS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(a.num_seqs, a.n_kv, a.num_splits);
  paged_decode_tc_kernel<TKV, D, STAGES, FUSED_WRITE, TPS><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(p.q), static_cast<TKV*>(p.k_pool), static_cast<TKV*>(p.v_pool),
      static_cast<const bf16*>(p.k_new), static_cast<const bf16*>(p.v_new), p.bt, p.ctx,
      static_cast<bf16*>(p.out), p.part, p.counters, a.n_heads, a.n_kv, a.num_pages,
      a.page_size, a.pages_per_seq, a.layer, a.window, a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename TKV, int D, bool FUSED_WRITE, int TPS>
cudaError_t launch_stages(int stages, const Ptrs& p, const Args& a, cudaStream_t stream) {
  switch (stages) {
    case 1:
      return launch<TKV, D, 1, FUSED_WRITE, TPS>(p, a, stream);
    case 2:
      return launch<TKV, D, 2, FUSED_WRITE, TPS>(p, a, stream);
    case 3:
      return launch<TKV, D, 3, FUSED_WRITE, TPS>(p, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TKV, bool FUSED_WRITE, int TPS>
cudaError_t launch_dim(int head_dim, int stages, const Ptrs& p, const Args& a,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_stages<TKV, 64, FUSED_WRITE, TPS>(stages, p, a, stream);
    case 128:
      return launch_stages<TKV, 128, FUSED_WRITE, TPS>(stages, p, a, stream);
    case 256:
      return launch_stages<TKV, 256, FUSED_WRITE, TPS>(stages, p, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K4 (new rows given) stages one tile a warp stage; K1 and K5 one or two.
template <typename TKV>
cudaError_t launch_kv(int head_dim, int stages, int tiles_per_stage, const Ptrs& p,
                      const Args& a, cudaStream_t stream) {
  if (p.k_new != nullptr)
    return tiles_per_stage == 1 ? launch_dim<TKV, true, 1>(head_dim, stages, p, a, stream)
                                : cudaErrorInvalidValue;
  switch (tiles_per_stage) {
    case 1:
      return launch_dim<TKV, false, 1>(head_dim, stages, p, a, stream);
    case 2:
      return launch_dim<TKV, false, 2>(head_dim, stages, p, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). bf16 q and out; kv_dtype:
// 1 = bf16, 2 = float8_e5m2 pools (16-byte aligned). k_new / v_new: null
// launches K1 (or K5); given (bf16 [S, n_kv, D], 16-byte aligned), K4,
// which writes them into the pools at ctx - 1. stages: the per-warp ring
// depth, 1, 2 or 3 (1: each stage is copied, then used);
// tiles_per_stage: 16-key tiles a warp's stage holds, 1 (K1, K4) or 2
// (K5: a block's stage is 128 keys).
// softcap <= 0 means no softcap. num_splits (<= 32) > 1 splits each
// row's keys over that many blocks and needs `partials`, f32 scratch of
// num_seqs * n_heads * num_splits * (head_dim + 4) values, and
// `counters`, num_seqs * n_kv int32 zeros (left zero after the launch).
// The launch is asynchronous on `stream`.
int llmq_paged_decode_tc(const void* q, void* k_pool, void* v_pool, const void* k_new,
                         const void* v_new, const void* block_tables,
                         const void* context_lens, void* out,
                         void* partials, void* counters, int kv_dtype, int num_seqs,
                         int n_heads, int n_kv, int head_dim, int num_pages, int page_size,
                         int pages_per_seq, int layer, int window, float scale, float softcap,
                         int num_splits, int stages, int tiles_per_stage, void* stream) {
  if (num_seqs == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxGroup || num_splits < 1 ||
      num_splits > kMaxSplits || page_size < 1 ||
      (num_splits > 1 && (partials == nullptr || counters == nullptr)) ||
      ((k_new == nullptr) != (v_new == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{num_seqs, n_heads, n_kv, num_pages, page_size, pages_per_seq, layer, window,
               scale, softcap, num_splits};
  const Ptrs p{q, k_pool, v_pool, k_new, v_new, static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out, static_cast<float*>(partials),
               static_cast<int*>(counters)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kv_dtype) {
    case 1:
      err = launch_kv<bf16>(head_dim, stages, tiles_per_stage, p, a, st);
      break;
    case 2:
      err = launch_kv<uint8_t>(head_dim, stages, tiles_per_stage, p, a, st);
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
