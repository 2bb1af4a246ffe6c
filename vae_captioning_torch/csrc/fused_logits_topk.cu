// Fused logits product + exact top-k + logsumexp, its int8 variant, and
// fused Gumbel-max sampling, for Hopper (sm_90a), exported with a plain C
// interface and loaded through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_logits_topk.py:
//
//   _kernel (+ _fold_tile), through fused_logits_top_k:
//     logits = h @ W + b            bf16 operands, f32 accumulation
//     vals, idx = top_k(logits, k)  ties go to the lowest vocab index
//     lse = logsumexp(logits)
//   _kernel_int8 (+ _fold_tile), through fused_logits_top_k_int8:
//     logits = f32(hq @ wq) * hs * ws + b   int8 operands, int32 accumulation
//     then the same top-k and logsumexp
//   _sample_kernel, through fused_logits_sample:
//     token = argmax_v(logits_v * inv_temp + G_v),  G = -log(-log(u))
//
// h [M,H] bf16, W [H,V] bf16, b [V] f32; hq [M,H] int8 with per-row
// scales hs [M] f32, wq [H,V] int8 stored column-major (wq^T [V,H]
// contiguous) with per-column scales ws [V] f32 ->
// vals [M,k] f32 (raw logits, bias included), idx [M,k] int32, lse [M]
// f32, for 1 <= k <= 16; the sampler -> tokens [M] int32.
//
// What bounds it on this card: the product is 2*M*H*V operations (18 G at
// M = 1536, H = 512, V = 11500) over an 11.8 MB bf16 (5.9 MB int8) weight
// matrix, and the unfused path writes and re-reads the [M,V] f32 logits
// (71 MB at that size).  The design never stores the logits.  The TPU
// walks the vocab tiles in order with a running state in VMEM; on Hopper
// blocks run in no order, so the vocab is split into chunks across blocks
// (grid = row blocks x vocab chunks, enough blocks for the 132 SMs at
// serving sizes).  Each block computes 64x128 logits tiles with WMMA
// fragments into shared memory -- the tile producer is a template
// parameter, as the TPU's _fold_tile takes a tile_fn: bf16 x bf16 -> f32,
// or s8 x s8 -> s32 dequantised in the fold -- and folds them into
// per-thread running state: four threads share a row, each keeps an
// online (max, sum-exp) and a register-resident top-k list ordered by
// (value desc, index asc).  The sampler is the same kernel with k = 1 over
// the scored values logit * inv_temp + G and no logsumexp.  Their lists go
// to a small workspace, and a second launch merges the partial lists and
// (max, sum-exp) pairs of a row in the same order.  The TPU's int32
// sortable-key trick is a VPU optimisation and is not carried over.  No
// cp.async, TMA or wgmma yet.
//
// The sampler's noise: Philox-4x32-10 keyed on (seed, step), element
// (row m, column v) is word v % 4 of the block with counter
// (v / 4, row0 + m, 0, SAMPLE_TAG); fused_z's counters have 0 in the last
// word, so the two streams never meet.  The stream does not depend on the
// tiling, so ops/fused_logits_topk.py:fused_logits_sample_plain
// reproduces its bits exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "philox.cuh"
#include "topk_list.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // rows per block
constexpr int BN = 128;         // vocab columns per logits tile
constexpr int THREADS = 256;    // 8 warps: 4 row slabs x 2 column halves
constexpr int LANES = THREADS / BM;  // fold threads per row
constexpr int C_LD = BN + 4;
constexpr int MERGE_THREADS = 128;
constexpr uint32_t SAMPLE_TAG = 0x53414D50u;  // "SAMP"

// ---------------------------------------------------------------------
// tile producers: one BM x BN tile of the product into shared memory,
// then the logit of one of its elements
// ---------------------------------------------------------------------

struct Bf16Tile {
  static constexpr int BK = 32;   // depth of one shared-memory stage
  static constexpr int A_LD = BK + 8;
  static constexpr int B_LD = BN + 8;
  struct __align__(128) Smem {
    __nv_bfloat16 a[BM * A_LD];
    __nv_bfloat16 b[BK * B_LD];
    float c[BM * C_LD];
  };

  const __nv_bfloat16* h;
  const __nv_bfloat16* w;
  const float* bias;
  int H;

  __device__ __forceinline__ float row_scale(int) const { return 1.0f; }

  __device__ __forceinline__ void compute(Smem& s, int m0, int n0, int v_end,
                                          int M, int V) const {
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = warp / 2;
    const int wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);

    for (int k0 = 0; k0 < H; k0 += BK) {
      {  // A stage [BM, BK]: one 8-element vector per thread
        const int r = tid / (BK / 8);
        const int cv = (tid % (BK / 8)) * 8;
        const int row = m0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row < M)
          val = *reinterpret_cast<const uint4*>(
              &h[static_cast<size_t>(row) * H + k0 + cv]);
        *reinterpret_cast<uint4*>(&s.a[r * A_LD + cv]) = val;
      }
      // B stage [BK, BN]: element loads, since a row of W starts at any
      // 2-byte offset when V is odd
#pragma unroll
      for (int st = 0; st < (BK * BN) / THREADS; ++st) {
        const int e = tid + st * THREADS;
        const int kr = e / BN;
        const int n = e % BN;
        const int col = n0 + n;
        s.b[kr * B_LD + n] =
            col < v_end ? w[static_cast<size_t>(k0 + kr) * V + col]
                        : __float2bfloat16_rn(0.0f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, &s.a[(wm * 16) * A_LD + kk], A_LD);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &s.b[kk * B_LD + wn * 64 + f * 16],
                                 B_LD);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      wmma::store_matrix_sync(&s.c[(wm * 16) * C_LD + wn * 64 + f * 16],
                              acc[f], C_LD, wmma::mem_row_major);
    __syncthreads();
  }

  __device__ __forceinline__ float logit(const Smem& s, int r, int n, int col,
                                         float) const {
    return s.c[r * C_LD + n] + bias[col];
  }
};

// int8 x int8 -> int32 on the tensor cores (WMMA s8 m16n16k16).  A WMMA
// operand must start 32-byte aligned, and a 16-deep int8 step is 16
// bytes, so both stages are kept as 16-deep chunks: A as [chunk][row][16],
// B as [chunk][column block][16 columns][16 deep] -- column-major, the
// layout the s8 mma reads (8-bit ldmatrix cannot transpose, so a
// row-major B fragment is loaded byte by byte).  wq comes column-major
// too (wq_t [V, H]), so both stages move 16-byte vectors.
struct Int8Tile {
  static constexpr int BK = 64;
  static constexpr int KC = BK / 16;
  struct __align__(128) Smem {
    signed char a[KC][BM][16];
    signed char b[KC][BN / 16][16][16];
    int c[BM * C_LD];
  };

  const signed char* hq;
  const float* hs;
  const signed char* wq_t;   // [V, H]
  const float* ws;
  const float* bias;
  int H;

  __device__ __forceinline__ float row_scale(int row) const { return hs[row]; }

  __device__ __forceinline__ void compute(Smem& s, int m0, int n0, int v_end,
                                          int M, int V) const {
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = warp / 2;
    const int wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0);

    for (int k0 = 0; k0 < H; k0 += BK) {
      {  // A stage [BM, BK]: one 16-byte chunk per thread
        const int r = tid / KC;
        const int q = tid % KC;
        const int row = m0 + r;
        int4 val = make_int4(0, 0, 0, 0);
        if (row < M)
          val = *reinterpret_cast<const int4*>(
              &hq[static_cast<size_t>(row) * H + k0 + q * 16]);
        *reinterpret_cast<int4*>(&s.a[q][r][0]) = val;
      }
      // B stage [BK, BN]: one 16-deep chunk of one column per vector,
      // neighbouring threads on neighbouring columns
#pragma unroll
      for (int st = 0; st < (BK * BN) / (16 * THREADS); ++st) {
        const int e = tid + st * THREADS;
        const int n = e % BN;
        const int q = e / BN;
        const int col = n0 + n;
        int4 val = make_int4(0, 0, 0, 0);
        if (col < v_end)
          val = *reinterpret_cast<const int4*>(
              &wq_t[static_cast<size_t>(col) * H + k0 + q * 16]);
        *reinterpret_cast<int4*>(&s.b[q][n / 16][n % 16][0]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, &s.a[q][wm * 16][0], 16);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(bf, &s.b[q][wn * 4 + f][0][0], 16);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      wmma::store_matrix_sync(&s.c[(wm * 16) * C_LD + wn * 64 + f * 16],
                              acc[f], C_LD, wmma::mem_row_major);
    __syncthreads();
  }

  // (f32(acc) * hs) * ws + b, each step rounded on its own (no FMA), in
  // the order of the TPU kernel and of the plain version
  __device__ __forceinline__ float logit(const Smem& s, int r, int n, int col,
                                         float rs) const {
    return __fadd_rn(
        __fmul_rn(__fmul_rn(__int2float_rn(s.c[r * C_LD + n]), rs), ws[col]),
        bias[col]);
  }
};

// ---------------------------------------------------------------------
// what is folded: the raw logit (top-k + logsumexp), or the Gumbel-scored
// logit (sampling: top-1 only)
// ---------------------------------------------------------------------

struct RawLogit {
  static constexpr bool kLse = true;
  __device__ __forceinline__ float operator()(float x, int, int) const {
    return x;
  }
};

struct GumbelScore {
  static constexpr bool kLse = false;
  uint32_t seed, step;
  float inv_temp;
  int row0;

  __device__ __forceinline__ float operator()(float x, int row,
                                              int col) const {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(col) >> 2,
                   static_cast<uint32_t>(row0 + row), 0u, SAMPLE_TAG),
        seed, step);
    const float u = bits_to_uniform(philox_word(r, col & 3));
    const float g = -logf(-logf(u));
    return __fadd_rn(__fmul_rn(x, inv_temp), g);
  }
};

struct Parts {
  float* vals;   // [P, M, K]
  int* idx;      // [P, M, K]
  float* max;    // [P, M]
  float* sum;    // [P, M]
};

template <class Tile, class Score, int K>
__global__ void __launch_bounds__(THREADS)
logits_topk_partial_kernel(const Tile tile, const Score score, Parts part,
                           int M, int V, int chunk_w) {
  __shared__ typename Tile::Smem smem;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int v_begin = blockIdx.y * chunk_w;
  const int v_end = min(V, v_begin + chunk_w);
  // fold mapping: row fr, columns fq, fq + LANES, ... of each tile (the
  // interleave keeps the shared-memory reads free of bank conflicts)
  const int fr = tid / LANES;
  const int fq = tid % LANES;
  const int row = m0 + fr;
  const float rs = tile.row_scale(min(row, M - 1));

  TopK<K> top;
  top.init();
  float run_max = -INFINITY;
  float run_sum = 0.0f;

  for (int n0 = v_begin; n0 < v_end; n0 += BN) {
    tile.compute(smem, m0, n0, v_end, M, V);

    // fold the tile: online logsumexp + running top-k, columns ascending
    for (int j = 0; j < BN / LANES; ++j) {
      const int n = j * LANES + fq;
      const int col = n0 + n;
      if (col >= v_end) break;
      const float val = score(tile.logit(smem, fr, n, col, rs), row, col);
      if (Score::kLse) {
        if (val > run_max) {
          run_sum = run_sum * expf(run_max - val) + 1.0f;
          run_max = val;
        } else {
          run_sum += expf(val - run_max);
        }
      }
      top.push(val, col);
    }
    __syncthreads();
  }

  if (row < M) {
    const size_t p = static_cast<size_t>(blockIdx.y) * LANES + fq;
    const size_t slot = p * M + row;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part.vals[slot * K + j] = top.v[j];
      part.idx[slot * K + j] = top.i[j];
    }
    if (Score::kLse) {
      part.max[slot] = run_max;
      part.sum[slot] = run_sum;
    }
  }
}

// One thread per row: merge the P partial lists and (max, sum-exp) pairs.
template <int K, bool kLse>
__global__ void __launch_bounds__(MERGE_THREADS)
logits_topk_merge_kernel(const Parts part, float* __restrict__ vals,
                         int* __restrict__ idx, float* __restrict__ lse,
                         int M, int P) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  float m = -INFINITY;
  if (kLse)
    for (int p = 0; p < P; ++p)
      m = fmaxf(m, part.max[static_cast<size_t>(p) * M + row]);
  float s = 0.0f;
  TopK<K> top;
  top.init();
  for (int p = 0; p < P; ++p) {
    const size_t slot = static_cast<size_t>(p) * M + row;
    if (kLse) {
      const float mp = part.max[slot];
      if (mp > -INFINITY) s += part.sum[slot] * expf(mp - m);
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      top.push(part.vals[slot * K + j], part.idx[slot * K + j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    vals[static_cast<size_t>(row) * K + j] = top.v[j];
    idx[static_cast<size_t>(row) * K + j] = top.i[j];
  }
  if (kLse) lse[row] = m + logf(s);
}

template <class Tile, class Score, int K>
int launch(const Tile& tile, const Score& score, const Parts& part,
           void* vals, void* idx, void* lse, int M, int V, int chunk_w,
           int n_chunks, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, n_chunks);
  logits_topk_partial_kernel<Tile, Score, K>
      <<<grid, THREADS, 0, stream>>>(tile, score, part, M, V, chunk_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  logits_topk_merge_kernel<K, Score::kLse>
      <<<(M + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0, stream>>>(
          part, static_cast<float*>(vals), static_cast<int*>(idx),
          static_cast<float*>(lse), M, n_chunks * LANES);
  return static_cast<int>(cudaGetLastError());
}

template <class Tile>
int launch_top_k(const Tile& tile, const Parts& part, void* vals, void* idx,
                 void* lse, int M, int V, int k, int chunk_w, int n_chunks,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VCT_CASE(KK)                                                     \
  case KK:                                                               \
    return launch<Tile, RawLogit, KK>(tile, RawLogit{}, part, vals, idx, \
                                      lse, M, V, chunk_w, n_chunks, s);
  switch (k) {
    VCT_CASE(1) VCT_CASE(2) VCT_CASE(3) VCT_CASE(4)
    VCT_CASE(5) VCT_CASE(6) VCT_CASE(7) VCT_CASE(8)
    VCT_CASE(9) VCT_CASE(10) VCT_CASE(11) VCT_CASE(12)
    VCT_CASE(13) VCT_CASE(14) VCT_CASE(15) VCT_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCT_CASE
}

bool bad_plan(int chunk_w, int n_chunks) {
  return chunk_w % BN != 0 || n_chunks <= 0;
}

}  // namespace

// Partial workspace sizes the caller allocates, with P = n_chunks * 4
// partials per row: part_vals [P, M, k] f32, part_idx [P, M, k] int32,
// part_max and part_sum [P, M] f32.  chunk_w is a multiple of 128 and
// n_chunks = ceil(V / chunk_w).  Returns a cudaError_t as int.
extern "C" int vct_fused_logits_top_k(const void* h, const void* w,
                                      const void* b, void* part_vals,
                                      void* part_idx, void* part_max,
                                      void* part_sum, void* vals, void* idx,
                                      void* lse, int M, int H, int V, int k,
                                      int chunk_w, int n_chunks,
                                      void* stream) {
  if (M <= 0) return 0;
  if (H % Bf16Tile::BK != 0 || bad_plan(chunk_w, n_chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bf16Tile tile{static_cast<const __nv_bfloat16*>(h),
                      static_cast<const __nv_bfloat16*>(w),
                      static_cast<const float*>(b), H};
  const Parts part{static_cast<float*>(part_vals), static_cast<int*>(part_idx),
                   static_cast<float*>(part_max), static_cast<float*>(part_sum)};
  return launch_top_k(tile, part, vals, idx, lse, M, V, k, chunk_w, n_chunks,
                      stream);
}

// The int8 variant: hq [M,H] int8, hs [M] f32, wq_t [V,H] int8 (the
// head transposed), ws and b [V] f32; H a multiple of 64, hq and wq_t
// 16-byte aligned.  Workspace and outputs as vct_fused_logits_top_k.
extern "C" int vct_fused_logits_top_k_int8(
    const void* hq, const void* hs, const void* wq_t, const void* ws,
    const void* b, void* part_vals, void* part_idx, void* part_max,
    void* part_sum, void* vals, void* idx, void* lse, int M, int H, int V,
    int k, int chunk_w, int n_chunks, void* stream) {
  if (M <= 0) return 0;
  if (H % Int8Tile::BK != 0 || bad_plan(chunk_w, n_chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Int8Tile tile{static_cast<const signed char*>(hq),
                      static_cast<const float*>(hs),
                      static_cast<const signed char*>(wq_t),
                      static_cast<const float*>(ws),
                      static_cast<const float*>(b), H};
  const Parts part{static_cast<float*>(part_vals), static_cast<int*>(part_idx),
                   static_cast<float*>(part_max), static_cast<float*>(part_sum)};
  return launch_top_k(tile, part, vals, idx, lse, M, V, k, chunk_w, n_chunks,
                      stream);
}

// One Gumbel-max draw per row: tokens [M] int32.  Workspace part_vals and
// part_idx [P, M] (k = 1), vals [M] f32 (the winning scored values).
extern "C" int vct_fused_logits_sample(const void* h, const void* w,
                                       const void* b, void* part_vals,
                                       void* part_idx, void* vals,
                                       void* tokens, int M, int H, int V,
                                       unsigned seed, unsigned step,
                                       float inv_temp, int row0, int chunk_w,
                                       int n_chunks, void* stream) {
  if (M <= 0) return 0;
  if (H % Bf16Tile::BK != 0 || bad_plan(chunk_w, n_chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bf16Tile tile{static_cast<const __nv_bfloat16*>(h),
                      static_cast<const __nv_bfloat16*>(w),
                      static_cast<const float*>(b), H};
  const GumbelScore score{seed, step, inv_temp, row0};
  const Parts part{static_cast<float*>(part_vals), static_cast<int*>(part_idx),
                   nullptr, nullptr};
  return launch<Bf16Tile, GumbelScore, 1>(tile, score, part, vals, tokens,
                                          nullptr, M, V, chunk_w, n_chunks,
                                          static_cast<cudaStream_t>(stream));
}

// Number of partial lists per row for a given chunk count.
extern "C" int vct_logits_top_k_lanes() { return LANES; }
