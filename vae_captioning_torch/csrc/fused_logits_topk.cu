// Fused logits product + exact top-k + logsumexp for Hopper (sm_90a),
// exported with a plain C interface and loaded through ctypes
// (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernel vae_captioning_tpu/ops/fused_logits_topk.py
// (_kernel and _fold_tile, called through fused_logits_top_k):
//
//     logits = h @ W + b            bf16 operands, f32 accumulation
//     vals, idx = top_k(logits, k)  ties go to the lowest vocab index
//     lse = logsumexp(logits)
//
// h [M,H] bf16, W [H,V] bf16, b [V] f32 -> vals [M,k] f32 (raw logits,
// bias included), idx [M,k] int32, lse [M] f32, for 1 <= k <= 16.
//
// What bounds it on this card: the product is 2*M*H*V flops (18 GFLOP
// at M = 1536, H = 512, V = 11500) over an 11.8 MB weight matrix, and
// the unfused path writes and re-reads the [M,V] f32 logits (71 MB at
// that size) and sorts them.  The design never stores the logits.  The
// TPU walks the vocab tiles in order with a running state in VMEM; on
// Hopper blocks run in no order, so the vocab is split into chunks
// across blocks (grid = row blocks x vocab chunks, enough blocks for
// the 132 SMs at serving sizes).  Each block computes 64x128 logits
// tiles with WMMA bf16 fragments into shared memory and folds them into
// per-thread running state: four threads share a row, each keeps an
// online (max, sum-exp) and a register-resident top-k list ordered by
// (value desc, index asc).  Their lists go to a small workspace, and a
// second launch merges the partial lists and (max, sum-exp) pairs of a
// row in the same order.  The TPU's int32 sortable-key trick is a VPU
// optimisation and is not carried over.  No cp.async, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // rows per block
constexpr int BN = 128;         // vocab columns per logits tile
constexpr int BK = 32;          // depth of one shared-memory stage
constexpr int THREADS = 256;    // 8 warps: 4 row slabs x 2 column halves
constexpr int LANES = THREADS / BM;  // fold threads per row
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int EMPTY_IDX = 0x7fffffff;
constexpr int MERGE_THREADS = 128;

// Sorted (value desc, index asc) list of the K best entries seen.
template <int K>
struct TopK {
  float v[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = -INFINITY;
      i[j] = EMPTY_IDX;
    }
  }

  __device__ __forceinline__ static bool better(float a, int ia, float b,
                                                int ib) {
    return a > b || (a == b && ia < ib);
  }

  __device__ __forceinline__ void push(float val, int idx) {
    if (!better(val, idx, v[K - 1], i[K - 1])) return;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (better(val, idx, v[j], i[j])) {
        const float tv = v[j];
        const int ti = i[j];
        v[j] = val;
        i[j] = idx;
        val = tv;
        idx = ti;
      }
    }
  }
};

template <int K>
__global__ void __launch_bounds__(THREADS)
logits_topk_partial_kernel(const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ part_vals,
                           int* __restrict__ part_idx,
                           float* __restrict__ part_max,
                           float* __restrict__ part_sum,
                           int M, int H, int V, int chunk_w) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.x * BM;
  const int v_begin = blockIdx.y * chunk_w;
  const int v_end = min(V, v_begin + chunk_w);
  // fold mapping: row fr, columns fq, fq + LANES, ... of each tile (the
  // interleave keeps the shared-memory reads free of bank conflicts)
  const int fr = tid / LANES;
  const int fq = tid % LANES;

  TopK<K> top;
  top.init();
  float run_max = -INFINITY;
  float run_sum = 0.0f;

  for (int n0 = v_begin; n0 < v_end; n0 += BN) {
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
        *reinterpret_cast<uint4*>(&As[r * A_LD + cv]) = val;
      }
      // B stage [BK, BN]: element loads, since a row of W starts at any
      // 2-byte offset when V is odd
#pragma unroll
      for (int s = 0; s < (BK * BN) / THREADS; ++s) {
        const int e = tid + s * THREADS;
        const int kr = e / BN;
        const int n = e % BN;
        const int col = n0 + n;
        Bs[kr * B_LD + n] =
            col < v_end ? w[static_cast<size_t>(k0 + kr) * V + col]
                        : __float2bfloat16_rn(0.0f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, &As[(wm * 16) * A_LD + kk], A_LD);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &Bs[kk * B_LD + wn * 64 + f * 16],
                                 B_LD);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      wmma::store_matrix_sync(&Cs[(wm * 16) * C_LD + wn * 64 + f * 16],
                              acc[f], C_LD, wmma::mem_row_major);
    __syncthreads();

    // fold the tile: online logsumexp + running top-k, columns ascending
    const float* crow = &Cs[fr * C_LD];
    for (int j = 0; j < BN / LANES; ++j) {
      const int n = j * LANES + fq;
      const int col = n0 + n;
      if (col >= v_end) break;
      const float val = crow[n] + b[col];
      if (val > run_max) {
        run_sum = run_sum * expf(run_max - val) + 1.0f;
        run_max = val;
      } else {
        run_sum += expf(val - run_max);
      }
      top.push(val, col);
    }
    __syncthreads();
  }

  const int row = m0 + fr;
  if (row < M) {
    const size_t p = static_cast<size_t>(blockIdx.y) * LANES + fq;
    const size_t slot = p * M + row;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      part_vals[slot * K + j] = top.v[j];
      part_idx[slot * K + j] = top.i[j];
    }
    part_max[slot] = run_max;
    part_sum[slot] = run_sum;
  }
}

// One thread per row: merge the P partial lists and (max, sum-exp) pairs.
template <int K>
__global__ void __launch_bounds__(MERGE_THREADS)
logits_topk_merge_kernel(const float* __restrict__ part_vals,
                         const int* __restrict__ part_idx,
                         const float* __restrict__ part_max,
                         const float* __restrict__ part_sum,
                         float* __restrict__ vals, int* __restrict__ idx,
                         float* __restrict__ lse, int M, int P) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= M) return;
  float m = -INFINITY;
  for (int p = 0; p < P; ++p)
    m = fmaxf(m, part_max[static_cast<size_t>(p) * M + row]);
  float s = 0.0f;
  TopK<K> top;
  top.init();
  for (int p = 0; p < P; ++p) {
    const size_t slot = static_cast<size_t>(p) * M + row;
    const float mp = part_max[slot];
    if (mp > -INFINITY) s += part_sum[slot] * expf(mp - m);
#pragma unroll
    for (int j = 0; j < K; ++j)
      top.push(part_vals[slot * K + j], part_idx[slot * K + j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    vals[static_cast<size_t>(row) * K + j] = top.v[j];
    idx[static_cast<size_t>(row) * K + j] = top.i[j];
  }
  lse[row] = m + logf(s);
}

template <int K>
int launch(const void* h, const void* w, const void* b, void* part_vals,
           void* part_idx, void* part_max, void* part_sum, void* vals,
           void* idx, void* lse, int M, int H, int V, int chunk_w,
           int n_chunks, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, n_chunks);
  logits_topk_partial_kernel<K><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<float*>(part_vals), static_cast<int*>(part_idx),
      static_cast<float*>(part_max), static_cast<float*>(part_sum), M, H, V,
      chunk_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  logits_topk_merge_kernel<K>
      <<<(M + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0, stream>>>(
          static_cast<const float*>(part_vals),
          static_cast<const int*>(part_idx),
          static_cast<const float*>(part_max),
          static_cast<const float*>(part_sum), static_cast<float*>(vals),
          static_cast<int*>(idx), static_cast<float*>(lse), M,
          n_chunks * LANES);
  return static_cast<int>(cudaGetLastError());
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
  if (H % BK != 0 || chunk_w % BN != 0 || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VCT_CASE(KK)                                                       \
  case KK:                                                                 \
    return launch<KK>(h, w, b, part_vals, part_idx, part_max, part_sum,    \
                      vals, idx, lse, M, H, V, chunk_w, n_chunks, s);
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

// Number of partial lists per row for a given chunk count.
extern "C" int vct_logits_top_k_lanes() { return LANES; }
