// Row-wise exact top-k + logsumexp over materialised f32 logits, for
// Hopper (sm_90a), exported with a plain C interface and loaded through
// ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernel vae_captioning_tpu/ops/topk_pallas.py (_kernel,
// called through top_k_logsumexp_pallas), the beam search's top-k when the
// decode step writes its logits (Config.fused_decode = False):
//
//     vals, idx = top_k(x, k)     ties go to the lowest index
//     lse = logsumexp(x)
//
// x [N,V] f32 -> vals [N,k] f32, idx [N,k] int32, lse [N] f32, for
// 1 <= k <= 16.  Values are copied, never computed, so vals and idx equal
// a stable sort's prefix bit for bit; only lse differs from the plain
// version, by sum order.
//
// What bounds it on this card: reading x once (70.7 MB at N = 1536, V =
// 11500: 21 us at 3.35 TB/s); the work per element is one compare, one
// exp and, rarely, an insertion.  The TPU kernel makes k full extraction
// passes over a row held in VMEM; here one block of 256 threads scans a
// row once (coalesced, column = thread + 256 j), each thread keeping an
// online (max, sum-exp) and a register top-k list ordered by (value desc,
// index asc).  The lists merge by warp shuffles, then across the eight
// warps in shared memory.  No vector loads yet (a row of 11519 floats
// starts at any 4-byte offset).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// (max, sum of exp(x - max)) of two parts merged; a part that saw no
// element has max -inf and adds nothing
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float om,
                                              float os) {
  const float nm = fmaxf(m, om);
  float ns = 0.0f;
  if (m > -INFINITY) ns += s * expf(m - nm);
  if (om > -INFINITY) ns += os * expf(om - nm);
  m = nm;
  s = ns;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
topk_lse_kernel(const float* __restrict__ x, float* __restrict__ vals,
                int* __restrict__ idx, float* __restrict__ lse, int V) {
  __shared__ float sv[WARPS][K];
  __shared__ int si[WARPS][K];
  __shared__ float sm[WARPS], ss[WARPS];

  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float* xr = x + static_cast<size_t>(row) * V;

  TopK<K> top;
  top.init();
  float m = -INFINITY;
  float s = 0.0f;
  for (int col = threadIdx.x; col < V; col += THREADS) {
    const float v = xr[col];
    if (v > m) {
      s = (m > -INFINITY ? s * expf(m - v) : 0.0f) + 1.0f;
      m = v;
    } else if (v > -INFINITY) {
      s += expf(v - m);
    }
    top.push(v, col);
  }

  // tree merge inside the warp: lane l takes lane l + off's state
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(FULL, m, off);
    const float os = __shfl_down_sync(FULL, s, off);
    float ov[K];
    int oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ov[j] = __shfl_down_sync(FULL, top.v[j], off);
      oi[j] = __shfl_down_sync(FULL, top.i[j], off);
    }
    if (lane < off) {
      merge_max_sum(m, s, om, os);
#pragma unroll
      for (int j = 0; j < K; ++j) top.push(ov[j], oi[j]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sv[warp][j] = top.v[j];
      si[warp][j] = top.i[j];
    }
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      merge_max_sum(m, s, sm[w], ss[w]);
#pragma unroll
      for (int j = 0; j < K; ++j) top.push(sv[w][j], si[w][j]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vals[static_cast<size_t>(row) * K + j] = top.v[j];
      idx[static_cast<size_t>(row) * K + j] = top.i[j];
    }
    lse[row] = m + logf(s);
  }
}

}  // namespace

// x [N,V] f32 contiguous; vals [N,k] f32, idx [N,k] int32, lse [N] f32.
// Returns a cudaError_t as int.
extern "C" int vct_top_k_logsumexp(const void* x, void* vals, void* idx,
                                   void* lse, int N, int V, int k,
                                   void* stream) {
  if (N <= 0) return 0;
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(idx);
  float* lp = static_cast<float*>(lse);
#define VCT_CASE(KK)                                                    \
  case KK:                                                              \
    topk_lse_kernel<KK><<<N, THREADS, 0, s>>>(xp, vp, ip, lp, V);       \
    break;
  switch (k) {
    VCT_CASE(1) VCT_CASE(2) VCT_CASE(3) VCT_CASE(4)
    VCT_CASE(5) VCT_CASE(6) VCT_CASE(7) VCT_CASE(8)
    VCT_CASE(9) VCT_CASE(10) VCT_CASE(11) VCT_CASE(12)
    VCT_CASE(13) VCT_CASE(14) VCT_CASE(15) VCT_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCT_CASE
  return static_cast<int>(cudaGetLastError());
}
