// The register-resident top-k list of the decode kernels
// (fused_logits_topk.cu, topk_lse.cu): the K best (value, index) pairs
// seen, ordered by value descending, then index ascending, so ties go to
// the lowest index as jax.lax.top_k gives them.  Values are copied, never
// computed, so a kernel's list equals a stable sort's prefix bit for bit.

#pragma once

#include <math.h>

namespace {

constexpr int EMPTY_IDX = 0x7fffffff;

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

}  // namespace
