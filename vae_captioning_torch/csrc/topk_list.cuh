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

  // (val, idx) where idx is larger than every index in the list (a lane's
  // columns arrive in ascending order): equal values stay ahead of it, so
  // entry j moves down where val > v[j - 1] and val lands where val > v[j]
  // first holds.  Branch-free, every slot from the old list: no divergence
  // where some lanes insert and some do not, and the lists of a thread's
  // rows update side by side.
  __device__ __forceinline__ void push_ascending(float val, int idx) {
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool here = val > v[j];
      const bool above = val > v[j - 1];
      v[j] = above ? v[j - 1] : here ? val : v[j];
      i[j] = above ? i[j - 1] : here ? idx : i[j];
    }
    const bool first = val > v[0];
    v[0] = first ? val : v[0];
    i[0] = first ? idx : i[0];
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
