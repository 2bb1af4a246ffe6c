// Philox-4x32-10, the counter-based generator of the port's in-kernel
// noise (fused_z.cu: the z draws; fused_logits_topk.cu: the Gumbel noise
// of the sampler).  ops/fused_z.py:philox4x32 computes the same words in
// plain integer ops.
//
// A 23-bit uniform from one word, as the TPU kernels make it:
// u = (bits >> 9) / 2^23, clipped to [1e-7, 1 - 1e-7].

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float u = static_cast<float>(bits >> 9) * (1.0f / 8388608.0f);  // / 2^23
  return fminf(fmaxf(u, 1e-7f), 1.0f - 1e-7f);
}

__device__ __forceinline__ uint32_t philox_word(const uint4& r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

}  // namespace
