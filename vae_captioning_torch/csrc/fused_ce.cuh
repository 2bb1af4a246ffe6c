// Shared by the linear cross-entropy kernels for Hopper (sm_90a): the flash
// schedule (fused_ce.cu) and the written-logits schedule (fused_ce_mat.cu).
// Tile shapes, the tile loaders, the WMMA logits tile, and the forward kernel
// with its merge launch, which both schedules run: the flash forward folds
// each f32 logits tile into the per-row (max, sum-exp) and label logit; the
// written-logits forward does the same and also stores the tile as bf16.
//
//   S   = h @ W^T + b        h [M, H], W [V, H] bf16; b f32; f32 accumulation
//   lse = logsumexp_v S,    ll = S[label] (0 for a label that is no column)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;            // bf16 padding of a shared row of H
constexpr float NEG = -1e30f;     // the logit of a vocab column past V

// the forward: 32 rows x 64 vocab columns per logits tile
constexpr int RM = 32;
constexpr int RV = 64;
constexpr int R_S_LD = RV + 4;

// the written logits' row pitch: V rounded up to whole forward tiles
__host__ __device__ __forceinline__ int logits_pitch(int V) {
  return (V + RV - 1) / RV * RV;
}

// rows [r0, r0 + R) of a [rows, H] bf16 matrix into shared [R][H + PAD];
// rows at and past r_end read zeros
template <int H, int R>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ g, int r0,
                                          int r_end, bf16* __restrict__ s) {
  constexpr int PER_ROW = H / 8;
  for (int i = threadIdx.x; i < R * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < r_end)
      x = *reinterpret_cast<const uint4*>(&g[static_cast<size_t>(r0 + r) * H + c]);
    *reinterpret_cast<uint4*>(&s[r * (H + PAD) + c]) = x;
  }
}

// S[MR][NC + 4] (f32, shared) <- hs[MR rows] @ ws[NC rows]^T, contracting H;
// one 16 x 16 fragment per warp
template <int H, int MR, int NC>
__device__ __forceinline__ void logits_tile(const bf16* __restrict__ hs,
                                            const bf16* __restrict__ ws,
                                            float* __restrict__ S) {
  static_assert((MR / 16) * (NC / 16) == WARPS, "one fragment per warp");
  constexpr int LD = H + PAD;
  const int warp = threadIdx.x / 32;
  const int rf = warp / (NC / 16);
  const int cf = warp % (NC / 16);
  AccFrag acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll 8
  for (int k = 0; k < H; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
    wmma::load_matrix_sync(a, &hs[rf * 16 * LD + k], LD);
    wmma::load_matrix_sync(b, &ws[cf * 16 * LD + k], LD);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(&S[rf * 16 * (NC + 4) + cf * 16], acc, NC + 4,
                          wmma::mem_row_major);
}

template <int H>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(RM + RV) * (H + PAD) * sizeof(bf16) +
         static_cast<size_t>(RM) * R_S_LD * sizeof(float);
}

// ---------------------------------------------------------------------
// forward: grid (row tiles, vocab chunks); part [chunks, M, 3] = (m, s, ll).
// With WRITE_LG the f32 tile (pad columns NEG) is also stored, rounded to
// nearest even, as lg [M, logits_pitch(V)] bf16; lse and ll come from the
// f32 tile before the rounding.
// ---------------------------------------------------------------------
template <int H, bool WRITE_LG>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const float* __restrict__ b, const int* __restrict__ labels,
              float* __restrict__ part, bf16* __restrict__ lg, int M, int V,
              int chunk_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = H + PAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + RM * LD;
  float* S = reinterpret_cast<float*>(ws + RV * LD);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * RM;
  const int tiles = (V + RV - 1) / RV;
  const int t0 = blockIdx.y * chunk_tiles;
  const int t1 = min(tiles, t0 + chunk_tiles);
  const int r = tid / 8;          // this thread's row of the tile
  const int q = (tid % 8) * 8;    // and its 8 columns
  const int n = m0 + r;
  const int label = n < M ? labels[n] : -1;
  load_rows<H, RM>(h, m0, M, hs);
  float m_run = -INFINITY, s_run = 0.0f, ll = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * RV;
    load_rows<H, RV>(w, v0, V, ws);
    __syncthreads();
    logits_tile<H, RM, RV>(hs, ws, S);
    __syncthreads();
    float x[8];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v0 + q + j;
      x[j] = col < V ? S[r * R_S_LD + q + j] + b[col] : NEG;
      tmax = fmaxf(tmax, x[j]);
      if (col == label && col < V) ll += x[j];
    }
    if constexpr (WRITE_LG) {
      if (n < M) {
        uint4 packed;
        __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) p2[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
        *reinterpret_cast<uint4*>(
            &lg[static_cast<size_t>(n) * logits_pitch(V) + v0 + q]) = packed;
      }
    }
    // the 8 threads of a row are neighbouring lanes of one warp
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m_run, tmax);   // finite: each tile has a column < V
    float se = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) se += expf(x[j] - m_new);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
    s_run = s_run * expf(m_run - m_new) + se;
    m_run = m_new;
    __syncthreads();              // the next tile rewrites ws and S
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) ll += __shfl_xor_sync(0xffffffffu, ll, o);
  if (tid % 8 == 0 && n < M) {
    float* p = part + (static_cast<size_t>(blockIdx.y) * M + n) * 3;
    p[0] = m_run;
    p[1] = s_run;
    p[2] = ll;
  }
}

// lse[n] = m + log(sum_c s_c exp(m_c - m)), ll[n] = sum_c ll_c, c in order
__global__ void ce_merge_kernel(const float* __restrict__ part, int chunks,
                                int M, float* __restrict__ lse,
                                float* __restrict__ ll) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= M) return;
  float m = -INFINITY;
  for (int c = 0; c < chunks; ++c)
    m = fmaxf(m, part[(static_cast<size_t>(c) * M + n) * 3]);
  float s = 0.0f, l = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const float* p = part + (static_cast<size_t>(c) * M + n) * 3;
    s += p[1] * expf(p[0] - m);
    l += p[2];
  }
  lse[n] = m + logf(s);
  ll[n] = l;
}

// out[i] = sum over s of part[s * stride + i], s in order, i < len
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  size_t stride, size_t len,
                                  float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += part[static_cast<size_t>(s) * stride + i];
  out[i] = acc;
}

int sum_splits(const float* part, int splits, size_t stride, size_t len,
               float* out, cudaStream_t st) {
  sum_splits_kernel<<<static_cast<unsigned>((len + THREADS - 1) / THREADS),
                      THREADS, 0, st>>>(part, splits, stride, len, out);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory above 48 KB, and the whole carve-out for it, so
// that two blocks fit on an SM
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int H, bool WRITE_LG>
int launch_fwd(const bf16* h, const bf16* w, const float* b, const int* labels,
               float* part, bf16* lg, float* lse, float* ll, int M, int V,
               int chunk_tiles, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<H>();
  int err = allow_smem(ce_fwd_kernel<H, WRITE_LG>, smem);
  if (err) return err;
  const int tiles = (V + RV - 1) / RV;
  const int chunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid((M + RM - 1) / RM, chunks);
  ce_fwd_kernel<H, WRITE_LG><<<grid, THREADS, smem, st>>>(h, w, b, labels, part,
                                                          lg, M, V, chunk_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ce_merge_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, chunks,
                                                                  M, lse, ll);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int H, int V) {
  return M <= 0 || V <= 0 || (H != 64 && H != 128 && H != 256 && H != 512);
}

}  // namespace

// an entry point's switch over the widths the kernels are built for
#define VCT_CE_SWITCH_H(CALL)   \
  switch (H) {                  \
    case 64: return CALL(64);   \
    case 128: return CALL(128); \
    case 256: return CALL(256); \
    default: return CALL(512);  \
  }
