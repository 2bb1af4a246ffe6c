// Flash linear cross-entropy for Hopper (sm_90a): the forward (logsumexp and
// label logit), dh and dW/db, exported with a plain C interface and loaded
// through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ce.py:
// _fwd_kernel (:59), _dh_kernel (:134) and _dwdb_kernel (:159), called
// through fused_linear_ce.
//
//   S   = h @ W^T + b                      [M, V]  (never written)
//   lse = logsumexp_v S,    ll = S[label]
//   dl  = (exp(S - lse) - onehot(label)) * gw              f32
//   dh  = bf16(dl) @ W,     dW = bf16(dl)^T @ h,     db = sum over rows of dl
//
// h [M, H] and W [V, H] (the rnn_logits nn.Linear weight, read in that
// layout) in bf16, the products accumulated in f32 by WMMA; b f32.  Padded
// vocab columns count as -inf in the forward and give dl = 0; rows past M
// read zeros and carry gw = 0, so they add nothing.
//
// What bounds it on this card: tensor-core operations.  At the train shapes
// (M = 24 x 1280 = 30720, H = 512, V = 11500) the logits product is 362
// GFLOP: 0.366 ms at the dense bf16 rate for the forward, and 0.732 ms each
// for dh and dW/db, which recompute it (the flash schedule spends those
// operations so that the 707 MB of bf16 logits are never written).  The
// design:
//
// * Forward: a block owns 32 rows (their h kept in shared memory) and a
//   chunk of 16 vocab tiles of 64 columns.  Per tile it loads W's 64 rows
//   whole, runs the [32 x 64] product through WMMA and folds it into each
//   row's online (max, sum-exp) and label pick, 8 threads per row.  A second
//   launch merges the chunks' (m, s, ll) partials in chunk order.
// * dh: a block owns 32 rows and loops over every vocab tile: the same
//   logits product, dl formed in f32 and rounded to bf16 in shared memory,
//   then dh += dl16 @ W_tile from the same W tile in shared memory, the
//   [32, H] accumulator in registers across the loop.  Each element of dh is
//   written once.
// * dW/db: a block owns 32 vocab rows of dW ([V, H], W's own layout; those
//   32 rows of W stay in shared memory) and a range of 64-row tiles.  Per
//   tile: the logits product, dl in f32 (for db) and in bf16, then dW +=
//   dl16^T @ h_tile.  The TPU kernel's [512, 1280] f32 accumulator fits no
//   SM, so the rows are split into ranges whose [V, H] partials a last
//   launch sums in range order (db alike).
// * Determinism: no float atomics.  Every cross-block sum runs in a fixed
//   order, so the gradients repeat bit for bit.
// * No cp.async, TMA or wgmma yet: tiles are loaded with 16-byte loads, and
//   two blocks per SM overlap one block's loads with the other's products.

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

// forward and dh: 32 rows x 64 vocab columns per logits tile
constexpr int RM = 32;
constexpr int RV = 64;
constexpr int R_S_LD = RV + 4;
constexpr int R_DL_LD = RV + PAD;
// dW/db: 64 rows x 32 vocab columns per logits tile
constexpr int WM = 64;
constexpr int WV = 32;
constexpr int W_S_LD = WV + 4;
constexpr int W_DL_LD = WV + PAD;

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

// the logit's gradient, as the TPU kernels form it: (p - onehot) * gw
__device__ __forceinline__ float dlogit(float s, float bias, float lse, int col,
                                        int label, float gw) {
  const float p = expf(s + bias - lse);
  return (p - (col == label ? 1.0f : 0.0f)) * gw;
}

// the per-row operands of the backward tiles: lse, gw and labels of rows
// [m0, m0 + R) in shared memory; rows past M get gw = 0
template <int R>
__device__ __forceinline__ void load_row_args(const float* __restrict__ lse,
                                              const float* __restrict__ gw,
                                              const int* __restrict__ labels,
                                              int m0, int M, float* row_lse,
                                              float* row_gw, int* row_lab) {
  if (threadIdx.x < R) {
    const int n = m0 + threadIdx.x;
    const bool in = n < M;
    row_lse[threadIdx.x] = in ? lse[n] : 0.0f;
    row_gw[threadIdx.x] = in ? gw[n] : 0.0f;
    row_lab[threadIdx.x] = in ? labels[n] : -1;
  }
}

template <int H>
constexpr size_t fwd_smem() {
  return static_cast<size_t>(RM + RV) * (H + PAD) * sizeof(bf16) +
         static_cast<size_t>(RM) * R_S_LD * sizeof(float);
}

template <int H>
constexpr size_t dh_smem() {
  return fwd_smem<H>() + static_cast<size_t>(RM) * R_DL_LD * sizeof(bf16) +
         static_cast<size_t>(RM) * 3 * sizeof(float);
}

template <int H>
constexpr size_t dwdb_smem() {
  return static_cast<size_t>(WM + WV) * (H + PAD) * sizeof(bf16) +
         static_cast<size_t>(WM) * W_S_LD * sizeof(float) +
         static_cast<size_t>(WM) * W_DL_LD * sizeof(bf16) +
         static_cast<size_t>(WM) * 3 * sizeof(float);
}

// ---------------------------------------------------------------------
// forward: grid (row tiles, vocab chunks); part [chunks, M, 3] = (m, s, ll)
// ---------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const float* __restrict__ b, const int* __restrict__ labels,
              float* __restrict__ part, int M, int V, int chunk_tiles) {
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
      x[j] = col < V ? S[r * R_S_LD + q + j] + b[col] : -INFINITY;
      tmax = fmaxf(tmax, x[j]);
      if (col == label) ll += x[j];
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

// ---------------------------------------------------------------------
// dh: grid (row tiles); dh [ceil(M / 32) * 32, H] f32
// ---------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
ce_dh_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
             const float* __restrict__ b, const int* __restrict__ labels,
             const float* __restrict__ lse, const float* __restrict__ gw,
             float* __restrict__ dh, int M, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = H + PAD;
  constexpr int NF = H / 64;      // dh fragments per warp: [32, H] / 8 warps
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* ws = hs + RM * LD;
  float* S = reinterpret_cast<float*>(ws + RV * LD);
  bf16* dl = reinterpret_cast<bf16*>(S + RM * R_S_LD);
  float* row_lse = reinterpret_cast<float*>(dl + RM * R_DL_LD);
  float* row_gw = row_lse + RM;
  int* row_lab = reinterpret_cast<int*>(row_gw + RM);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * RM;
  load_rows<H, RM>(h, m0, M, hs);
  load_row_args<RM>(lse, gw, labels, m0, M, row_lse, row_gw, row_lab);
  AccFrag acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  const int tiles = (V + RV - 1) / RV;
  for (int t = 0; t < tiles; ++t) {
    const int v0 = t * RV;
    load_rows<H, RV>(w, v0, V, ws);
    __syncthreads();
    logits_tile<H, RM, RV>(hs, ws, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RM * RV / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / RV;
      const int c = e % RV;
      const int col = v0 + c;
      float d = 0.0f;
      if (col < V)
        d = dlogit(S[r * R_S_LD + c], b[col], row_lse[r], col, row_lab[r], row_gw[r]);
      dl[r * R_DL_LD + c] = __float2bfloat16(d);
    }
    __syncthreads();
    // dh[32, H] += dl16[32, 64] @ W_tile[64, H]
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + WARPS * i;
      const int rf = f / (H / 16);
      const int cf = f % (H / 16);
#pragma unroll
      for (int k = 0; k < RV; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, &dl[rf * 16 * R_DL_LD + k], R_DL_LD);
        wmma::load_matrix_sync(bm, &ws[k * LD + cf * 16], LD);
        wmma::mma_sync(acc[i], a, bm, acc[i]);
      }
    }
    __syncthreads();              // the next tile rewrites ws and dl
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + WARPS * i;
    const int rf = f / (H / 16);
    const int cf = f % (H / 16);
    wmma::store_matrix_sync(&dh[static_cast<size_t>(m0 + rf * 16) * H + cf * 16],
                            acc[i], H, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------------
// dW/db: grid (vocab tiles of 32, row splits); dw_part [splits, Vp, H],
// db_part [splits, Vp] f32 (Vp = ceil(V / 32) * 32)
// ---------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
ce_dwdb_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
               const float* __restrict__ b, const int* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ gw,
               float* __restrict__ dw_part, float* __restrict__ db_part,
               int M, int V, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = H + PAD;
  constexpr int NF = H / 64;      // dW fragments per warp: [32, H] / 8 warps
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + WV * LD;
  float* S = reinterpret_cast<float*>(hs + WM * LD);
  bf16* dl = reinterpret_cast<bf16*>(S + WM * W_S_LD);
  float* row_lse = reinterpret_cast<float*>(dl + WM * W_DL_LD);
  float* row_gw = row_lse + WM;
  int* row_lab = reinterpret_cast<int*>(row_gw + WM);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int v0 = blockIdx.x * WV;
  const int Vp = gridDim.x * WV;
  const int row_tiles = (M + WM - 1) / WM;
  const int rt0 = blockIdx.y * tiles_per_split;
  const int rt1 = min(row_tiles, rt0 + tiles_per_split);
  load_rows<H, WV>(w, v0, V, ws);
  AccFrag acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  float db_run = 0.0f;            // threads tid < 32: column v0 + tid
  for (int rt = rt0; rt < rt1; ++rt) {
    const int m0 = rt * WM;
    load_rows<H, WM>(h, m0, M, hs);
    load_row_args<WM>(lse, gw, labels, m0, M, row_lse, row_gw, row_lab);
    __syncthreads();
    logits_tile<H, WM, WV>(hs, ws, S);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WM * WV / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / WV;
      const int c = e % WV;
      const int col = v0 + c;
      float d = 0.0f;
      if (col < V)
        d = dlogit(S[r * W_S_LD + c], b[col], row_lse[r], col, row_lab[r], row_gw[r]);
      S[r * W_S_LD + c] = d;      // each thread rewrites its own elements
      dl[r * W_DL_LD + c] = __float2bfloat16(d);
    }
    __syncthreads();
    if (tid < WV)
      for (int r = 0; r < WM; ++r) db_run += S[r * W_S_LD + tid];
    // dW[32, H] += dl16^T[32, 64] @ h_tile[64, H]
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + WARPS * i;
      const int rf = f / (H / 16);
      const int cf = f % (H / 16);
#pragma unroll
      for (int k = 0; k < WM; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, &dl[k * W_DL_LD + rf * 16], W_DL_LD);
        wmma::load_matrix_sync(bm, &hs[k * LD + cf * 16], LD);
        wmma::mma_sync(acc[i], a, bm, acc[i]);
      }
    }
    __syncthreads();              // the next tile rewrites hs, S and dl
  }
  float* out = dw_part + static_cast<size_t>(blockIdx.y) * Vp * H;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + WARPS * i;
    const int rf = f / (H / 16);
    const int cf = f % (H / 16);
    wmma::store_matrix_sync(&out[static_cast<size_t>(v0 + rf * 16) * H + cf * 16],
                            acc[i], H, wmma::mem_row_major);
  }
  if (tid < WV) db_part[static_cast<size_t>(blockIdx.y) * Vp + v0 + tid] = db_run;
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

template <int H>
int launch_fwd(const bf16* h, const bf16* w, const float* b, const int* labels,
               float* part, float* lse, float* ll, int M, int V,
               int chunk_tiles, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<H>();
  int err = allow_smem(ce_fwd_kernel<H>, smem);
  if (err) return err;
  const int tiles = (V + RV - 1) / RV;
  const int chunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid((M + RM - 1) / RM, chunks);
  ce_fwd_kernel<H><<<grid, THREADS, smem, st>>>(h, w, b, labels, part, M, V,
                                                 chunk_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ce_merge_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, chunks,
                                                                  M, lse, ll);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_dh(const bf16* h, const bf16* w, const float* b, const int* labels,
              const float* lse, const float* gw, float* dh, int M, int V,
              cudaStream_t st) {
  constexpr size_t smem = dh_smem<H>();
  int err = allow_smem(ce_dh_kernel<H>, smem);
  if (err) return err;
  ce_dh_kernel<H><<<(M + RM - 1) / RM, THREADS, smem, st>>>(h, w, b, labels, lse,
                                                           gw, dh, M, V);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_dwdb(const bf16* h, const bf16* w, const float* b, const int* labels,
                const float* lse, const float* gw, float* dw_part,
                float* db_part, float* dw, float* db, int M, int V, int splits,
                cudaStream_t st) {
  constexpr size_t smem = dwdb_smem<H>();
  int err = allow_smem(ce_dwdb_kernel<H>, smem);
  if (err) return err;
  const int vtiles = (V + WV - 1) / WV;
  const int Vp = vtiles * WV;
  const int row_tiles = (M + WM - 1) / WM;
  const int per_split = (row_tiles + splits - 1) / splits;
  ce_dwdb_kernel<H><<<dim3(vtiles, splits), THREADS, smem, st>>>(
      h, w, b, labels, lse, gw, dw_part, db_part, M, V, per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = sum_splits(dw_part, splits, static_cast<size_t>(Vp) * H,
                   static_cast<size_t>(V) * H, dw, st);
  if (err) return err;
  return sum_splits(db_part, splits, Vp, V, db, st);
}

bool bad_shape(int M, int H, int V) {
  return M <= 0 || V <= 0 || (H != 64 && H != 128 && H != 256 && H != 512);
}

}  // namespace

// Shape rule: H is 64, 128, 256 or 512; M and V anything positive.  Each
// returns a cudaError_t as int.
#define VCT_CE_ARGS                                                      \
  static_cast<const bf16*>(h), static_cast<const bf16*>(w),               \
      static_cast<const float*>(b), static_cast<const int*>(labels)

// h16 [M, H], w16 [V, H] bf16; b [V] f32; labels [M] int32 -> lse, ll [M]
// f32.  part: [chunks, M, 3] f32 workspace, chunks = ceil(ceil(V / 64) /
// chunk_tiles).
extern "C" int vct_fused_ce_fwd(const void* h, const void* w, const void* b,
                                const void* labels, void* part, void* lse,
                                void* ll, int M, int H, int V, int chunk_tiles,
                                void* stream) {
  if (bad_shape(M, H, V) || chunk_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_fwd<HH>(VCT_CE_ARGS, static_cast<float*>(part),                      \
                 static_cast<float*>(lse), static_cast<float*>(ll), M, V,     \
                 chunk_tiles, st)
  switch (H) {
    case 64: return CALL(64);
    case 128: return CALL(128);
    case 256: return CALL(256);
    default: return CALL(512);
  }
#undef CALL
}

// + lse, gw [M] f32 -> dh [ceil(M / 32) * 32, H] f32 (the rows past M come
// out zero)
extern "C" int vct_fused_ce_dh(const void* h, const void* w, const void* b,
                               const void* labels, const void* lse,
                               const void* gw, void* dh, int M, int H, int V,
                               void* stream) {
  if (bad_shape(M, H, V)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_dh<HH>(VCT_CE_ARGS, static_cast<const float*>(lse),                  \
                static_cast<const float*>(gw), static_cast<float*>(dh), M, V, \
                st)
  switch (H) {
    case 64: return CALL(64);
    case 128: return CALL(128);
    case 256: return CALL(256);
    default: return CALL(512);
  }
#undef CALL
}

// + lse, gw [M] f32 -> dw [V, H], db [V] f32.  Workspaces: dw_part [splits,
// Vp, H], db_part [splits, Vp] f32, Vp = ceil(V / 32) * 32.
extern "C" int vct_fused_ce_dwdb(const void* h, const void* w, const void* b,
                                 const void* labels, const void* lse,
                                 const void* gw, void* dw_part, void* db_part,
                                 void* dw, void* db, int M, int H, int V,
                                 int splits, void* stream) {
  if (bad_shape(M, H, V) || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_dwdb<HH>(VCT_CE_ARGS, static_cast<const float*>(lse),                \
                  static_cast<const float*>(gw), static_cast<float*>(dw_part),\
                  static_cast<float*>(db_part), static_cast<float*>(dw),      \
                  static_cast<float*>(db), M, V, splits, st)
  switch (H) {
    case 64: return CALL(64);
    case 128: return CALL(128);
    case 256: return CALL(256);
    default: return CALL(512);
  }
#undef CALL
}
