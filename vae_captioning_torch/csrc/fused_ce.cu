// Flash linear cross-entropy for Hopper (sm_90a): the forward (logsumexp and
// label logit), dh and dW/db, exported with a plain C interface and loaded
// through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ce.py:
// _fwd_kernel (:59), _dh_kernel (:134) and _dwdb_kernel (:159), called
// through fused_linear_ce.  The forward kernel, its merge launch and the
// tile helpers live in fused_ce.cuh, which the written-logits schedule
// (fused_ce_mat.cu) shares.
//
//   S   = h @ W^T + b                      [M, V]  (never written)
//   lse = logsumexp_v S,    ll = S[label]
//   dl  = (exp(S - lse) - onehot(label)) * gw              f32
//   dh  = bf16(dl) @ W,     dW = bf16(dl)^T @ h,     db = sum over rows of dl
//
// h [M, H] and W [V, H] (the rnn_logits nn.Linear weight, read in that
// layout) in bf16, the products accumulated in f32 by WMMA; b f32.  Padded
// vocab columns count as -1e30 in the forward and give dl = 0; rows past M
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

#include "fused_ce.cuh"

namespace {

// the logit's gradient, as the TPU kernels form it: (p - onehot) * gw
__device__ __forceinline__ float dlogit(float s, float bias, float lse, int col,
                                        int label, float gw) {
  const float p = expf(s + bias - lse);
  return (p - (col == label ? 1.0f : 0.0f)) * gw;
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
  launch_fwd<HH, false>(VCT_CE_ARGS, static_cast<float*>(part), nullptr,       \
                        static_cast<float*>(lse), static_cast<float*>(ll), M, \
                        V, chunk_tiles, st)
  VCT_CE_SWITCH_H(CALL)
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
  VCT_CE_SWITCH_H(CALL)
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
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}
