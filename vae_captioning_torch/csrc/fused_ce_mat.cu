// Linear cross-entropy over written logits for Hopper (sm_90a): the forward
// that writes the bf16 logits beside lse and the label logit, and the dh and
// dW/db kernels that read them back, exported with a plain C interface and
// loaded through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ce.py:
// _fwd_mat_kernel (:304), _dh_mat_kernel (:377) and _dwdb_mat_kernel (:346),
// called through fused_linear_ce_hybrid (the forward and both backward
// kernels) and fused_linear_ce_xla_bwd (the backward kernels after a plain
// forward that writes the same layout).
//
//   S   = h @ W^T + b             f32; lg = bf16(S) [M, Vp], Vp = 64 ceil(V / 64)
//   lse = logsumexp_v S,          ll = S[label]       (from S, not from lg)
//   dl  = (exp(f32(lg) - lse) - onehot(label)) * gw   f32
//   dh  = bf16(dl) @ W,     dW = bf16(dl)^T @ h,     db = sum over rows of dl
//
// lg's pad columns V..Vp-1 hold -1e30, so exp gives p = 0 there and no label
// picks them: dl is 0 on them and nothing is masked.  The row pitch Vp keeps
// every 8-column run of lg on a 16-byte boundary.
//
// What bounds it on this card: tensor-core operations, 2 M H V for each of
// the three (362 GFLOP at M = 30720, H = 512, V = 11500: 0.366 ms at the
// dense bf16 rate); the bytes, about 0.75 GB each with the 708 MB of lg,
// take 0.22 ms.  Unlike the flash schedule, nothing recomputes the logits
// product: the backward reads lg instead.  The design:
//
// * Forward: the flash forward (fused_ce.cuh) with WRITE_LG: each thread
//   stores its 8 columns of the f32 tile as one 16-byte bf16 run, rounded to
//   nearest even, after folding them into (max, sum-exp) and the label pick.
// * dh: a block owns 32 rows and loops over the vocab in 64-column tiles:
//   W's 64 rows to shared memory, the [32, 64] lg tile read as one 16-byte
//   run per thread, dl formed in f32 and rounded to bf16 in shared memory,
//   then dh += dl16 @ W_tile by WMMA, the [32, H] accumulator in registers.
//   Each element of dh is written once.
// * dW/db: a block owns 32 vocab rows of dW and a range of 64-row tiles:
//   per tile h's rows to shared memory, the [64, 32] lg tile, dl in f32
//   and in bf16, then dW += dl16^T @ h_tile.  Each thread adds its 8 f32 dl
//   to db partials in registers; the block sums its 64 partials per column
//   once, at the end (a column sum per tile would run on one warp while the
//   other seven wait at the next barrier).  The row ranges' [V, H] partials
//   are summed in range order by a last launch (db alike).
// * Determinism: no float atomics.  Every cross-block sum runs in a fixed
//   order, so the gradients repeat bit for bit.
// * No cp.async, TMA or wgmma yet, as in fused_ce.cu.

#include "fused_ce.cuh"

namespace {

// dl of 8 consecutive columns col0.. of one row from their bf16 logits
__device__ __forceinline__ void dl_run(uint4 raw, int col0, int V, float lse,
                                       int label, float gw, float* d) {
  const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + j;
    const float p = expf(__bfloat162float(x[j]) - lse);
    d[j] = (p - (col == label && col < V ? 1.0f : 0.0f)) * gw;
  }
}

// 8 f32 values as one 16-byte run of bf16, rounded to nearest even
__device__ __forceinline__ uint4 to_bf16_run(const float* d) {
  uint4 packed;
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j) p2[j] = __floats2bfloat162_rn(d[2 * j], d[2 * j + 1]);
  return packed;
}

template <int H>
constexpr size_t mat_dh_smem() {
  return static_cast<size_t>(RV) * (H + PAD) * sizeof(bf16) +
         static_cast<size_t>(RM) * R_DL_LD * sizeof(bf16) +
         static_cast<size_t>(RM) * 3 * sizeof(float);
}

template <int H>
constexpr size_t mat_dwdb_smem() {
  return static_cast<size_t>(WM) * (H + PAD) * sizeof(bf16) +
         static_cast<size_t>(WM) * W_S_LD * sizeof(float) +
         static_cast<size_t>(WM) * W_DL_LD * sizeof(bf16) +
         static_cast<size_t>(WM) * 3 * sizeof(float);
}

// ---------------------------------------------------------------------
// dh: grid (row tiles of 32); dh [ceil(M / 32) * 32, H] f32
// ---------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
ce_mat_dh_kernel(const bf16* __restrict__ lg, const bf16* __restrict__ w,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ gw, float* __restrict__ dh, int M,
                 int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = H + PAD;
  constexpr int NF = H / 64;      // dh fragments per warp: [32, H] / 8 warps
  static_assert(RM * RV == THREADS * 8, "one 8-column run per thread");
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* dl = ws + RV * LD;
  float* row_lse = reinterpret_cast<float*>(dl + RM * R_DL_LD);
  float* row_gw = row_lse + RM;
  int* row_lab = reinterpret_cast<int*>(row_gw + RM);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * RM;
  const int ld = logits_pitch(V);
  const int r = tid / 8;          // this thread's row of the lg tile
  const int q = (tid % 8) * 8;    // and its 8 columns
  const int n = m0 + r;
  load_row_args<RM>(lse, gw, labels, m0, M, row_lse, row_gw, row_lab);
  AccFrag acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  __syncthreads();                // the row arguments
  const float lse_r = row_lse[r], gw_r = row_gw[r];
  const int lab_r = row_lab[r];
  const int tiles = ld / RV;
  for (int t = 0; t < tiles; ++t) {
    const int v0 = t * RV;
    load_rows<H, RV>(w, v0, V, ws);
    // rows past M read zeros and carry gw = 0, so their dl is 0
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (n < M) raw = *reinterpret_cast<const uint4*>(&lg[static_cast<size_t>(n) * ld + v0 + q]);
    float d[8];
    dl_run(raw, v0 + q, V, lse_r, lab_r, gw_r, d);
    *reinterpret_cast<uint4*>(&dl[r * R_DL_LD + q]) = to_bf16_run(d);
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
// dW/db: grid (vocab tiles of 32, row splits); dw_part [splits, Vw, H],
// db_part [splits, Vw] f32 (Vw = ceil(V / 32) * 32)
// ---------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
ce_mat_dwdb_kernel(const bf16* __restrict__ h, const bf16* __restrict__ lg,
                   const int* __restrict__ labels, const float* __restrict__ lse,
                   const float* __restrict__ gw, float* __restrict__ dw_part,
                   float* __restrict__ db_part, int M, int V,
                   int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = H + PAD;
  constexpr int NF = H / 64;      // dW fragments per warp: [32, H] / 8 warps
  static_assert(WM * WV == THREADS * 8, "one 8-column run per thread");
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* db_rows = reinterpret_cast<float*>(hs + WM * LD);   // [WM][W_S_LD]
  bf16* dl = reinterpret_cast<bf16*>(db_rows + WM * W_S_LD);
  float* row_lse = reinterpret_cast<float*>(dl + WM * W_DL_LD);
  float* row_gw = row_lse + WM;
  int* row_lab = reinterpret_cast<int*>(row_gw + WM);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int v0 = blockIdx.x * WV;
  const int Vw = gridDim.x * WV;
  const int ld = logits_pitch(V);   // >= Vw: every tile lies inside lg's rows
  const int r = tid / 4;          // this thread's row of the lg tile
  const int q = (tid % 4) * 8;    // and its 8 columns
  const int row_tiles = (M + WM - 1) / WM;
  const int rt0 = blockIdx.y * tiles_per_split;
  const int rt1 = min(row_tiles, rt0 + tiles_per_split);
  AccFrag acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wmma::fill_fragment(acc[i], 0.0f);
  // db of this thread's 8 columns over its row r of every tile, in tile
  // order; the block's 64 partials per column are summed once, at the end
  float db_acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int rt = rt0; rt < rt1; ++rt) {
    const int m0 = rt * WM;
    const int n = m0 + r;
    load_rows<H, WM>(h, m0, M, hs);
    load_row_args<WM>(lse, gw, labels, m0, M, row_lse, row_gw, row_lab);
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (n < M) raw = *reinterpret_cast<const uint4*>(&lg[static_cast<size_t>(n) * ld + v0 + q]);
    __syncthreads();
    float d[8];
    dl_run(raw, v0 + q, V, row_lse[r], row_lab[r], row_gw[r], d);
#pragma unroll
    for (int j = 0; j < 8; ++j) db_acc[j] += d[j];
    *reinterpret_cast<uint4*>(&dl[r * W_DL_LD + q]) = to_bf16_run(d);
    __syncthreads();
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
    __syncthreads();              // the next tile rewrites hs and dl
  }
  float* out = dw_part + static_cast<size_t>(blockIdx.y) * Vw * H;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + WARPS * i;
    const int rf = f / (H / 16);
    const int cf = f % (H / 16);
    wmma::store_matrix_sync(&out[static_cast<size_t>(v0 + rf * 16) * H + cf * 16],
                            acc[i], H, wmma::mem_row_major);
  }
  // db: the 64 partials of each column, summed in row order
#pragma unroll
  for (int j = 0; j < 8; ++j) db_rows[r * W_S_LD + q + j] = db_acc[j];
  __syncthreads();
  if (tid < WV) {
    float db_sum = 0.0f;
    for (int rr = 0; rr < WM; ++rr) db_sum += db_rows[rr * W_S_LD + tid];
    db_part[static_cast<size_t>(blockIdx.y) * Vw + v0 + tid] = db_sum;
  }
}

template <int H>
int launch_mat_dh(const bf16* lg, const bf16* w, const int* labels,
                  const float* lse, const float* gw, float* dh, int M, int V,
                  cudaStream_t st) {
  constexpr size_t smem = mat_dh_smem<H>();
  int err = allow_smem(ce_mat_dh_kernel<H>, smem);
  if (err) return err;
  ce_mat_dh_kernel<H><<<(M + RM - 1) / RM, THREADS, smem, st>>>(lg, w, labels, lse,
                                                               gw, dh, M, V);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_mat_dwdb(const bf16* h, const bf16* lg, const int* labels,
                    const float* lse, const float* gw, float* dw_part,
                    float* db_part, float* dw, float* db, int M, int V,
                    int splits, cudaStream_t st) {
  constexpr size_t smem = mat_dwdb_smem<H>();
  int err = allow_smem(ce_mat_dwdb_kernel<H>, smem);
  if (err) return err;
  const int vtiles = (V + WV - 1) / WV;
  const int Vw = vtiles * WV;
  const int row_tiles = (M + WM - 1) / WM;
  const int per_split = (row_tiles + splits - 1) / splits;
  ce_mat_dwdb_kernel<H><<<dim3(vtiles, splits), THREADS, smem, st>>>(
      h, lg, labels, lse, gw, dw_part, db_part, M, V, per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = sum_splits(dw_part, splits, static_cast<size_t>(Vw) * H,
                   static_cast<size_t>(V) * H, dw, st);
  if (err) return err;
  return sum_splits(db_part, splits, Vw, V, db, st);
}

}  // namespace

// Shape rule: H is 64, 128, 256 or 512; M and V anything positive; lg is [M,
// 64 ceil(V / 64)] bf16.  Each returns a cudaError_t as int.

// h16 [M, H], w16 [V, H] bf16; b [V] f32; labels [M] int32 -> lg [M, Vp]
// bf16, lse, ll [M] f32.  part: [chunks, M, 3] f32 workspace, chunks =
// ceil(ceil(V / 64) / chunk_tiles).
extern "C" int vct_fused_ce_mat_fwd(const void* h, const void* w, const void* b,
                                    const void* labels, void* part, void* lg,
                                    void* lse, void* ll, int M, int H, int V,
                                    int chunk_tiles, void* stream) {
  if (bad_shape(M, H, V) || chunk_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_fwd<HH, true>(static_cast<const bf16*>(h), static_cast<const bf16*>(w), \
                       static_cast<const float*>(b),                          \
                       static_cast<const int*>(labels),                       \
                       static_cast<float*>(part), static_cast<bf16*>(lg),      \
                       static_cast<float*>(lse), static_cast<float*>(ll), M,  \
                       V, chunk_tiles, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// lg [M, Vp] bf16, w16 [V, H] bf16, labels [M] int32, lse, gw [M] f32 -> dh
// [ceil(M / 32) * 32, H] f32 (the rows past M come out zero)
extern "C" int vct_fused_ce_mat_dh(const void* lg, const void* w,
                                   const void* labels, const void* lse,
                                   const void* gw, void* dh, int M, int H,
                                   int V, void* stream) {
  if (bad_shape(M, H, V)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_mat_dh<HH>(static_cast<const bf16*>(lg), static_cast<const bf16*>(w), \
                    static_cast<const int*>(labels),                          \
                    static_cast<const float*>(lse),                           \
                    static_cast<const float*>(gw), static_cast<float*>(dh), M, \
                    V, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// h16 [M, H] bf16, lg [M, Vp] bf16, labels [M] int32, lse, gw [M] f32 -> dw
// [V, H], db [V] f32.  Workspaces: dw_part [splits, Vw, H], db_part [splits,
// Vw] f32, Vw = ceil(V / 32) * 32.
extern "C" int vct_fused_ce_mat_dwdb(const void* h, const void* lg,
                                     const void* labels, const void* lse,
                                     const void* gw, void* dw_part,
                                     void* db_part, void* dw, void* db, int M,
                                     int H, int V, int splits, void* stream) {
  if (bad_shape(M, H, V) || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_mat_dwdb<HH>(static_cast<const bf16*>(h), static_cast<const bf16*>(lg), \
                      static_cast<const int*>(labels),                        \
                      static_cast<const float*>(lse),                         \
                      static_cast<const float*>(gw),                          \
                      static_cast<float*>(dw_part),                           \
                      static_cast<float*>(db_part), static_cast<float*>(dw),  \
                      static_cast<float*>(db), M, V, splits, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}
