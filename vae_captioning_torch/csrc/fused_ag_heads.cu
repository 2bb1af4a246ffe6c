// AG-prior recognition heads + cluster-vector combine for Hopper (sm_90a):
// forward and backward, exported with a plain C interface and loaded
// through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ag_heads.py:
// _fwd_kernel (:80) and _bwd_kernel (:116), called through fused_ag_heads.
//
//   q      = h @ W^T + b                         [N, 2*K*L]  (mu || log sigma)
//   mu_k   = q[:, k*L + l],   sigma_k = exp(q[:, K*L + k*L + l])
//   q_mean = sum_k cv[:, k] * mu_k,   q_std = sum_k cv[:, k] * sigma_k
//
// h [N, H] and W [2*K*L, H] (the nn.Linear weight of q_heads, read in that
// layout) in bf16, the products accumulated in f32; b f32; cv [N, K] f32,
// rounded through bf16 as the plain version rounds it; exp and the combine
// in f32.  The backward:
//
//   dq_m = g_mean[n, l] * cv[n, k],   dq_s = g_std[n, l] * cv[n, k] * sigma
//   dW = dq^T @ h,   db = sum_n dq,   dh = dq @ W,
//   dcv[n, k] = sum_l (mu * g_mean + sigma * g_std)
//
// What bounds it on this card: tensor-core operations.  At the train shapes
// (N = 1280, H = 512, K = 90, L = 150) the heads are one [1280, 512] x
// [512, 27000] product, 35.4 GFLOP forward and three of them (recompute,
// dW, dh) backward, against 28 MB of bf16 weights: about 0.036 ms and
// 0.107 ms at the dense bf16 rate.  The design:
//
// * Forward: q never reaches memory.  A block takes 64 rows x 32 latent
//   columns of one group of clusters (about 1280 columns of q per group,
//   as the TPU kernel's _group_geometry picks), runs the mu and the
//   log-sigma tiles of each cluster through WMMA bf16 (f32 accumulation),
//   and folds c_v-weighted mu and sigma into registers.  Each group writes
//   a [2, N, L] partial; a second launch sums the groups in a fixed order.
// * Backward: a first kernel recomputes the q tiles the same way and forms
//   dq, db partials (per row tile) and dcv partials (per latent tile); dq
//   is written once in bf16 ([N, 2*K*L], 69 MB at the train shapes) for
//   the two products that follow, dW = dq^T @ h (each element written
//   once) and dh = dq @ W (split over q's columns, partials summed in a
//   fixed order).  Writing dq instead of recomputing it a second and third
//   time is the first version's choice; removing it is later work.
// * Determinism: no float atomics.  Every cross-block sum is a partial
//   buffer reduced by one thread per element, in index order.
// * No cp.async, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

// ---------------------------------------------------------------------
// the q tiles of one cluster: 64 rows x 32 latent columns, mu and log sigma
// ---------------------------------------------------------------------
constexpr int BM = 64;           // rows
constexpr int BL = 32;           // latent columns
constexpr int BH = 64;           // H per stage
constexpr int A_LD = BH + 8;
constexpr int B_LD = BH + 8;     // B^T kept as [BL][BH]: column-major
constexpr int C_LD = BL + 4;
constexpr int PER_THREAD = BM * BL / THREADS;   // 8 elements of the tile

struct QTiles {
  bf16 a[BM * A_LD];
  bf16 bm[BL * B_LD];
  bf16 bs[BL * B_LD];
  float cm[BM * C_LD];
  float cs[BM * C_LD];
  float ct[BM * C_LD];          // backward: the dcv contributions
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// t.cm / t.cs <- h16[m0:m0+64] @ W16[k*L + l0 + j]^T and W16[KL + k*L + l0 + j]^T
// (j < 32; latent columns l >= L and rows n >= N read zeros)
__device__ void q_tiles(const bf16* __restrict__ h, const bf16* __restrict__ w,
                        int N, int H, int K, int L, int m0, int l0, int k,
                        QTiles& t) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;       // rows wm*16
  const int wn = warp % 2;       // latent columns wn*16
  const size_t KL = static_cast<size_t>(K) * L;
  AccFrag acc_m, acc_s;
  wmma::fill_fragment(acc_m, 0.0f);
  wmma::fill_fragment(acc_s, 0.0f);
  for (int h0 = 0; h0 < H; h0 += BH) {
#pragma unroll
    for (int i = 0; i < (BM * BH / 8) / THREADS; ++i) {   // A: h rows
      const int v = tid + i * THREADS;
      const int r = v / (BH / 8);
      const int cv = (v % (BH / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (m0 + r < N)
        x = *reinterpret_cast<const uint4*>(&h[static_cast<size_t>(m0 + r) * H + h0 + cv]);
      *reinterpret_cast<uint4*>(&t.a[r * A_LD + cv]) = x;
    }
    {   // B^T: W rows of the latent columns, mu half and log-sigma half
      const int r = tid / (BH / 8);
      const int cv = (tid % (BH / 8)) * 8;
      const int l = l0 + r;
      uint4 xm = make_uint4(0, 0, 0, 0), xs = make_uint4(0, 0, 0, 0);
      if (l < L) {
        const size_t row = static_cast<size_t>(k) * L + l;
        xm = *reinterpret_cast<const uint4*>(&w[row * H + h0 + cv]);
        xs = *reinterpret_cast<const uint4*>(&w[(KL + row) * H + h0 + cv]);
      }
      *reinterpret_cast<uint4*>(&t.bm[r * B_LD + cv]) = xm;
      *reinterpret_cast<uint4*>(&t.bs[r * B_LD + cv]) = xs;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfm, bfs;
      wmma::load_matrix_sync(af, &t.a[(wm * 16) * A_LD + kk], A_LD);
      wmma::load_matrix_sync(bfm, &t.bm[(wn * 16) * B_LD + kk], B_LD);
      wmma::load_matrix_sync(bfs, &t.bs[(wn * 16) * B_LD + kk], B_LD);
      wmma::mma_sync(acc_m, af, bfm, acc_m);
      wmma::mma_sync(acc_s, af, bfs, acc_s);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&t.cm[(wm * 16) * C_LD + wn * 16], acc_m, C_LD,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(&t.cs[(wm * 16) * C_LD + wn * 16], acc_s, C_LD,
                          wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// grid (row tiles, latent tiles, cluster groups); part [G, 2, N, L]
__global__ void __launch_bounds__(THREADS)
ag_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ cv,
              float* __restrict__ part, int N, int H, int K, int L, int kb) {
  __shared__ __align__(128) QTiles t;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int l0 = blockIdx.y * BL;
  const int g = blockIdx.z;
  const int KL = K * L;
  float om[PER_THREAD] = {};
  float os[PER_THREAD] = {};
  const int k_end = min(K, (g + 1) * kb);
  for (int k = g * kb; k < k_end; ++k) {
    q_tiles(h, w, N, H, K, L, m0, l0, k, t);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BL;
      const int c = e % BL;
      const int n = m0 + r;
      const int l = l0 + c;
      if (n < N && l < L) {
        const float wgt = bf16_round(cv[static_cast<size_t>(n) * K + k]);
        const int col = k * L + l;
        om[i] += wgt * (t.cm[r * C_LD + c] + b[col]);
        os[i] += wgt * expf(t.cs[r * C_LD + c] + b[KL + col]);
      }
    }
  }
  const size_t NL = static_cast<size_t>(N) * L;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = tid + i * THREADS;
    const int n = m0 + e / BL;
    const int l = l0 + e % BL;
    if (n < N && l < L) {
      const size_t o = static_cast<size_t>(n) * L + l;
      part[(2 * static_cast<size_t>(g)) * NL + o] = om[i];
      part[(2 * static_cast<size_t>(g) + 1) * NL + o] = os[i];
    }
  }
}

// out[i] = sum over s of part[s * len + i], s in order
__global__ void sum_partials_kernel(const float* __restrict__ part, int S,
                                    size_t len, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[static_cast<size_t>(s) * len + i];
  out[i] = acc;
}

// ---------------------------------------------------------------------
// backward 1: q recomputed, dq (bf16, [N, ldq]), db partials [row tiles,
// 2KL], dcv partials [latent tiles, N, K]
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ag_dq_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ cv,
             const float* __restrict__ gm, const float* __restrict__ gs,
             bf16* __restrict__ dq, int ldq, float* __restrict__ db_part,
             float* __restrict__ dcv_part, int N, int H, int K, int L, int kb) {
  __shared__ __align__(128) QTiles t;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int l0 = blockIdx.y * BL;
  const int g = blockIdx.z;
  const int KL = K * L;
  const int k_end = min(K, (g + 1) * kb);
  for (int k = g * kb; k < k_end; ++k) {
    q_tiles(h, w, N, H, K, L, m0, l0, k, t);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BL;
      const int c = e % BL;
      const int n = m0 + r;
      const int l = l0 + c;
      float dqm = 0.0f, dqs = 0.0f, contrib = 0.0f;
      if (n < N && l < L) {
        const float wgt = bf16_round(cv[static_cast<size_t>(n) * K + k]);
        const int col = k * L + l;
        const float mu = t.cm[r * C_LD + c] + b[col];
        const float sg = expf(t.cs[r * C_LD + c] + b[KL + col]);
        const float g_m = gm[static_cast<size_t>(n) * L + l];
        const float g_s = gs[static_cast<size_t>(n) * L + l];
        dqm = g_m * wgt;
        dqs = g_s * wgt * sg;
        contrib = mu * g_m + sg * g_s;
        dq[static_cast<size_t>(n) * ldq + col] = __float2bfloat16(dqm);
        dq[static_cast<size_t>(n) * ldq + KL + col] = __float2bfloat16(dqs);
      }
      t.cm[r * C_LD + c] = dqm;       // each thread rewrites its own elements
      t.cs[r * C_LD + c] = dqs;
      t.ct[r * C_LD + c] = contrib;
    }
    __syncthreads();
    if (tid < 2 * BL) {               // db: column sums over the 64 rows
      const int c = tid % BL;
      const int l = l0 + c;
      const float* src = tid < BL ? t.cm : t.cs;
      if (l < L) {
        float s = 0.0f;
        for (int r = 0; r < BM; ++r) s += src[r * C_LD + c];
        const size_t col = static_cast<size_t>(tid < BL ? 0 : KL) + k * L + l;
        db_part[static_cast<size_t>(blockIdx.x) * 2 * KL + col] = s;
      }
    } else if (tid < 2 * BL + BM) {   // dcv: row sums over the 32 columns
      const int r = tid - 2 * BL;
      const int n = m0 + r;
      if (n < N) {
        float s = 0.0f;
        for (int c = 0; c < BL; ++c) s += t.ct[r * C_LD + c];
        dcv_part[(static_cast<size_t>(blockIdx.y) * N + n) * K + k] = s;
      }
    }
    __syncthreads();
  }
}

// 8 bf16 of row `row` from column c of a [rows, ld] matrix, zeros at and
// past column c_end
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ m, size_t row,
                                       int ld, int c, int c_end) {
  if (c + 8 <= c_end)
    return *reinterpret_cast<const uint4*>(&m[row * ld + c]);
  uint4 x = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&x);
  for (int j = 0; j < 8; ++j)
    if (c + j < c_end) e[j] = m[row * ld + c + j];
  return x;
}

// ---------------------------------------------------------------------
// backward 2: dW[c, e] = sum_n dq[n, c] * h[n, e], a 64 (c) x 64 (e) tile
// per block, over n in stages of 32; each element written once
// ---------------------------------------------------------------------
constexpr int WC = 64;
constexpr int WE = 64;
constexpr int WR = 32;
constexpr int WA_LD = WC + 8;    // A^T kept as [WR][WC]: column-major
constexpr int WB_LD = WE + 8;
constexpr int WC_LD = WE + 4;

__global__ void __launch_bounds__(THREADS)
ag_dw_kernel(const bf16* __restrict__ dq, int ldq, const bf16* __restrict__ h,
             float* __restrict__ dw, int N, int H, int C2) {
  __shared__ __align__(128) bf16 As[WR * WA_LD];
  __shared__ __align__(128) bf16 Bs[WR * WB_LD];
  __shared__ __align__(128) float Cs[WC * WC_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int e0 = blockIdx.x * WE;
  const int c0 = blockIdx.y * WC;
  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int n0 = 0; n0 < N; n0 += WR) {
    const int r = tid / (WC / 8);
    const int cv = (tid % (WC / 8)) * 8;
    const int n = n0 + r;
    uint4 xa = make_uint4(0, 0, 0, 0), xb = make_uint4(0, 0, 0, 0);
    if (n < N) {
      xa = load8(dq, n, ldq, c0 + cv, C2);
      xb = *reinterpret_cast<const uint4*>(&h[static_cast<size_t>(n) * H + e0 + cv]);
    }
    *reinterpret_cast<uint4*>(&As[r * WA_LD + cv]) = xa;
    *reinterpret_cast<uint4*>(&Bs[r * WB_LD + cv]) = xb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
      wmma::load_matrix_sync(af, &As[kk * WA_LD + wm * 16], WA_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * WB_LD + wn * 32 + f * 16], WB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * WC_LD + wn * 32 + f * 16], acc[f],
                            WC_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < WC * WE; e += THREADS) {
    const int r = e / WE;
    const int cc = e % WE;
    if (c0 + r < C2)
      dw[static_cast<size_t>(c0 + r) * H + e0 + cc] = Cs[r * WC_LD + cc];
  }
}

// ---------------------------------------------------------------------
// backward 3: dh_part[s][n, e] = sum over the split's columns c of
// dq[n, c] * W[c, e], a 64 (n) x 64 (e) tile per block, c in stages of 32
// ---------------------------------------------------------------------
constexpr int HM = 64;
constexpr int HN = 64;
constexpr int HK = 32;
constexpr int HA_LD = HK + 8;
constexpr int HB_LD = HN + 8;
constexpr int HC_LD = HN + 4;

__global__ void __launch_bounds__(THREADS)
ag_dh_kernel(const bf16* __restrict__ dq, int ldq, const bf16* __restrict__ w,
             float* __restrict__ dh_part, int N, int H, int C2, int chunk) {
  __shared__ __align__(128) bf16 As[HM * HA_LD];
  __shared__ __align__(128) bf16 Bs[HK * HB_LD];
  __shared__ __align__(128) float Cs[HM * HC_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int e0 = blockIdx.x * HN;
  const int m0 = blockIdx.y * HM;
  const int c_begin = blockIdx.z * chunk;
  const int c_end = min(C2, c_begin + chunk);
  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int c0 = c_begin; c0 < c_end; c0 += HK) {
    {   // A: dq rows [m0, m0+64), columns [c0, c0+32)
      const int r = tid / (HK / 8);
      const int cv = (tid % (HK / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (m0 + r < N) x = load8(dq, m0 + r, ldq, c0 + cv, c_end);
      *reinterpret_cast<uint4*>(&As[r * HA_LD + cv]) = x;
    }
    {   // B: W rows [c0, c0+32), columns [e0, e0+64)
      const int r = tid / (HN / 8);
      const int cv = (tid % (HN / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (c0 + r < c_end)
        x = *reinterpret_cast<const uint4*>(&w[static_cast<size_t>(c0 + r) * H + e0 + cv]);
      *reinterpret_cast<uint4*>(&Bs[r * HB_LD + cv]) = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wm * 16) * HA_LD + kk], HA_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * HB_LD + wn * 32 + f * 16], HB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * HC_LD + wn * 32 + f * 16], acc[f],
                            HC_LD, wmma::mem_row_major);
  __syncthreads();
  float* out = dh_part + static_cast<size_t>(blockIdx.z) * N * H;
  for (int e = tid; e < HM * HN; e += THREADS) {
    const int r = e / HN;
    const int cc = e % HN;
    if (m0 + r < N) out[static_cast<size_t>(m0 + r) * H + e0 + cc] = Cs[r * HC_LD + cc];
  }
}

int sum_partials(const float* part, int S, size_t len, float* out,
                 cudaStream_t st) {
  sum_partials_kernel<<<static_cast<int>((len + THREADS - 1) / THREADS), THREADS,
                        0, st>>>(part, S, len, out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int H, int K, int L, int kb) {
  return H <= 0 || H % 64 != 0 || K <= 0 || L <= 0 || kb <= 0 || kb > K;
}

}  // namespace

// Shape rule: H % 64 == 0.  Each returns a cudaError_t as int.

// h16 [N, H], w16 [2KL, H] bf16; b [2KL], cv [N, K] f32; part [G, 2, N, L]
// f32 workspace (G = ceil(K / kb)); out [2, N, L] f32 (q_mean, q_std)
extern "C" int vct_fused_ag_heads_fwd(const void* h, const void* w, const void* b,
                                      const void* cv, void* part, void* out,
                                      int N, int H, int K, int L, int kb,
                                      void* stream) {
  if (N <= 0) return 0;
  if (bad_shape(H, K, L, kb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = (K + kb - 1) / kb;
  const dim3 grid((N + BM - 1) / BM, (L + BL - 1) / BL, G);
  ag_fwd_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(cv),
      static_cast<float*>(part), N, H, K, L, kb);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(static_cast<const float*>(part), G,
                      2 * static_cast<size_t>(N) * L, static_cast<float*>(out), st);
}

// g_mean, g_std [N, L] f32 -> dw [2KL, H], db [2KL], dcv [N, K], dh [N, H]
// f32.  Workspaces: dq [N, ldq] bf16 (ldq >= 2KL, a multiple of 8);
// db_part [ceil(N/64), 2KL]; dcv_part [ceil(L/32), N, K]; dh_part
// [splits, N, H] f32.
extern "C" int vct_fused_ag_heads_bwd(const void* h, const void* w, const void* b,
                                      const void* cv, const void* g_mean,
                                      const void* g_std, void* dq, int ldq,
                                      void* db_part, void* dcv_part, void* dh_part,
                                      void* dw, void* db, void* dcv, void* dh,
                                      int N, int H, int K, int L, int kb,
                                      int splits, void* stream) {
  if (N <= 0) return 0;
  const int C2 = 2 * K * L;
  if (bad_shape(H, K, L, kb) || ldq < C2 || ldq % 8 != 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (N + BM - 1) / BM;
  const int lat_tiles = (L + BL - 1) / BL;
  const dim3 g1(row_tiles, lat_tiles, (K + kb - 1) / kb);
  ag_dq_kernel<<<g1, THREADS, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(cv),
      static_cast<const float*>(g_mean), static_cast<const float*>(g_std),
      static_cast<bf16*>(dq), ldq, static_cast<float*>(db_part),
      static_cast<float*>(dcv_part), N, H, K, L, kb);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = sum_partials(static_cast<const float*>(db_part), row_tiles, C2,
                     static_cast<float*>(db), st);
  if (err) return err;
  err = sum_partials(static_cast<const float*>(dcv_part), lat_tiles,
                     static_cast<size_t>(N) * K, static_cast<float*>(dcv), st);
  if (err) return err;
  const dim3 g2(H / WE, (C2 + WC - 1) / WC);
  ag_dw_kernel<<<g2, THREADS, 0, st>>>(
      static_cast<const bf16*>(dq), ldq, static_cast<const bf16*>(h),
      static_cast<float*>(dw), N, H, C2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // the splits' column ranges: whole stages of HK columns
  int chunk = (C2 + splits - 1) / splits;
  chunk = (chunk + HK - 1) / HK * HK;
  const int S = (C2 + chunk - 1) / chunk;
  const dim3 g3(H / HN, (N + HM - 1) / HM, S);
  ag_dh_kernel<<<g3, THREADS, 0, st>>>(
      static_cast<const bf16*>(dq), ldq, static_cast<const bf16*>(w),
      static_cast<float*>(dh_part), N, H, C2, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(static_cast<const float*>(dh_part), S,
                      static_cast<size_t>(N) * H, static_cast<float*>(dh), st);
}
