// Fused teacher-forcing LSTM layer for Hopper (sm_90a): forward and
// backward, exported with a plain C interface and loaded through ctypes
// (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_lstm_seq.py
// (_fwd_kernel and _bwd_kernel, called through fused_lstm_seq):
//
//   forward, for t = 0 .. T-1 and every row n (m = t < lengths[n]):
//     gates = x_t @ Wx + bf16(h) @ Wh + b     bf16 operands, f32 accumulation
//     si, sf, tg, so = sigmoid(i), sigmoid(f + 1), tanh(g), sigmoid(o)
//     nc = sf * c + si * tg ;  nh = so * tanh(nc)
//     c, h = m ? (nc, nh) : (c, h)
//     hs[t] = bf16(m ? nh : 0), cs[t] = c, ga[t] = bf16(si, sf, tg, so)
//   backward, t = T-1 .. 0: dgates from the saved activated gates, then
//     dh_prev = dg16 @ Wh^T + (1-m) dh,  dx_t = dg16 @ Wx^T,
//     dWx = sum_t x_t^T dg16_t, dWh = sum_t bf16(h_prev)^T dg16_t,
//     db = sum of the f32 dgates.
//
// x [T,N,E] bf16, Wx [E,4H] and Wh [H,4H] bf16, b [4H] f32, c0/h0 [N,H]
// f32, lengths [N] int32.  Gate order (i, f, g, o), forget bias 1.0.
//
// What bounds it on this card: at the train shapes (T = 24, N = 1280,
// E = 256, H = 512) each step is a 1280 x 768 x 2048 product (4 GFLOP)
// that depends on the previous step, so the T steps run one after the
// other.  On the TPU one kernel walks t outermost and keeps (c, h) in
// VMEM.  Blocks on Hopper run in no order and Wh (2 MiB bf16) does not
// fit one block, so here each step is one launch from a host loop: a
// fused step kernel that computes x_t @ Wx + h @ Wh + b on the tensor
// cores (WMMA bf16 16x16x16) and does the gate maths and the mask in its
// epilogue; the [N,4H] pre-activation gates never reach device memory.
// The backward runs two launches per step (the gate derivatives, then
// one product for dh_prev and dx_t) and writes the bf16 dgates of every
// step; dWx and dWh are then reduced over all T*N rows by one WMMA
// kernel with split partials summed in a fixed order, and db from
// per-block f32 partials, so the result is deterministic: no float
// atomics.  No cp.async, TMA or wgmma yet: a simple kernel that is right.
// A persistent kernel with a grid-wide barrier between steps is the
// faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;     // 8 warps in every kernel of this file

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void round_store8(bf16* dst, const float* src) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __floats2bfloat162_rn(lo.x, lo.y);
  d2[1] = __floats2bfloat162_rn(lo.z, lo.w);
  d2[2] = __floats2bfloat162_rn(hi.x, hi.y);
  d2[3] = __floats2bfloat162_rn(hi.z, hi.w);
}

// ---------------------------------------------------------------------
// forward step: the tile of fused_lstm_step.cu.  A block computes all
// four gate columns of FU hidden units for FM rows (a 64 x 128 tile).
// ---------------------------------------------------------------------
constexpr int FM = 64;
constexpr int FU = 32;
constexpr int FN = 4 * FU;
constexpr int FK = 32;
constexpr int FA_LD = FK + 8;
constexpr int FB_LD = FN + 8;
constexpr int FC_LD = FN + 4;

__global__ void __launch_bounds__(THREADS)
seq_fwd_step_kernel(const bf16* __restrict__ x_t,     // [N,E]
                    const bf16* __restrict__ wx,      // [E,4H]
                    const bf16* __restrict__ wh,      // [H,4H]
                    const float* __restrict__ b,      // [4H]
                    const int* __restrict__ lengths,  // [N]
                    const float* __restrict__ c_prev, // [N,H]
                    const float* __restrict__ h_prev, // [N,H]
                    float* __restrict__ c_out,        // cs[t]
                    float* __restrict__ h_out,        // h carry after t
                    bf16* __restrict__ hs_t,          // [N,H]
                    bf16* __restrict__ ga_t,          // [N,4H]
                    int t, int N, int E, int H) {
  __shared__ __align__(128) bf16 As[FM * FA_LD];
  __shared__ __align__(128) bf16 Bs[FK * FB_LD];
  __shared__ __align__(128) float Cs[FM * FC_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.x * FM;
  const int u0 = blockIdx.y * FU;
  const int K = E + H;
  const int G = 4 * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int k0 = 0; k0 < K; k0 += FK) {
    // A stage [FM, FK]: from x_t while k0 < E, from bf16(h) after
    {
      const int r = tid / (FK / 8);
      const int cv = (tid % (FK / 8)) * 8;
      const int row = m0 + r;
      bf16* dst = &As[r * FA_LD + cv];
      if (row < N && k0 < E) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            &x_t[static_cast<size_t>(row) * E + k0 + cv]);
      } else if (row < N) {
        round_store8(dst, &h_prev[static_cast<size_t>(row) * H + (k0 - E) + cv]);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    // B stage [FK, FN]: tile column n is gate n / FU, unit u0 + n % FU
    const bf16* w = k0 < E ? wx + static_cast<size_t>(k0) * G
                           : wh + static_cast<size_t>(k0 - E) * G;
#pragma unroll
    for (int s = 0; s < (FK * FN / 8) / THREADS; ++s) {
      const int v = tid + s * THREADS;
      const int kr = v / (FN / 8);
      const int n = (v % (FN / 8)) * 8;
      const int col = (n / FU) * H + u0 + (n % FU);
      *reinterpret_cast<uint4*>(&Bs[kr * FB_LD + n]) =
          *reinterpret_cast<const uint4*>(&w[static_cast<size_t>(kr) * G + col]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wm * 16) * FA_LD + kk], FA_LD);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * FB_LD + wn * 64 + f * 16], FB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * FC_LD + wn * 64 + f * 16], acc[f],
                            FC_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < FM * FU; e += THREADS) {
    const int r = e / FU;
    const int uu = e % FU;
    const int row = m0 + r;
    if (row >= N) continue;
    const int u = u0 + uu;
    const float* cr = &Cs[r * FC_LD];
    const float si = sigmoid_f32(cr[0 * FU + uu] + b[0 * H + u]);
    const float sf = sigmoid_f32(cr[1 * FU + uu] + b[1 * H + u] + 1.0f);
    const float tg = tanhf(cr[2 * FU + uu] + b[2 * H + u]);
    const float so = sigmoid_f32(cr[3 * FU + uu] + b[3 * H + u]);
    const size_t o = static_cast<size_t>(row) * H + u;
    const float c = c_prev[o];
    const float nc = sf * c + si * tg;
    const float nh = so * tanhf(nc);
    const bool m = t < lengths[row];
    c_out[o] = m ? nc : c;
    h_out[o] = m ? nh : h_prev[o];
    hs_t[o] = __float2bfloat16(m ? nh : 0.0f);
    bf16* g = &ga_t[static_cast<size_t>(row) * G + u];
    g[0 * H] = __float2bfloat16(si);
    g[1 * H] = __float2bfloat16(sf);
    g[2 * H] = __float2bfloat16(tg);
    g[3 * H] = __float2bfloat16(so);
  }
}

// ---------------------------------------------------------------------
// backward, per step: gate derivatives.  A block walks GR rows for 32
// hidden units; its f32 dgate column sums are db partials.
// ---------------------------------------------------------------------
constexpr int GU = 32;
constexpr int GLANES = THREADS / GU;   // 8 row lanes

__global__ void __launch_bounds__(THREADS)
seq_bwd_gates_kernel(const bf16* __restrict__ ga_t,      // [N,4H]
                     const float* __restrict__ c_t,      // cs[t]
                     const float* __restrict__ c_prev,   // cs[t-1] or c0
                     const bf16* __restrict__ dhs_t,     // [N,H]
                     const float* __restrict__ dh_carry, // [N,H]
                     const float* __restrict__ dc_carry, // [N,H]
                     const int* __restrict__ lengths,
                     bf16* __restrict__ dg_t,            // [N,4H]
                     float* __restrict__ dc_next,        // [N,H]
                     float* __restrict__ db_part,        // [chunks,4H] of step t
                     int t, int N, int H, int rows_per_chunk) {
  __shared__ float red[GLANES][4][GU];
  const int tid = threadIdx.x;
  const int uu = tid % GU;
  const int lane = tid / GU;
  const int u = blockIdx.x * GU + uu;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(N, r0 + rows_per_chunk);
  const int G = 4 * H;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int row = r0 + lane; row < r1; row += GLANES) {
    const bool m = t < lengths[row];
    const size_t o = static_cast<size_t>(row) * H + u;
    const bf16* g = &ga_t[static_cast<size_t>(row) * G + u];
    const float si = __bfloat162float(g[0 * H]);
    const float sf = __bfloat162float(g[1 * H]);
    const float tg = __bfloat162float(g[2 * H]);
    const float so = __bfloat162float(g[3 * H]);
    const float dhc = dh_carry[o];
    const float dcc = dc_carry[o];
    const float dnh = m ? dhc + __bfloat162float(dhs_t[o]) : 0.0f;
    const float tanh_c = tanhf(c_t[o]);
    const float dnc = dnh * so * (1.0f - tanh_c * tanh_c) + (m ? dcc : 0.0f);
    const float d_i = dnc * tg * si * (1.0f - si);
    const float d_f = dnc * c_prev[o] * sf * (1.0f - sf);
    const float d_g = dnc * si * (1.0f - tg * tg);
    const float d_o = dnh * tanh_c * so * (1.0f - so);
    dc_next[o] = dnc * sf + (m ? 0.0f : dcc);
    bf16* d = &dg_t[static_cast<size_t>(row) * G + u];
    d[0 * H] = __float2bfloat16(d_i);
    d[1 * H] = __float2bfloat16(d_f);
    d[2 * H] = __float2bfloat16(d_g);
    d[3 * H] = __float2bfloat16(d_o);
    acc[0] += d_i;
    acc[1] += d_f;
    acc[2] += d_g;
    acc[3] += d_o;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) red[lane][q][uu] = acc[q];
  __syncthreads();
  if (tid < 4 * GU) {
    const int q = tid / GU;
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < GLANES; ++l) s += red[l][q][uu];
    db_part[static_cast<size_t>(blockIdx.y) * G + q * H + u] = s;
  }
}

// ---------------------------------------------------------------------
// backward, per step: [dh_prev | dx_t] = dg16 @ [Wh | Wx]^T.  Output
// columns j < H come from Wh (plus the masked rows' dh pass-through),
// j >= H from Wx.  A block computes a 64 x 64 tile over K = 4H.
// ---------------------------------------------------------------------
constexpr int PM = 64;
constexpr int PN = 64;
constexpr int PK = 32;
constexpr int PA_LD = PK + 8;
constexpr int PB_LD = PK + 8;    // B kept column-major: [PN][PK]
constexpr int PC_LD = PN + 4;

__global__ void __launch_bounds__(THREADS)
seq_bwd_dh_dx_kernel(const bf16* __restrict__ dg_t,      // [N,4H]
                     const bf16* __restrict__ wh,        // [H,4H]
                     const bf16* __restrict__ wx,        // [E,4H]
                     const float* __restrict__ dh_carry, // [N,H]
                     const int* __restrict__ lengths,
                     float* __restrict__ dh_next,        // [N,H]
                     float* __restrict__ dx_t,           // [N,E]
                     int t, int N, int E, int H) {
  __shared__ __align__(128) bf16 As[PM * PA_LD];
  __shared__ __align__(128) bf16 Bs[PN * PB_LD];
  __shared__ __align__(128) float Cs[PM * PC_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;       // 16-row slab
  const int wn = warp % 2;       // 32-column half
  const int m0 = blockIdx.x * PM;
  const int j0 = blockIdx.y * PN;
  const bool is_dh = j0 < H;
  const bf16* w = is_dh ? wh + static_cast<size_t>(j0) * 4 * H
                        : wx + static_cast<size_t>(j0 - H) * 4 * H;
  const int G = 4 * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int k0 = 0; k0 < G; k0 += PK) {
    {   // A: dg rows [m0, m0+64), columns [k0, k0+32); one vector each
      const int r = tid / (PK / 8);
      const int cv = (tid % (PK / 8)) * 8;
      const int row = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < N)
        v = *reinterpret_cast<const uint4*>(&dg_t[static_cast<size_t>(row) * G + k0 + cv]);
      *reinterpret_cast<uint4*>(&As[r * PA_LD + cv]) = v;
    }
    {   // B^T: W rows [j0, j0+64), columns [k0, k0+32); one vector each
      const int jr = tid / (PK / 8);
      const int cv = (tid % (PK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[jr * PB_LD + cv]) =
          *reinterpret_cast<const uint4*>(&w[static_cast<size_t>(jr) * G + k0 + cv]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wm * 16) * PA_LD + kk], PA_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[(wn * 32 + f * 16) * PB_LD + kk], PB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * PC_LD + wn * 32 + f * 16], acc[f],
                            PC_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < PM * PN; e += THREADS) {
    const int r = e / PN;
    const int jj = e % PN;
    const int row = m0 + r;
    if (row >= N) continue;
    const float v = Cs[r * PC_LD + jj];
    if (is_dh) {
      const size_t o = static_cast<size_t>(row) * H + j0 + jj;
      dh_next[o] = v + (t < lengths[row] ? 0.0f : dh_carry[o]);
    } else {
      dx_t[static_cast<size_t>(row) * E + (j0 - H) + jj] = v;
    }
  }
}

// ---------------------------------------------------------------------
// weight gradients: part[s] = sum over rows m of split s of
// A[m, :]^T DG[m, :], A [M, KO] bf16 (rows [0, split) from a_lo, the
// rest from a_hi), DG [M, G] bf16.  A block computes a 64 x 128 tile.
// ---------------------------------------------------------------------
constexpr int WM = 64;            // output rows (A columns)
constexpr int WN = 128;           // output columns (gate columns)
constexpr int WK = 32;            // rows m per stage
constexpr int WA_LD = WM + 8;     // A kept as [WK][WM]: column-major
constexpr int WB_LD = WN + 8;

__global__ void __launch_bounds__(THREADS)
seq_bwd_dw_kernel(const bf16* __restrict__ a_lo, const bf16* __restrict__ a_hi,
                  int split, int M, int KO,
                  const bf16* __restrict__ dg, int G,
                  float* __restrict__ part, int rows_per_split) {
  __shared__ __align__(128) bf16 As[WK * WA_LD];
  __shared__ __align__(128) bf16 Bs[WK * WB_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int i0 = blockIdx.x * WM;
  const int n0 = blockIdx.y * WN;
  const int ms = blockIdx.z * rows_per_split;
  const int me = min(M, ms + rows_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int k0 = ms; k0 < me; k0 += WK) {
    {   // A rows m [k0, k0+32), columns [i0, i0+64): one vector each
      const int r = tid / (WM / 8);
      const int cv = (tid % (WM / 8)) * 8;
      const int m = k0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < me) {
        const bf16* src = m < split ? a_lo + static_cast<size_t>(m) * KO
                                    : a_hi + static_cast<size_t>(m - split) * KO;
        v = *reinterpret_cast<const uint4*>(src + i0 + cv);
      }
      *reinterpret_cast<uint4*>(&As[r * WA_LD + cv]) = v;
    }
#pragma unroll
    for (int s = 0; s < (WK * WN / 8) / THREADS; ++s) {   // DG rows: two vectors
      const int v = tid + s * THREADS;
      const int r = v / (WN / 8);
      const int cv = (v % (WN / 8)) * 8;
      const int m = k0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < me)
        val = *reinterpret_cast<const uint4*>(&dg[static_cast<size_t>(m) * G + n0 + cv]);
      *reinterpret_cast<uint4*>(&Bs[r * WB_LD + cv]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
      wmma::load_matrix_sync(af, &As[kk * WA_LD + wm * 16], WA_LD);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * WB_LD + wn * 64 + f * 16], WB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(blockIdx.z) * KO * G;
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(
        &out[static_cast<size_t>(i0 + wm * 16) * G + n0 + wn * 64 + f * 16],
        acc[f], G, wmma::mem_row_major);
}

// out[i] = sum_s part[s * len + i], s in order
__global__ void sum_parts_kernel(const float* __restrict__ part, int S,
                                 size_t len, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[static_cast<size_t>(s) * len + i];
  out[i] = acc;
}

int sum_parts(const float* part, int S, size_t len, float* out,
              cudaStream_t stream) {
  const int blocks = static_cast<int>((len + THREADS - 1) / THREADS);
  sum_parts_kernel<<<blocks, THREADS, 0, stream>>>(part, S, len, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape rule of every entry point: E % 64 == 0, H % 64 == 0, T >= 1.
// Each returns a cudaError_t as int: 0 when every launch was accepted.

// hs [T,N,H] bf16, cs [T,N,H] f32, ga [T,N,4H] bf16 are written for all
// t; hbuf [2,N,H] f32 holds the h carry, h_T in hbuf[(T-1) % 2].
extern "C" int vct_fused_lstm_seq_fwd(
    const void* x, const void* wx, const void* wh, const void* b,
    const void* lengths, const void* c0, const void* h0,
    void* hs, void* cs, void* ga, void* hbuf,
    int T, int N, int E, int H, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (E % 64 != 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nh = static_cast<size_t>(N) * H;
  const dim3 grid((N + FM - 1) / FM, H / FU);
  for (int t = 0; t < T; ++t) {
    const float* c_prev = t == 0 ? static_cast<const float*>(c0)
                                 : static_cast<const float*>(cs) + (t - 1) * nh;
    const float* h_prev = t == 0 ? static_cast<const float*>(h0)
                                 : static_cast<const float*>(hbuf) + ((t - 1) % 2) * nh;
    seq_fwd_step_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(x) + static_cast<size_t>(t) * N * E,
        static_cast<const bf16*>(wx), static_cast<const bf16*>(wh),
        static_cast<const float*>(b), static_cast<const int*>(lengths),
        c_prev, h_prev, static_cast<float*>(cs) + t * nh,
        static_cast<float*>(hbuf) + (t % 2) * nh,
        static_cast<bf16*>(hs) + t * nh,
        static_cast<bf16*>(ga) + t * 4 * nh, t, N, E, H);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

// Workspace (the wrapper allocates it): dg [T,N,4H] bf16, dhbuf/dcbuf
// [2,N,H] f32, db_part [T, chunks, 4H] f32 with chunks =
// ceil(N / rows_per_chunk), w_part [splits, H or E (the larger), 4H] f32.
// h0_16 is bf16(h0) [N,H]: the h_prev rows of step 0.
extern "C" int vct_fused_lstm_seq_bwd(
    const void* x, const void* wx, const void* wh, const void* lengths,
    const void* c0, const void* h0_16, const void* cs, const void* hs,
    const void* ga, const void* dhs, const void* dct, const void* dht,
    void* dx, void* dc0, void* dh0, void* dwx, void* dwh, void* db,
    void* dg, void* dhbuf, void* dcbuf, void* db_part, void* w_part,
    int T, int N, int E, int H, int rows_per_chunk, int splits,
    void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (E % 64 != 0 || H % 64 != 0 || rows_per_chunk <= 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t nh = static_cast<size_t>(N) * H;
  const int G = 4 * H;
  const int chunks = (N + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 g_grid(H / GU, chunks);
  const dim3 p_grid((N + PM - 1) / PM, (H + E) / PN);
  float* dh_b = static_cast<float*>(dhbuf);
  float* dc_b = static_cast<float*>(dcbuf);
  for (int t = T - 1; t >= 0; --t) {
    const float* dh_carry = t == T - 1 ? static_cast<const float*>(dht)
                                       : dh_b + ((t + 1) % 2) * nh;
    const float* dc_carry = t == T - 1 ? static_cast<const float*>(dct)
                                       : dc_b + ((t + 1) % 2) * nh;
    float* dh_next = t == 0 ? static_cast<float*>(dh0) : dh_b + (t % 2) * nh;
    float* dc_next = t == 0 ? static_cast<float*>(dc0) : dc_b + (t % 2) * nh;
    const float* c_prev = t == 0 ? static_cast<const float*>(c0)
                                 : static_cast<const float*>(cs) + (t - 1) * nh;
    bf16* dg_t = static_cast<bf16*>(dg) + t * 4 * nh;
    seq_bwd_gates_kernel<<<g_grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(ga) + t * 4 * nh,
        static_cast<const float*>(cs) + t * nh, c_prev,
        static_cast<const bf16*>(dhs) + t * nh, dh_carry, dc_carry,
        static_cast<const int*>(lengths), dg_t, dc_next,
        static_cast<float*>(db_part) + static_cast<size_t>(t) * chunks * G,
        t, N, H, rows_per_chunk);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    seq_bwd_dh_dx_kernel<<<p_grid, THREADS, 0, st>>>(
        dg_t, static_cast<const bf16*>(wh), static_cast<const bf16*>(wx),
        dh_carry, static_cast<const int*>(lengths), dh_next,
        static_cast<float*>(dx) + static_cast<size_t>(t) * N * E, t, N, E, H);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  // dWx over all T*N rows of x; dWh over [bf16(h0); hs[0 .. T-2]]
  const int M = T * N;
  int rows_per_split = (M + splits - 1) / splits;
  rows_per_split = (rows_per_split + WK - 1) / WK * WK;
  const int S = (M + rows_per_split - 1) / rows_per_split;
  const struct { const void* lo; const void* hi; int split; int ko; void* out; } jobs[2] = {
      {x, x, M, E, dwx}, {h0_16, hs, N, H, dwh}};
  for (const auto& job : jobs) {
    const dim3 grid(job.ko / WM, G / WN, S);
    seq_bwd_dw_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(job.lo), static_cast<const bf16*>(job.hi),
        job.split, M, job.ko, static_cast<const bf16*>(dg), G,
        static_cast<float*>(w_part), rows_per_split);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    err = sum_parts(static_cast<const float*>(w_part), S,
                    static_cast<size_t>(job.ko) * G, static_cast<float*>(job.out), st);
    if (err) return err;
  }
  return sum_parts(static_cast<const float*>(db_part), T * chunks,
                   static_cast<size_t>(G), static_cast<float*>(db), st);
}
