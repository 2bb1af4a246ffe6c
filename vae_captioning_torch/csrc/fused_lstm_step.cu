// Fused LSTM decode step for Hopper (sm_90a), exported with a plain C
// interface and loaded through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernel vae_captioning_tpu/ops/fused_lstm_step.py
// (_kernel, called through fused_lstm_step):
//
//     gates = [x, bf16(h)] @ W + b        bf16 operands, f32 accumulation
//     c'    = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//     h'    = sigmoid(o) * tanh(c')        gate order i, f, g, o
//
// x [N,E] bf16, c/h [N,H] f32, W [E+H,4H] bf16 (x rows first), b [4H] f32
// -> c', h' [N,H] f32.  The row gather x = embed_bf16[tokens] stays with
// the caller, as it does on the TPU.
//
// What bounds it on this card: at decode sizes (N = beam * batch of a
// few thousand lanes, E = 256, H = 512) the step is a skinny matrix
// product of 2*N*(E+H)*4H flops over a 3 MB weight matrix that every
// block re-reads from L2, plus the [N,4H] f32 gate tensor that the
// unfused path writes to device memory and reads back (25 MB at
// N = 3072).  The design keeps the gates on chip: the output is tiled by
// hidden unit, so one block computes all four gate columns of its 32
// units for 64 lanes (a 64x128 tile on the tensor cores through WMMA
// bf16 16x16x16 fragments), stages the tile in shared memory and does
// the gate maths there.  Only x, c, h, W and the two [N,H] outputs touch
// device memory.  No cp.async, TMA or wgmma yet: a simple, right kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // lanes (rows) per block
constexpr int BU = 32;          // hidden units per block
constexpr int BN = 4 * BU;      // gate columns per block: i, f, g, o slabs
constexpr int BK = 32;          // depth of one shared-memory stage
constexpr int THREADS = 256;    // 8 warps: 4 row slabs x 2 column halves
constexpr int A_LD = BK + 8;    // padded leading dimensions (elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void __launch_bounds__(THREADS)
lstm_step_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ c,
                 const float* __restrict__ h,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ b,
                 float* __restrict__ c_out,
                 float* __restrict__ h_out,
                 int N, int E, int H, float forget_bias) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;      // 16-row slab of the tile
  const int wn = warp % 2;      // 64-column half: gates 2*wn and 2*wn+1
  const int m0 = blockIdx.x * BM;
  const int u0 = blockIdx.y * BU;
  const int K = E + H;
  const int G = 4 * H;          // columns of W

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A stage [BM, BK]: one 8-element vector per thread, from x while
    // k0 < E and from h (rounded to bf16 here) after.  E % BK == 0, so a
    // stage never straddles the two.
    {
      const int r = tid / (BK / 8);
      const int cv = (tid % (BK / 8)) * 8;
      const int row = m0 + r;
      __nv_bfloat16* dst = &As[r * A_LD + cv];
      if (row < N && k0 < E) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            &x[static_cast<size_t>(row) * E + k0 + cv]);
      } else if (row < N) {
        const float* src = &h[static_cast<size_t>(row) * H + (k0 - E) + cv];
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
        d2[0] = __floats2bfloat162_rn(lo.x, lo.y);
        d2[1] = __floats2bfloat162_rn(lo.z, lo.w);
        d2[2] = __floats2bfloat162_rn(hi.x, hi.y);
        d2[3] = __floats2bfloat162_rn(hi.z, hi.w);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    // B stage [BK, BN]: tile column n is gate n / BU, unit u0 + n % BU,
    // i.e. W column (n / BU) * H + u0 + n % BU.  Two vectors per thread.
#pragma unroll
    for (int s = 0; s < (BK * BN / 8) / THREADS; ++s) {
      const int v = tid + s * THREADS;
      const int kr = v / (BN / 8);
      const int n = (v % (BN / 8)) * 8;
      const int col = (n / BU) * H + u0 + (n % BU);
      *reinterpret_cast<uint4*>(&Bs[kr * B_LD + n]) =
          *reinterpret_cast<const uint4*>(
              &w[static_cast<size_t>(k0 + kr) * G + col]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wm * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[kk * B_LD + wn * 64 + f * 16], B_LD);
        wmma::mma_sync(acc[f], af, bf, acc[f]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * C_LD + wn * 64 + f * 16], acc[f],
                            C_LD, wmma::mem_row_major);
  __syncthreads();

  // gate maths in f32, one (lane, unit) pair per thread and pass
  for (int e = tid; e < BM * BU; e += THREADS) {
    const int r = e / BU;
    const int uu = e % BU;
    const int row = m0 + r;
    if (row >= N) continue;
    const int u = u0 + uu;
    const float* cr = &Cs[r * C_LD];
    const float gi = cr[0 * BU + uu] + b[0 * H + u];
    const float gf = cr[1 * BU + uu] + b[1 * H + u];
    const float gg = cr[2 * BU + uu] + b[2 * H + u];
    const float go = cr[3 * BU + uu] + b[3 * H + u];
    const size_t o = static_cast<size_t>(row) * H + u;
    const float nc = sigmoid_f32(gf + forget_bias) * c[o]
                     + sigmoid_f32(gi) * tanhf(gg);
    c_out[o] = nc;
    h_out[o] = sigmoid_f32(go) * tanhf(nc);
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int vct_fused_lstm_step(const void* x, const void* c,
                                   const void* h, const void* w,
                                   const void* b, void* c_out, void* h_out,
                                   int N, int E, int H, float forget_bias,
                                   void* stream) {
  if (N <= 0) return 0;
  if (E % BK != 0 || H % BU != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BM - 1) / BM, H / BU);
  lstm_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(c),
      static_cast<const float*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<float*>(c_out),
      static_cast<float*>(h_out), N, E, H, forget_bias);
  return static_cast<int>(cudaGetLastError());
}
