// Shared by the linear cross-entropy kernels for Hopper (sm_90a): the flash
// schedule (fused_ce.cu) and the written-logits schedule (fused_ce_mat.cu).
// The forward kernel template and its merge launch, which both schedules
// run: the flash forward folds each f32 logits tile into the per-row (max,
// sum-exp) and label logit; the written-logits forward (WRITE_LG) does the
// same and also stores the tile as bf16.  Also the split-sum launch of both
// backwards and the launch helpers.
//
//   S   = h @ W^T + b        h [M, H], W [V, H] bf16; b f32; f32 accumulation
//   lse = logsumexp_v S,    ll = S[label] (0 for a label that is no column)
//
// The forward, ce_fwd_kernel<H, WRITE_LG>, runs row_ring.cuh's product
// loop (RowRing<Bf16Op, 2, true, H / 64>: the resident rows, the W ring
// and the accumulators), which the decode's logits top-k shares, and
// folds each tile as below.
// What bounds it on this card: tensor-core operations, 2·M·H·V (362 GFLOP
// at M = 30720, H = 512, V = 11500: 0.366 ms at the dense bf16 rate); the
// written logits (708 MB) take 0.21 ms at the memory rate beside them.
//
// * Resident rows, streamed vocabulary.  A block keeps 128 rows of h in
//   shared memory (TMA, 64 x 64 boxes, 128-byte swizzle; 128 KB at H =
//   512), loaded once, and streams W through a ring of [128 vocab rows x
//   64 columns] boxes (16 KB; at H = 512 6 stages, 4 with WRITE_LG; 8
//   below), one full mbarrier per stage.
// * wgmma: two consumer warpgroups, 64 rows each, accumulate their S tile
//   [64 x 128] in registers (m64n128k16, 64 f32 a thread) over the H / 64
//   boxes of a vocab tile; both read the same W box, so a box is A-reused
//   by two products and each W byte is read from L2 once per 128 rows.
// * Refill: each warpgroup commits one wgmma group per box and, once the
//   previous box's group retired, its leader counts that release in
//   shared memory; the later of the two leaders refills the stage, STAGES
//   boxes ahead.  Nobody waits to refill.
// * The softmax fold in registers: each thread owns 2 rows x 32 columns of
//   a tile; the 4 lanes of a row take the tile's row max by two shuffles
//   and keep the row's running max and each its own sum-exp, which they
//   add once, at the end.  The tile's biases are requested before its
//   products; each exp is one FFMA and one ex2.  The label pick compares
//   the label's offset from the thread's first column; a thread that
//   holds no label column skips it.  While one warpgroup folds, the
//   other's products keep the tensor cores busy.
// * Ragged edges: TMA fills W rows past V and h rows past M with zeros; a
//   column past V takes bias -1e30 (its S is exactly 0), so exp gives 0
//   there and the written pad columns V..Vp-1 hold -1e30.  Rows past M are
//   never stored.
// * Written logits (708 MB at the train shapes): each warpgroup rounds its
//   tile to bf16 (nearest even) into two swizzled 64 x 64 boxes in shared
//   memory and its leader stores them with TMA (clipped at row M and
//   column Vp), which runs while the next tile's products do; lse and ll
//   come from the f32 S before the rounding.  (Storing each thread's
//   4-byte pairs straight from the registers cost 0.36 ms more than the
//   flash forward.)
// * Vocab chunks: grid (row tiles of 128, vocab chunks); chunk y takes the
//   128-column vocab tiles [y·chunk_tiles, (y + 1)·chunk_tiles) and writes
//   its (m, s, ll) partial; ce_merge_kernel merges them in chunk order, so
//   the results repeat bit for bit (no atomics).  ops/fused_ce.py's
//   ce_fwd_plan picks the chunks by wave fill.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;      // the merge and split-sum launches

// the written logits' row pitch: V rounded up to 64 columns (128 bytes), the
// TMA box and swizzle width of the written-logits backward
constexpr int LG_COLS = 64;
__host__ __device__ __forceinline__ int logits_pitch(int V) {
  return (V + LG_COLS - 1) / LG_COLS * LG_COLS;
}

// ---------------------------------------------------------------------
// the forward template
// ---------------------------------------------------------------------

constexpr int FWD_THREADS = 256;  // two consumer warpgroups
constexpr int FWD_ROWS = 128;     // resident h rows of a block, 64 a warpgroup
constexpr int FWD_TV = 128;       // vocab rows of a W tile (wgmma N)

template <int H, bool WRITE_LG>
struct Fwd {
  static constexpr int BOXES = H / BOX;               // boxes per tile
  // WRITE_LG: each warpgroup's bf16 tile [64 x 128], two swizzled boxes
  static constexpr int LG_BYTES = WRITE_LG ? 2 * 2 * BOX_BYTES : 0;
  // 128 resident rows, W boxes of 16 KB: at H = 512 6 stages, 4 with
  // WRITE_LG; 8 below
  using Ring = RowRing<Bf16Op, 2, true, BOXES, LG_BYTES>;
  static constexpr size_t SMEM = Ring::SMEM;
  static_assert(Ring::FIXED_STAGES >= 4, "a ring of at least four W boxes");
  static_assert(SMEM <= SMEM_MAX, "one block per SM: 227 KB of shared memory");
};

// Grid (row tiles of 128, vocab chunks); part [chunks, M, 3] = (m, s, ll).
// With WRITE_LG the f32 tile (pad columns NEG) is also stored, rounded to
// nearest even, through lg_map into lg [M, logits_pitch(V)] bf16 (the
// flash schedule passes any map there; it is never read).
template <int H, bool WRITE_LG>
__global__ void __launch_bounds__(FWD_THREADS, 1)
ce_fwd_kernel(const __grid_constant__ CUtensorMap h_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap lg_map,
              const float* __restrict__ b, const int* __restrict__ labels,
              float* __restrict__ part, int M, int V, int chunk_tiles) {
  using P = Fwd<H, WRITE_LG>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int m0 = blockIdx.x * FWD_ROWS;
  const int tiles = (V + FWD_TV - 1) / FWD_TV;
  const int t0 = blockIdx.y * chunk_tiles;
  const int n_tiles = max(0, min(tiles, t0 + chunk_tiles) - t0);
  const typename P::Ring ring(smem, P::BOXES, &h_map, &w_map, m0, t0, n_tiles);
  unsigned char* lg_s = ring.extra;
  ring.start();

  // This thread's accumulator fragment: rows r + 8i (i = 0, 1) of its
  // warpgroup's 64, columns v0 + cq + 8n + j (n < 16, j < 2) at register
  // 4n + 2i + j.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  int row[2], lab[2];
  float m_run[2], s_run[2], ll[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = m0 + wg * BT + r + 8 * i;
    const int l = row[i] < M ? labels[row[i]] : -1;
    lab[i] = l < V ? l : -1;      // a label past V picks no column
    m_run[i] = -INFINITY;
    s_run[i] = 0.0f;
    ll[i] = 0.0f;
  }
  float acc[FWD_TV / 2];
  ring.wait_rows();

  for (int i = 0; i < n_tiles; ++i) {
    // the tile's biases, NEG past V (where S is exactly 0), requested
    // before its products so that the loads land while they run
    const int cb = (t0 + i) * FWD_TV + cq;    // this thread's first column
    float bias[FWD_TV / 4];
#pragma unroll
    for (int n = 0; n < FWD_TV / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cb + 8 * n + j;
        bias[2 * n + j] = col < V ? __ldg(&b[col]) : NEG;
      }
    // S [64 x 128] = h rows @ W tile^T, contracting H box by box
    ring.product(i, acc);

    // x = S + bias in place
#pragma unroll
    for (int n = 0; n < FWD_TV / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[4 * n + j] += bias[2 * n + j];
        acc[4 * n + 2 + j] += bias[2 * n + j];
      }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float tmax = acc[2 * ii];
#pragma unroll
      for (int n = 0; n < FWD_TV / 8; ++n)
        tmax = fmaxf(tmax, fmaxf(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]));
      // the row's tile max over its 4 lanes: finite, since the tile's first
      // column is < V.  (A lane's own max may be the pad's NEG, and then
      // fmaf(NEG, LOG2E, -NEG·LOG2E) is the product's rounding error,
      // about +6e21, whose ex2 is inf.)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run[ii], tmax);
      const float ms = m_new * LOG2E;
      float se = 0.0f;
#pragma unroll
      for (int n = 0; n < FWD_TV / 8; ++n)
        se += ex2(fmaf(acc[4 * n + 2 * ii], LOG2E, -ms)) +
              ex2(fmaf(acc[4 * n + 2 * ii + 1], LOG2E, -ms));
      s_run[ii] = s_run[ii] * ex2((m_run[ii] - m_new) * LOG2E) + se;
      m_run[ii] = m_new;
      // the label's column, when this thread holds it: offset 8n + j
      const int rel = lab[ii] - cb;
      if (rel >= 0 && rel < FWD_TV && (rel & 6) == 0) {
#pragma unroll
        for (int n = 0; n < FWD_TV / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (8 * n + j == rel) ll[ii] += acc[4 * n + 2 * ii + j];
      }
    }
    if constexpr (WRITE_LG) {
      // the bf16 tile into this warpgroup's two swizzled boxes (column 8n +
      // cq of a row in 16-byte chunk n % 8 ^ row % 8), then one TMA store
      // per box; TMA clips rows past M and columns past Vp.  The boxes are
      // free once the previous tile's stores have read them.
      unsigned char* buf = lg_s + wg * 2 * BOX_BYTES;
      if (i > 0) {
        if (leader) tma_store_wait_read<0>();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int rw = r + 8 * ii;
#pragma unroll
        for (int n = 0; n < FWD_TV / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(
              buf + (n / 8) * BOX_BYTES + rw * 128 + (((n % 8) ^ (rw & 7)) * 16) + cq * 2) =
              __floats2bfloat162_rn(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      if (leader) {
        const int v0 = (t0 + i) * FWD_TV;
#pragma unroll
        for (int x = 0; x < 2; ++x)
          if (v0 + x * BOX < logits_pitch(V))
            tma_store(&lg_map, buf + x * BOX_BYTES, v0 + x * BOX, m0 + wg * BT);
        tma_store_commit();
      }
    }
  }
  if constexpr (WRITE_LG) {
    if (leader) tma_store_wait<0>();   // the stores are done before the block exits
  }

  // the 4 lanes of a row share its running max: sum-exp and ll summed
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const float m = m_run[ii];
    float s = s_run[ii];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    float l = ll[ii];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (lane % 4 == 0 && row[ii] < M) {
      float* p = part + (static_cast<size_t>(blockIdx.y) * M + row[ii]) * 3;
      p[0] = m;
      p[1] = s;
      p[2] = l;
    }
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

// grid (ceil(M / 128), ceil(ceil(V / 128) / chunk_tiles)); part [chunks, M, 3]
template <int H, bool WRITE_LG>
int launch_fwd(const bf16* h, const bf16* w, const float* b, const int* labels,
               float* part, bf16* lg, float* lse, float* ll, int M, int V,
               int chunk_tiles, cudaStream_t st) {
  CUtensorMap h_map, w_map, lg_map;
  int err = row_tile_map(&h_map, h, M, H);
  if (err) return err;
  err = row_tile_map(&w_map, w, V, H, FWD_TV);
  if (err) return err;
  // lg [M, Vp] bf16 in 64 x 64 boxes, as the written-logits backward reads it
  err = WRITE_LG ? row_tile_map(&lg_map, lg, M, logits_pitch(V)) : 0;
  if (err) return err;
  if (!WRITE_LG) lg_map = h_map;
  constexpr size_t smem = Fwd<H, WRITE_LG>::SMEM;
  err = allow_smem(ce_fwd_kernel<H, WRITE_LG>, smem);
  if (err) return err;
  const int tiles = (V + FWD_TV - 1) / FWD_TV;
  const int chunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  const dim3 grid((M + FWD_ROWS - 1) / FWD_ROWS, chunks);
  ce_fwd_kernel<H, WRITE_LG><<<grid, FWD_THREADS, smem, st>>>(
      h_map, w_map, lg_map, b, labels, part, M, V, chunk_tiles);
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

// the dynamic shared memory of the forward kernel at width H (bytes)
#define VCT_CE_FWD_SMEM(H, WRITE_LG)                                  \
  switch (H) {                                                        \
    case 64: return static_cast<int>(Fwd<64, WRITE_LG>::SMEM);         \
    case 128: return static_cast<int>(Fwd<128, WRITE_LG>::SMEM);       \
    case 256: return static_cast<int>(Fwd<256, WRITE_LG>::SMEM);       \
    default: return static_cast<int>(Fwd<512, WRITE_LG>::SMEM);        \
  }

// an entry point's switch over the widths the kernels are built for
#define VCT_CE_SWITCH_H(CALL)   \
  switch (H) {                  \
    case 64: return CALL(64);   \
    case 128: return CALL(128); \
    case 256: return CALL(256); \
    default: return CALL(512);  \
  }
