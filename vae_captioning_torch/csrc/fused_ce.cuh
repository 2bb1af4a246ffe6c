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
// The forward, ce_fwd_kernel<BOXES, RG, RES, WRITE_LG>, runs row_ring.cuh's
// product loop (RowRing<Bf16Op, RG, RES, BOXES>: the rows of h, the W ring
// and the accumulators), which the decode's logits top-k shares, and folds
// each tile as below.
// What bounds it on this card: tensor-core operations, 2·M·H·V (362 GFLOP
// at M = 30720, H = 512, V = 11500: 0.366 ms at the dense bf16 rate; 0.732
// ms at H = 1024); the written logits (708 MB) take 0.21 ms at the memory
// rate beside them.
//
// * The block shape (fwd_block, exported as vct_fused_ce_fwd_block; the
//   Python plan ce_fwd_plan asks it).  At H = 64, 128, 256 and 512 a block
//   keeps 128 rows of h resident in shared memory (RG = 2; TMA, 64 x 64
//   boxes, 128-byte swizzle; 128 KB at H = 512), loaded once, the box
//   count a compile-time constant.  Past 512 128 rows do not fit beside a
//   ring of four W boxes, so a block takes 64 rows (RG = 1): resident
//   where they fit beside four boxes (H <= 1280, with WRITE_LG 1152; H =
//   1024 built with its box count at compile time, any other width at a
//   runtime count), else streamed beside each W box (one 8 KB box of h per
//   16 KB box of W in a stage), as the decode's top-k takes them.  The W
//   ring holds at most 8 stages of [128 vocab rows x 64 columns] boxes (16
//   KB), as many as fit beside the rows: at H = 512 6 stages, 4 with
//   WRITE_LG; 8 below; at H = 1024 6, 5 with WRITE_LG; streamed 8.
// * wgmma: two consumer warpgroups accumulate S in registers over the
//   boxes of a vocab tile.  128-row blocks: each warpgroup its 64 rows x
//   the tile's 128 columns (m64n128k16, 64 f32 a thread), both reading the
//   same W box, so each W byte is read from L2 once per 128 rows.  64-row
//   blocks: both warpgroups the same 64 rows, each 64 of the tile's
//   columns (m64n64k16, 32 f32 a thread); in the flash forward's clusters
//   instead each all 128 columns of every other tile (m64n128k16,
//   row_ring.cuh's ALTERNATE), so that one folds while the other's
//   products run.
// * Refill: each warpgroup commits one wgmma group per box and, once the
//   previous box's group retired, its leader counts that release in
//   shared memory; the later of the two leaders refills the stage, STAGES
//   boxes ahead.  Nobody waits to refill.
// * The softmax fold in registers: each thread owns 2 rows x 32 (64-row blocks
//   on column halves: 16) columns of a tile; the 4 lanes of a row take the
//   tile's row max by two shuffles and keep the row's running max and each its
//   own sum-exp, which they add once, at the end.  The tile's biases are
//   requested before its products; each exp is one FFMA and one ex2.  The
//   label pick compares the label's offset from the thread's first column; a
//   thread that holds no label column skips it.  While one warpgroup folds,
//   the other's products keep the tensor cores busy.  In a 64-row block on
//   column halves a warpgroup whose half of the last tile lies past V skips
//   the fold (its columns hold no logit, and none lies below Vp).
// * Ragged edges: TMA fills W rows past V and h rows past M with zeros; a
//   column past V takes bias -1e30 (its S is exactly 0), so exp gives 0
//   there and the written pad columns V..Vp-1 hold -1e30.  Rows past M are
//   never stored.
// * Written logits (708 MB at the train shapes): each warpgroup rounds its
//   tile to bf16 (nearest even) into its swizzled 64 x 64 boxes in shared
//   memory (two in a 128-row block, one in a 64-row block) and its leader
//   stores them with TMA (clipped at row M and column Vp), which runs
//   while the next tile's products do; lse and ll come from the f32 S
//   before the rounding.  (Storing each thread's 4-byte pairs straight
//   from the registers cost 0.36 ms more than the flash forward.)
// * Vocab chunks: grid (row blocks, vocab chunks); chunk y takes the
//   128-column vocab tiles [y·chunk_tiles, (y + 1)·chunk_tiles) and writes
//   its (m, s, ll) partial, one per warpgroup in a 64-row block (partial
//   2y + warpgroup); ce_merge_kernel merges the partials in order, so the
//   results repeat bit for bit (no atomics).  ops/fused_ce.py's
//   ce_fwd_plan picks the chunks by wave fill.
// * Clusters past 512 (the shape rule fwd_cluster: the 64-row blocks whose
//   rows stay resident, H <= 1280, with WRITE_LG 1152; ops/fused_ce.py:
//   fwd_cluster).  A 64-row block alone streams every W box of its chunk, so W
//   is read from L2 once per 64 rows: 11.3 GB a launch at H = 1024 and the
//   train shapes.  There the kernel runs as clusters of FWD_CLUSTER CTAs along
//   M (launch_fwd: cudaLaunchKernelEx, the grid's row blocks rounded up to
//   whole clusters): adjacent 64-row blocks of one vocab chunk, each loading
//   128 / FWD_CLUSTER rows of every W box by TMA multicast into the stage of
//   all of them (row_ring.cuh, RowRing<..., CLUSTER>), so W is read once per
//   64·FWD_CLUSTER rows (5.65 GB at 1024), as a 128-row block would.  A
//   producer warp (the 9th) waits for the cluster's releases of a stage and
//   refills it; the consumer warpgroups only arrive.  A CTA whose rows all lie
//   past M still loads its part of every box for the others (its h rows read
//   as zeros) and stores nothing.  The fold, the label pick, the written
//   logits' staging and the partials (one a chunk and warpgroup) are the same
//   code.  On the H100 at 1024 the clusters took the flash forward from
//   1.78-1.82 to 1.47-1.50 ms on column halves; without the fold the blocks
//   alone and the clusters both run in 1.0-1.1 ms, so the products alone were
//   not bound by L2, and the fold, which no wgmma overlaps on column halves,
//   costs the rest.  On alternate tiles the flash forward took 1.42-1.43 ms
//   (576: 1.33 against 1.66; 1280: 3.10 against 3.42; kernel_designs.py
//   ce_fwd).  The written-logits forward keeps column halves: its staged bf16
//   tile is one box a warpgroup.  A card that cannot place a cluster at one
//   block an SM (cudaOccupancyMaxActiveClusters) gets ERR_CLUSTER back, and
//   the wrappers raise ClusterError; nothing falls back.

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
constexpr int FWD_TV = 128;       // vocab rows of a W tile
constexpr int CE_H_MAX = 4096;    // the widest H the kernels take
constexpr int FWD_CLUSTER = 2;    // the CTAs of the forward's clusters past 512

// what a cluster launch returns where the card cannot place one cluster:
// the wrappers raise ClusterError; nothing falls back to another kernel
constexpr int ERR_CLUSTER = 20001;

// the widths built with 128 resident rows and the box count at compile time
__host__ __device__ constexpr bool fixed_width(int H) {
  return H == 64 || H == 128 || H == 256 || H == 512;
}

// the widths the kernels take: the fixed ones, and past 512 every multiple
// of 64 up to CE_H_MAX
__host__ __device__ constexpr bool ce_width(int H) {
  return fixed_width(H) || (H > 512 && H <= CE_H_MAX && H % BOX == 0);
}

// WRITE_LG: each warpgroup's bf16 tile [64 x 128 / RG columns], RG swizzled
// boxes of its own
__host__ __device__ constexpr int fwd_lg_bytes(int rg, bool write_lg) {
  return write_lg ? 2 * rg * BOX_BYTES : 0;
}

// The forward's block at width H (a width ce_width takes) as rows · 2 +
// resident: 128 rows resident at the fixed widths; past them 64 rows,
// resident where they fit beside a ring of four W boxes, else streamed
__host__ __device__ constexpr int fwd_block(int H, bool write_lg) {
  return fixed_width(H) ? 2 * 128 + 1
                        : 2 * 64 + (ring_layout(H / BOX, 1, true, fwd_lg_bytes(1, write_lg))
                                            .stages >= 4 ? 1 : 0);
}

// The shape rule past 512: the CTAs of the forward's cluster at width H
// (a width ce_width takes), 0 where the blocks run alone: the fixed
// widths' 128-row blocks and the streamed 64-row ones
__host__ __device__ constexpr int fwd_cluster(int H, bool write_lg) {
  return !fixed_width(H) && fwd_block(H, write_lg) % 2 != 0 ? FWD_CLUSTER : 0;
}

// the threads of a block: two consumer warpgroups, and in a cluster the
// producer warp
__host__ __device__ constexpr int fwd_threads(int cluster) {
  return FWD_THREADS + (cluster > 1 ? 32 : 0);
}

// BOXES: the boxes of a row of h at compile time (0: the runtime count);
// RG: 64-row groups of a block (2: 128 rows); RES: h resident or streamed;
// CLUSTER: the CTAs of a cluster along M (1: none)
template <int BOXES, int RG, bool RES, bool WRITE_LG, int CLUSTER = 1>
struct Fwd {
  // the flash forward's clusters: the two warpgroups on alternate tiles
  static constexpr bool ALTERNATE = RG == 1 && CLUSTER > 1 && !WRITE_LG;
  using Ring = RowRing<Bf16Op, RG, RES, BOXES, fwd_lg_bytes(RG, WRITE_LG), CLUSTER, ALTERNATE>;
  static_assert(BOXES == 0 || Ring::FIXED_STAGES >= 4, "a ring of at least four W boxes");
  static_assert(BOXES == 0 || Ring::SMEM <= SMEM_MAX, "one block per SM: 227 KB of shared memory");
};

// Grid (row blocks of 64·RG, rounded up to whole clusters; vocab chunks);
// part [chunks · (RG == 1 ? 2 : 1), M, 3] = (m, s, ll).  With WRITE_LG the
// f32 tile (pad columns NEG) is also stored, rounded to nearest even,
// through lg_map into lg [M, logits_pitch(V)] bf16 (the flash schedule
// passes any map there; it is never read).  In a cluster w_map's boxes
// are 128 / CLUSTER rows: each CTA's part of a W box.
template <int BOXES, int RG, bool RES, bool WRITE_LG, int CLUSTER = 1>
__global__ void __launch_bounds__(fwd_threads(CLUSTER), 1)
ce_fwd_kernel(const __grid_constant__ CUtensorMap h_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap lg_map,
              const float* __restrict__ b, const int* __restrict__ labels,
              float* __restrict__ part, int M, int V, int boxes, int chunk_tiles) {
  using P = Fwd<BOXES, RG, RES, WRITE_LG, CLUSTER>;
  constexpr int NW = P::Ring::N;    // a warpgroup's columns of a tile
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int m0 = blockIdx.x * RG * BT;
  const int row0 = m0 + (RG == 2 ? wg * BT : 0);   // this warpgroup's first row
  const int tiles = (V + FWD_TV - 1) / FWD_TV;
  const int t0 = blockIdx.y * chunk_tiles;
  const int n_tiles = max(0, min(tiles, t0 + chunk_tiles) - t0);
  const typename P::Ring ring(smem, boxes, &h_map, &w_map, m0, t0, n_tiles);
  unsigned char* lg_s = ring.extra;
  ring.start();
  if constexpr (CLUSTER > 1) {
    if (tid >= FWD_THREADS) {     // the producer warp
      if (tid == FWD_THREADS) ring.produce();
      __syncwarp();
      cluster_arrive();
      cluster_wait();
      return;
    }
  }

  // This thread's accumulator fragment: rows r + 8i (i = 0, 1) of its
  // warpgroup's 64, columns v0 + cq + 8n + j (n < NW / 8, j < 2) at
  // register 4n + 2i + j.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  int row[2], lab[2];
  float m_run[2], s_run[2], ll[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = row0 + r + 8 * i;
    const int l = row[i] < M ? labels[row[i]] : -1;
    lab[i] = l < V ? l : -1;      // a label past V picks no column
    m_run[i] = -INFINITY;
    s_run[i] = 0.0f;
    ll[i] = 0.0f;
  }
  float acc[NW / 2];
  ring.wait_rows();

  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (P::ALTERNATE) {
      if ((i & 1) != wg) {
        ring.skip(i);
        continue;
      }
    }
    // this warpgroup's first column of the tile
    const int v0 = (t0 + i) * FWD_TV + (RG == 1 && !P::ALTERNATE ? wg * NW : 0);
    // the tile's biases, NEG past V (where S is exactly 0), requested
    // before its products so that the loads land while they run
    const int cb = v0 + cq;       // this thread's first column
    float bias[NW / 4];
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cb + 8 * n + j;
        bias[2 * n + j] = col < V ? __ldg(&b[col]) : NEG;
      }
    // S [64 x NW] = h rows @ W tile^T, contracting H box by box
    ring.product(i, acc);
    // RG = 1: this warpgroup's half of the last tile may lie past V, and
    // then also past Vp (both multiples of 64 columns from v0): no logit
    // to fold, none to store
    if (RG == 1 && v0 >= V) continue;

    // x = S + bias in place
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[4 * n + j] += bias[2 * n + j];
        acc[4 * n + 2 + j] += bias[2 * n + j];
      }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float tmax = acc[2 * ii];
#pragma unroll
      for (int n = 0; n < NW / 8; ++n)
        tmax = fmaxf(tmax, fmaxf(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]));
      // the row's tile max over its 4 lanes: finite, since the
      // warpgroup's first column is < V.  (A lane's own max may be the
      // pad's NEG, and then fmaf(NEG, LOG2E, -NEG·LOG2E) is the product's
      // rounding error, about +6e21, whose ex2 is inf.)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run[ii], tmax);
      const float ms = m_new * LOG2E;
      float se = 0.0f;
#pragma unroll
      for (int n = 0; n < NW / 8; ++n)
        se += ex2(fmaf(acc[4 * n + 2 * ii], LOG2E, -ms)) +
              ex2(fmaf(acc[4 * n + 2 * ii + 1], LOG2E, -ms));
      s_run[ii] = s_run[ii] * ex2((m_run[ii] - m_new) * LOG2E) + se;
      m_run[ii] = m_new;
      // the label's column, when this thread holds it: offset 8n + j
      const int rel = lab[ii] - cb;
      if (rel >= 0 && rel < NW && (rel & 6) == 0) {
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (8 * n + j == rel) ll[ii] += acc[4 * n + 2 * ii + j];
      }
    }
    if constexpr (WRITE_LG) {
      // the bf16 tile into this warpgroup's RG swizzled boxes (column 8n +
      // cq of a row in 16-byte chunk n % 8 ^ row % 8 of box n / 8), then
      // one TMA store per box; TMA clips rows past M and columns past Vp.
      // The boxes are free once the previous tile's stores have read them.
      unsigned char* buf = lg_s + wg * RG * BOX_BYTES;
      if (i > 0) {
        if (leader) tma_store_wait_read<0>();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int rw = r + 8 * ii;
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(
              buf + (n / 8) * BOX_BYTES + rw * 128 + (((n % 8) ^ (rw & 7)) * 16) + cq * 2) =
              __floats2bfloat162_rn(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      if (leader && (CLUSTER == 1 || row0 < M)) {   // a CTA past M stores nothing
#pragma unroll
        for (int x = 0; x < RG; ++x)
          if (v0 + x * BOX < logits_pitch(V))
            tma_store(&lg_map, buf + x * BOX_BYTES, v0 + x * BOX, row0);
        tma_store_commit();
      }
    }
  }
  if constexpr (WRITE_LG) {
    if (leader) tma_store_wait<0>();   // the stores are done before the block exits
  }
  // the cluster's CTAs exit together: none leaves while another may still
  // arrive on its barriers or load into its shared memory
  if constexpr (CLUSTER > 1) cluster_arrive();

  // the 4 lanes of a row share its running max: sum-exp and ll summed
  const int p = blockIdx.y * (RG == 1 ? 2 : 1) + (RG == 1 ? wg : 0);   // this partial
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
      float* q = part + (static_cast<size_t>(p) * M + row[ii]) * 3;
      q[0] = m;
      q[1] = s;
      q[2] = l;
    }
  }
  if constexpr (CLUSTER > 1) cluster_wait();
}

// lse[n] = m + log(sum_c s_c exp(m_c - m)), ll[n] = sum_c ll_c over the
// partials c in order (a partial with m_c = -inf, a warpgroup that folded
// no column, adds 0)
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

// the forward's dynamic shared memory at width H (bytes)
int fwd_smem(int H, bool write_lg) {
  const int shape = fwd_block(H, write_lg);
  const int rg = shape / 2 / BT;
  const int cluster = fwd_cluster(H, write_lg);
  return ring_layout(H / BOX, rg, shape % 2 != 0, fwd_lg_bytes(rg, write_lg),
                     cluster > 1 ? cluster : 1).smem;
}

// The clusters of `kernel` the current device holds at once under `cfg`
// (cudaOccupancyMaxActiveClusters), asked once a device and dynamic
// shared memory size and kept in `cache` (one a kernel instance); < 0:
// -cudaError_t
struct HeldClusters {
  int slots[64];     // 0: not asked yet (a card that holds none is asked again)
  size_t smem[64];
};

template <typename Kernel>
int held_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg, HeldClusters& cache) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= 64)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && (cache.slots[dev] == 0 || cache.smem[dev] != cfg.dynamicSmemBytes)) {
    e = cudaOccupancyMaxActiveClusters(&cache.slots[dev], kernel, &cfg);
    cache.smem[dev] = cfg.dynamicSmemBytes;
    if (e != cudaSuccess) cache.slots[dev] = 0;
  }
  return e != cudaSuccess ? -static_cast<int>(e) : cache.slots[dev];
}

// launches of the forward's cluster instances in this process (each
// library its own: fused_ce.cu the flash forward's, fused_ce_mat.cu the
// written logits'): the card tests and chip_smoke.py read it to see which
// instance ran
int fwd_cluster_launches = 0;

// the launch of ce_fwd_kernel<..., CLUSTER> over `grid`: clusters of
// (CLUSTER, 1, 1), the producer warp beside the consumers
template <int CLUSTER>
cudaLaunchConfig_t fwd_cluster_config(cudaLaunchAttribute* attr, dim3 grid, size_t smem,
                                      cudaStream_t st) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(fwd_threads(CLUSTER));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the clusters of ce_fwd_kernel<..., CLUSTER> the current device holds at
// once under `cfg` (its dynamic shared memory allowed), asked once a device
// and size; 0: none fits; < 0: -cudaError_t
template <int BOXES, int RG, bool RES, bool WRITE_LG, int CLUSTER>
int fwd_held_clusters(const cudaLaunchConfig_t& cfg) {
  static HeldClusters cache;
  return held_clusters(ce_fwd_kernel<BOXES, RG, RES, WRITE_LG, CLUSTER>, cfg, cache);
}

// grid (ceil(M / (64·RG)) rounded up to whole clusters, chunks); part
// [chunks · (RG == 1 ? 2 : 1), M, 3]
template <int BOXES, int RG, bool RES, bool WRITE_LG, int CLUSTER = 1>
int launch_fwd(const bf16* h, const bf16* w, const float* b, const int* labels,
               float* part, bf16* lg, float* lse, float* ll, int M, int H, int V,
               int chunk_tiles, cudaStream_t st) {
  CUtensorMap h_map, w_map, lg_map;
  int err = row_tile_map(&h_map, h, M, H);
  if (err) return err;
  err = row_tile_map(&w_map, w, V, H, FWD_TV / CLUSTER);
  if (err) return err;
  // lg [M, Vp] bf16 in 64 x 64 boxes, as the written-logits backward reads it
  err = WRITE_LG ? row_tile_map(&lg_map, lg, M, logits_pitch(V)) : 0;
  if (err) return err;
  if (!WRITE_LG) lg_map = h_map;
  const size_t smem = ring_layout(H / BOX, RG, RES, fwd_lg_bytes(RG, WRITE_LG), CLUSTER).smem;
  err = allow_smem(ce_fwd_kernel<BOXES, RG, RES, WRITE_LG, CLUSTER>, smem);
  if (err) return err;
  const int tiles = (V + FWD_TV - 1) / FWD_TV;
  const int chunks = (tiles + chunk_tiles - 1) / chunk_tiles;
  const int blocks = (M + RG * BT - 1) / (RG * BT);
  const dim3 grid((blocks + CLUSTER - 1) / CLUSTER * CLUSTER, chunks);
  if constexpr (CLUSTER > 1) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = fwd_cluster_config<CLUSTER>(attr, grid, smem, st);
    const int slots = fwd_held_clusters<BOXES, RG, RES, WRITE_LG, CLUSTER>(cfg);
    if (slots < 0) return -slots;
    if (slots == 0) return ERR_CLUSTER;
    err = static_cast<int>(cudaLaunchKernelEx(&cfg, ce_fwd_kernel<BOXES, RG, RES, WRITE_LG, CLUSTER>,
                                              h_map, w_map, lg_map, b, labels, part, M, V,
                                              H / BOX, chunk_tiles));
    if (!err) err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    ++fwd_cluster_launches;
  } else {
    ce_fwd_kernel<BOXES, RG, RES, WRITE_LG><<<grid, FWD_THREADS, smem, st>>>(
        h_map, w_map, lg_map, b, labels, part, M, V, H / BOX, chunk_tiles);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  ce_merge_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, chunks * (RG == 1 ? 2 : 1), M, lse, ll);
  return static_cast<int>(cudaGetLastError());
}

// the forward at width H: the instance of fwd_block's shape, in clusters
// where the shape rule fwd_cluster says
template <bool WRITE_LG>
int launch_fwd_h(const bf16* h, const bf16* w, const float* b, const int* labels,
                 float* part, bf16* lg, float* lse, float* ll, int M, int H, int V,
                 int chunk_tiles, cudaStream_t st) {
#define VCT_FWD(BX, RG, RES, C) \
  launch_fwd<BX, RG, RES, WRITE_LG, C>(h, w, b, labels, part, lg, lse, ll, M, H, V, chunk_tiles, st)
  switch (H) {
    case 64: return VCT_FWD(1, 2, true, 1);
    case 128: return VCT_FWD(2, 2, true, 1);
    case 256: return VCT_FWD(4, 2, true, 1);
    case 512: return VCT_FWD(8, 2, true, 1);
    default: break;
  }
  if (fwd_cluster(H, WRITE_LG))
    return H == 1024 ? VCT_FWD(16, 1, true, FWD_CLUSTER) : VCT_FWD(0, 1, true, FWD_CLUSTER);
  return VCT_FWD(0, 1, false, 1);
#undef VCT_FWD
}

bool bad_shape(int M, int H, int V) {
  return M <= 0 || V <= 0 || !ce_width(H);
}

}  // namespace

// an entry point's switch over the fixed widths (past them, CALL(0))
#define VCT_CE_SWITCH_H(CALL)   \
  switch (H) {                  \
    case 64: return CALL(64);   \
    case 128: return CALL(128); \
    case 256: return CALL(256); \
    case 512: return CALL(512); \
    default: return CALL(0);    \
  }
