// The product loop that the written-logits CE backward (fused_ce_mat.cu,
// ce_mat_bwd_kernel<CT, DW>), the AG-heads backward products
// (fused_ag_heads.cu, ag_mat_kernel<CT, DW>) and the LSTM sequence
// backward's weight gradients (fused_lstm_seq.cu, seq_dw_kernel<CT>)
// share: a block owns 64 output rows and CT output columns and streams a K
// operand in tiles of [64 rows x CT columns], each with the matching 64 x
// 64 box of a second matrix A (the CE's written logits, the AG's dq, the
// LSTM's x or h), through a TMA ring:
//
//   out [64 x CT] += A box [64 x 64] @ K tile [64 x CT]
//
//              DW = false                      DW = true
//   out rows   A's rows                         A's columns
//   A box      (rows = out rows, cols = K rows) (rows = K rows, cols = out rows)
//   A operand  K-major                          MN-major (read transposed)
//
// * A stage holds a K tile (64 x 64 boxes, 128-byte swizzle) and its A box
//   (the same swizzle); a full barrier per stage counts the bytes in.  No
//   resident tile, so the ring has 3 stages at CT = 512, 5 at 256, 8 below.
// * Two consumer warpgroups each own CT / 2 output columns (m64n256 at CT =
//   512, 128 accumulator registers a thread), B MN-major from the K tile.
// * Refill: a warpgroup's product reads only its half of the K tile, so its
//   leader refills that half as soon as its own product retires.  Both read
//   the whole A box: the leaders count their releases of a stage in shared
//   memory, and the later of the two also loads the A box (at CT = 64, one K
//   box, the later loads the whole stage).  Nobody waits to refill.
// * A per-tile step runs between the wait for a stage and its product: the
//   CE backward forms dl in place in the A box there; the AG backward's A is
//   the operand as written.
// * The first product (tile 0, k16 step 0) overwrites the accumulators
//   (scale_d 0): zeroing them with plain instructions made ptxas serialise
//   the AG products' wgmmas (C7515).  So every block needs a tile: the
//   launches give no block an empty K range.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int MAT_THREADS = 256;   // two consumer warpgroups

template <int CT>
struct MatRing {
  static constexpr int BOXES = CT / BOX;              // boxes per K tile
  static constexpr int TILE = BT * CT * 2;            // bytes of a K tile
  static constexpr int STAGE = TILE + BOX_BYTES;      // + its A box
  static constexpr int STAGES = CT == 512 ? 3 : CT == 256 ? 5 : 8;
  static constexpr int HN = CT / 2;                   // output columns per warpgroup
  static constexpr int ACC = HN / 2;                  // their f32 registers per thread
  // at CT >= 128 a K tile is loaded by two threads, one box half each
  static constexpr bool SPLIT = BOXES >= 2;
  // 1 KB to align the stages to the swizzle's 1024-byte period; the ring,
  // the full barriers, the release counters and `extra` bytes of the
  // kernel's own (from mat_ring_extra)
  __host__ __device__ static constexpr size_t smem(size_t extra) {
    return 1024 + static_cast<size_t>(STAGE) * STAGES +
           STAGES * (sizeof(uint64_t) + sizeof(uint32_t)) + extra;
  }
};

// the kernel's own shared memory, after the ring's barriers (4-byte aligned)
template <int CT>
__device__ __forceinline__ unsigned char* mat_ring_extra(unsigned char* ring) {
  using P = MatRing<CT>;
  return ring + P::STAGES * P::STAGE + P::STAGES * (sizeof(uint64_t) + sizeof(uint32_t));
}

// NB boxes of the K tile from box c0 at (col, row) into `dst` and, with `a`,
// the A box at (a_x, a_y) into `a_dst`; all the bytes complete on `bar`.
// The box count is a compile-time constant, as in load_boxes, and nothing
// branches but the A box.
template <int NB>
__device__ __forceinline__ void mat_ring_load(unsigned char* dst, unsigned char* a_dst,
                                              const CUtensorMap* k_map,
                                              const CUtensorMap* a_map, uint64_t* bar,
                                              int c0, int col, int row, bool a,
                                              int a_x, int a_y) {
  mbar_expect_tx(bar, (NB + (a ? 1 : 0)) * BOX_BYTES);
#pragma unroll
  for (int c = 0; c < NB; ++c)
    tma_load(dst + (c0 + c) * BOX_BYTES, k_map, bar, col + (c0 + c) * BOX, row);
  if (a) tma_load(a_dst, a_map, bar, a_x, a_y);
}

// acc [64 x CT / 2] of this warpgroup = sum over the K tiles [t0, t0 +
// n_tiles) (n_tiles >= 1) of the A box @ the K tile's columns [e0, e0 + CT).
// The ring starts at `ring` (1024-byte aligned).  step(i, a_box, wait) runs
// for tile i with the stage's A box in shared memory; it must call wait()
// before it touches the box, and leave the box ready for wgmma (a proxy
// fence and a barrier of the block's threads where it wrote to it).
template <int CT, bool DW, typename Step>
__device__ __forceinline__ void mat_ring_product(float (&acc)[MatRing<CT>::ACC],
                                                 unsigned char* ring,
                                                 const CUtensorMap* k_map,
                                                 const CUtensorMap* a_map, int x0,
                                                 int e0, int t0, int n_tiles,
                                                 Step&& step) {
  using P = MatRing<CT>;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::STAGES * P::STAGE);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + P::STAGES);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const bool leader = tid % 128 == 0;

  // tile t0 + i into stage i % STAGES: this warpgroup's half of the K boxes
  // (at CT = 64 the one box, loaded only with the A box) and, when `a`, the
  // A box
  constexpr int NB = P::SPLIT ? P::BOXES / 2 : 1;
  const int c0 = P::SPLIT ? wg * NB : 0;
  auto load = [&](int i, bool a) {
    const int s = i % P::STAGES;
    unsigned char* dst = ring + s * P::STAGE;
    const int k0 = (t0 + i) * BT;
    mat_ring_load<NB>(dst, dst + P::TILE, k_map, a_map, &full[s], c0, e0, k0,
                      a || !P::SPLIT, DW ? x0 : k0, DW ? k0 : x0);
  };
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], P::SPLIT ? 2 : 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (leader && (P::SPLIT || wg == 0))
    for (int i = 0; i < min(P::STAGES, n_tiles); ++i) load(i, wg == 0);

  const uint32_t ring_addr = smem_addr(ring);
  // this warpgroup's output columns in a K tile: their box, bytes within it
  const uint32_t out_cols = (wg * P::HN / BOX) * BOX_BYTES + (wg * P::HN % BOX) * 2;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % P::STAGES;
    const uint32_t stage = ring_addr + s * P::STAGE;
    step(i, ring + s * P::STAGE + P::TILE,
         [&] { mbar_wait(&full[s], (i / P::STAGES) & 1); });
    // out [64 x HN] += A [64 x 64] @ K_tile [64 x HN]: DW = false, A = the
    // box (rows x contraction, K-major: k16 steps 32 bytes along the row);
    // DW = true, A = the box transposed, read MN-major (k16 steps of 16
    // rows)
    const uint32_t a_addr = stage + P::TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b_desc = sw128_desc(stage + out_cols + kk * 16 * 128, BOX_BYTES);
      if constexpr (DW)
        wgmma<P::HN, 1, 1>(acc, sw128_desc(a_addr + kk * 16 * 128, BOX_BYTES), b_desc,
                           (i | kk) != 0);
      else
        wgmma<P::HN, 1, 0>(acc, sw128_desc(a_addr + kk * 32, 16), b_desc,
                           (i | kk) != 0);
    }
    wgmma_commit();
    // this warpgroup's product of the previous tile has retired: its
    // leader releases that stage and refills its half of the K boxes; the
    // later of the two leaders also refills the A box, which both read
    wgmma_wait<1>();
    if (leader && i > 0 && i - 1 + P::STAGES < n_tiles) {
      __threadfence_block();
      const bool later = atomicAdd(&released[(i - 1) % P::STAGES], 1u) & 1u;
      __threadfence_block();
      if (P::SPLIT || later) load(i - 1 + P::STAGES, later);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
}

// this warpgroup's accumulators into out [rows, ld] f32 at (row0, col0).
// The fragment: rows r + 8ii (ii = 0, 1) of the 64, columns HN·wg + 8n +
// 2·(lane % 4) + j at register 4n + 2ii + j.  Every row is stored: a store
// of accumulators under a row test makes ptxas serialise the wgmmas
// (C7515), so the outputs are padded to whole 64-row tiles.
template <int CT>
__device__ __forceinline__ void mat_ring_store(float (&acc)[MatRing<CT>::ACC], float* out,
                                               int ld, int row0, int col0) {
  using P = MatRing<CT>;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = (tid % 128) / 32 * 16 + lane / 4;
  const int col = col0 + tid / 128 * P::HN + 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < P::HN / 8; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
      *reinterpret_cast<float2*>(
          &out[static_cast<size_t>(row0 + r + 8 * ii) * ld + col + 8 * n]) =
          make_float2(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
}

}  // namespace
