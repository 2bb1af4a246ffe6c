// Flash linear cross-entropy for Hopper (sm_90a): the forward (logsumexp and
// label logit), dh and dW/db, exported with a plain C interface and loaded
// through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ce.py:
// _fwd_kernel (:59), _dh_kernel (:134) and _dwdb_kernel (:159), called
// through fused_linear_ce.  The forward kernel and its merge launch live in
// fused_ce.cuh, and the mbarrier, TMA and wgmma primitives in hopper.cuh;
// the written-logits schedule (fused_ce_mat.cu) shares both.
//
//   S   = h @ W^T + b                      [M, V]  (never written)
//   lse = logsumexp_v S,    ll = S[label]
//   dl  = (exp(S - lse) - onehot(label)) * gw              f32
//   dh  = bf16(dl) @ W,     dW = bf16(dl)^T @ h,     db = sum over rows of dl
//
// h [M, H] and W [V, H] (the rnn_logits nn.Linear weight, read in that
// layout) in bf16, products accumulated in f32; b f32.  Padded vocab
// columns count as -1e30 in the forward and add nothing to the gradients;
// rows past M read zeros and carry gw = 0, so they add nothing.
//
// What bounds the backward on this card: tensor-core operations.  dh and
// dW/db each recompute the logits product and run a second one, 4·M·H·V
// = 724 GFLOP at the train shapes (M = 24 x 1280 = 30720, H = 512, V =
// 11500): 0.7316 ms each at the dense bf16 rate of 989 TFLOP/s.  (The
// flash schedule spends the recomputation so that the 707 MB of bf16
// logits are never written.)  The forward's product is half that.
//
// The backward: one kernel template, ce_bwd_kernel<H, DW>, for both
// gradients.  They are one computation with the roles of h and W swapped.
// A block keeps a resident tile Q of 64 rows of length H in shared memory
// and walks over a streamed operand K in tiles of 64 rows:
//
//   S   = Q @ K_tile^T                          [64 x 64], contract H
//   dl  = (exp(S + b - lse) - onehot(label)) * gw   f32, in registers
//   out += bf16(dl) @ K_tile                    [64 x H],  contract 64
//
//              dh (DW = false)              dW/db (DW = true)
//   Q          64 rows of h                 64 vocab rows of W
//   K          W, every vocab tile          h, a range of row tiles (split)
//   lse,gw,lab per Q row                    per K row (loaded per tile)
//   bias, <V   per K row (loaded per tile)  per Q row
//   extra      -                            db = row sums of the f32 dl
//
// * wgmma: both products are warpgroup MMAs from shared memory with f32
//   accumulators in registers.  One K tile feeds both: it is the K-major
//   B operand of S and the MN-major B operand of the second product.
// * TMA and mbarriers: K tiles stream through a ring of stages (2 at H =
//   512, 4 below) in 64-row x 64-column boxes with the 128-byte swizzle
//   that wgmma reads; a full barrier per stage counts the bytes in.  No
//   thread waits to refill: each warpgroup's second product reads only its
//   half of H, so its leader refills that half of a stage as soon as its
//   own product of the stage's tile retires (at H = 64, one box, thread 0
//   refills after the tile's barrier, STAGES - 1 tiles ahead).
// * Registers: two consumer warpgroups own the same 64 Q rows.  Each
//   computes half of S's 64 columns (m64n32) and owns half of H in the
//   output (m64n256 at H = 512: 128 accumulator registers a thread, no
//   spills under the 255-register cap of one block per SM).  Their bf16
//   dl halves meet in a swizzled 8 KB tile in shared memory (two of them,
//   alternating, so one named barrier per tile suffices) that is the A
//   operand of the second product.  db is summed from the f32 dl in
//   registers.
// * Overlap: a tile's second product is left in flight while the next
//   tile's S is issued.  What stays exposed is the dl step between the two
//   products (exp, bf16 stores, one barrier): both warpgroups need the
//   other's half of dl, and a third 64 KB stage, which would let the next
//   S run under it, does not fit beside Q at H = 512.
// * Ragged edges: TMA fills rows past M or V with zeros.  A vocab row past
//   V carries bias -inf, so p = 0 there without a branch: its dl meets
//   only the zero rows of W (dh) or lands in padded rows of dW and db that
//   are never summed out.  Rows past M carry gw = 0, and rows of weight 0
//   get dh exactly 0.
// * Determinism: no float atomics.  dW/db's row splits write [splits, Vp,
//   H] partials that a last launch sums in split order (db alike), so the
//   gradients repeat bit for bit.
//
// Shared memory at H = 512: Q 64 KB, two 64 KB stages, two 8 KB dl tiles
// (209 KB with alignment and barriers): one block per SM.  The forward,
// ce_fwd_kernel<BOXES, RG, RES, false>, is the wgmma + TMA template of
// fused_ce.cuh.
//
// Past H = 512, ce_bwd_wide_kernel<CT, DW>.  Neither a resident Q tile (128
// KB at H = 1024) beside a ring of K tiles (128 KB each) fits an SM's 227
// KB, nor the [64, H] output in two warpgroups' registers (m64n512 would
// take 256 accumulators a thread, past the cap of 255).  So:
// * Output column tiles: block (x, y, z) owns CT output columns (grid z;
//   CT = 512, m64n256 a warpgroup, as at H = 512; the rest of H past a
//   multiple of 512 in one launch each of 256, 128 and 64 columns).  Each
//   column tile recomputes all of S: at H = 1024 two tiles, 6·M·H·V
//   operations against the 4·M·H·V of one pass (1.5x).
// * S from streamed boxes: S [64 x 64] contracts H box by box, each stage
//   of a 4-stage ring holding a Q box and the K tile's box of the same 64
//   columns (16 KB; TMA, the 128-byte swizzle), so shared memory does not
//   grow with H.  The leaders count each stage's releases, and the later
//   refills it 4 boxes ahead, as row_ring.cuh does.  Q is read again from
//   L2 for every K tile.
// * The second product's operand, the K tile's CT output columns (64 KB
//   at CT = 512), is loaded on its own into one of two buffers (each
//   warpgroup's leader its half, once its product of the tile two back
//   retired), so a tile's loads run under the previous tile's work.
// * The dl step, the dl tiles, db and the split partials are the H <= 512
//   kernel's; db comes from the z = 0 blocks of the first launch only.
// Shared memory at CT = 512: the ring 64 KB, two 64 KB column buffers, two
// 8 KB dl tiles (209 KB with alignment and barriers), at any H.  It reads
// Q again and the K tile 2.5 times for every K tile and forms S once a
// column tile: at H = 1024 56.6 GB of L2 reads a launch, L2-bound at 11.3
// ms on the H100.
//
// At H = 1024 (the shape rule cluster_width; the other widths past 512
// keep ce_bwd_wide_kernel), ce_bwd_cluster_kernel<DW>: a thread-block
// cluster of two CTAs along the column axis, ce_bwd_kernel<512>'s loop
// with the contraction split between them.
// * CTA z holds columns [512z, 512z + 512) of its Q tile (resident, 64
//   KB) and of each K tile (a 2-stage ring of 64 KB parts), and owns
//   those output columns.  It forms its partial S [64 x 64] over its 512
//   columns and sends it to the other CTA's shared memory (st.async, 16
//   bytes a store, completing on the receiver's mbarrier); each CTA adds
//   the two partials (a + b = b + a: both hold the same S bit for bit)
//   and forms the same dl, then multiplies it by the K columns it already
//   holds.  S is formed once (4·M·H·V operations, as the bound counts) and
//   each K byte read from L2 once a cluster: 11.4 GB a launch.
// * The exchange needs no cluster barrier per tile: the receiver's buffer
//   is single, its full barrier expects 16 KB a phase (the receiver's own
//   arrival set after it read the last partial), and a free barrier that
//   the receiver arrives on remotely lets the sender write the next one.
//   One cluster barrier after the barriers' set-up; no remote access
//   outlives the loop.  What stays exposed is the exchange's latency
//   between S and the second product (0.7 ms of 3.6 at the train shapes:
//   a third K part, which would let the next S run under it, does not
//   fit: 230.7 of 232.4 KB used).
// * Clusters of 2 Q tiles x 2 halves, each K part multicast by TMA to
//   both Q tiles, halve the K bytes but ran 1.4x slower (30 clusters of
//   four fit, 120 SMs, and each refill waits for the other Q tile's
//   release); kernel_designs.py builds and times them, the kernel does not.
// * The card must place a cluster at one block an SM
//   (cudaOccupancyMaxActiveClusters; 66 on the H100): where it cannot,
//   the launch returns ERR_CLUSTER and the wrappers raise ClusterError.

#include "fused_ce.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------
// the backward template
// ---------------------------------------------------------------------

constexpr int BWD_THREADS = 256;        // two consumer warpgroups

template <int H>
struct Bwd {
  static constexpr int BOXES = H / BOX;               // boxes per row tile
  static constexpr int TILE = BT * H * 2;             // bytes of a row tile
  static constexpr int STAGES = H == 512 ? 2 : 4;     // K tiles in flight
  static constexpr int HN = H / 2;                    // output columns per warpgroup
  static constexpr int ACC = HN / 2;                  // their f32 registers per thread
  // 1 KB to align the tiles to the swizzle's 1024-byte period; Q, the ring,
  // two dl tiles, db's exchange, the full barriers and Q's
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(TILE) * (1 + STAGES) +
                                 2 * BOX_BYTES + BT * sizeof(float) +
                                 (STAGES + 1) * sizeof(uint64_t);
  // at H >= 128 a K tile is loaded by two threads, one box half each
  static constexpr bool SPLIT = BOXES >= 2;
};

// the logit's gradient, as the TPU kernels form it: (p - onehot) * gw
__device__ __forceinline__ float dlogit(float s, float bias, float lse, int col,
                                        int label, float gw) {
  const float p = expf(s + bias - lse);
  return (p - (col == label ? 1.0f : 0.0f)) * gw;
}

// Grid (Q tiles, K ranges).  Block (x, y) owns Q rows [64x, 64x + 64) and
// K tiles [y·per, min(k_tiles, (y + 1)·per)).
//   DW = false: Q = h, K = W; out = dh [64·gridDim.x, H].
//   DW = true:  Q = W, K = h; out = dw_part [gridDim.y, 64·gridDim.x, H],
//               db_part [gridDim.y, 64·gridDim.x].
template <int H, bool DW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ce_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const float* __restrict__ b, const int* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ gw,
              float* __restrict__ out, float* __restrict__ db_part, int M,
              int V, int k_tiles, int per) {
  using P = Bwd<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + P::TILE;
  unsigned char* dl_s = k_s + P::STAGES * P::TILE;
  float* db_s = reinterpret_cast<float*>(dl_s + 2 * BOX_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(db_s + BT);
  uint64_t* q_bar = full + P::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BT;
  const int t0 = blockIdx.y * per;
  const int n_tiles = max(0, min(k_tiles, t0 + per) - t0);

  // K tile t0 + i into stage i % STAGES.  At H >= 128 each warpgroup's
  // leader loads the half of the boxes that only its own second product
  // reads, so it refills that half as soon as its own product retires; at
  // H = 64 thread 0 loads the one box.
  const bool loader = P::SPLIT ? tid % 128 == 0 : tid == 0;
  auto load_tile = [&](int i) {
    const int s = i % P::STAGES;
    unsigned char* dst = k_s + s * P::TILE;
    const int row = (t0 + i) * BT;
    if constexpr (!P::SPLIT) load_boxes<0, 1>(dst, &k_map, &full[s], row);
    else if (wg == 0) load_boxes<0, P::BOXES / 2>(dst, &k_map, &full[s], row);
    else load_boxes<P::BOXES / 2, P::BOXES>(dst, &k_map, &full[s], row);
  };
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) mbar_init(&full[s], P::SPLIT ? 2 : 1);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) load_boxes<0, P::BOXES>(q_s, &q_map, q_bar, q0);
  if (loader)
    for (int i = 0; i < min(P::STAGES, n_tiles); ++i) load_tile(i);

  // This thread's accumulator fragment: rows r + 8i (i = 0, 1) of the 64;
  // S columns sc(n, j) = 32·wg + 8n + 2·(lane % 4) + j (n < 4, j < 2) at
  // register 4n + 2i + j; output columns HN·wg + 8n + 2·(lane % 4) + j (n
  // < HN / 8) likewise.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // per-Q-row operands: dh: lse, gw, label of h rows; dW: the bias of
  // vocab rows, -inf past V (p = 0 there: those rows of dW and db are
  // never summed out)
  float q_lse[2], q_gw[2], q_bias[2];
  int q_lab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + r + 8 * i;
    if constexpr (DW) {
      q_bias[i] = n < V ? b[n] : -INFINITY;
    } else {
      const bool in = n < M;
      q_lse[i] = in ? lse[n] : 0.0f;
      q_gw[i] = in ? gw[n] : 0.0f;
      q_lab[i] = in ? labels[n] : -1;
    }
  }

  const uint32_t q_addr = smem_addr(q_s);
  const uint32_t k_addr = smem_addr(k_s);
  const uint32_t dl_addr = smem_addr(dl_s);
  // this warpgroup's output columns in a K tile: their box, bytes within it
  const uint32_t out_cols = (wg * P::HN / BOX) * BOX_BYTES + (wg * P::HN % BOX) * 2;

  float acc[P::ACC];
#pragma unroll
  for (int e = 0; e < P::ACC; ++e) acc[e] = 0.0f;
  float db_run[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % P::STAGES;
    const int k0 = (t0 + i) * BT;        // the tile's first K row
    const uint32_t stage = k_addr + s * P::TILE;
    mbar_wait(&full[s], (i / P::STAGES) & 1);

    // S [64 x 32] = Q @ (K rows 32·wg .. 32·wg + 31)^T, contracting H
    float sacc[16];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < P::BOXES; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<32, 0>(sacc, sw128_desc(q_addr + c * BOX_BYTES + kk * 32, 16),
                     sw128_desc(stage + c * BOX_BYTES + wg * 4096 + kk * 32, 16),
                     (c | kk) != 0);
    wgmma_commit();

    // per-K-row operands of this thread's 8 S columns, loaded while S runs:
    // dh: the bias of vocab rows, -inf past V (p = 0 there, and dl only
    // meets the zero rows TMA filled in); dW: lse, gw, label of h rows
    float k_bias[8], k_lse[8], k_gw[8];
    int k_lab[8];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + 32 * wg + 8 * n + cq + j;
        if constexpr (DW) {
          const bool in = col < M;
          k_lse[2 * n + j] = in ? lse[col] : 0.0f;
          k_gw[2 * n + j] = in ? gw[col] : 0.0f;
          k_lab[2 * n + j] = in ? labels[col] : -1;
        } else {
          k_bias[2 * n + j] = col < V ? b[col] : -INFINITY;
        }
      }

    if (i > 0) {
      // this warpgroup's second product of the previous tile has retired:
      // refill the half of its stage that the product read (S of that tile
      // retired in both warpgroups before the tile's barrier)
      wgmma_wait<1>();
      if (P::SPLIT && loader && i - 1 + P::STAGES < n_tiles) load_tile(i - 1 + P::STAGES);
    }
    wgmma_wait<0>();
    reg_fence(sacc);

    // dl in f32 (db), rounded to bf16 into this tile's swizzled dl buffer;
    // no branch: the padded vocab rows carry bias -inf.  dh compares a Q
    // row's label with the column's offset from this thread's first one.
    unsigned char* dl_buf = dl_s + (i & 1) * BOX_BYTES;
    const int col0 = k0 + 32 * wg + cq;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = r + 8 * ii;
        float d[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * ii + j;
          const int kc = 2 * n + j;
          if constexpr (DW) {
            d[j] = dlogit(sacc[e], q_bias[ii], k_lse[kc], q0 + row, k_lab[kc],
                          k_gw[kc]);
            db_run[ii] += d[j];
          } else {
            d[j] = dlogit(sacc[e], k_bias[kc], q_lse[ii], 8 * n + j,
                          q_lab[ii] - col0, q_gw[ii]);
          }
        }
        const int chunk = (4 * wg + n) ^ (row & 7);
        *reinterpret_cast<__nv_bfloat162*>(dl_buf + row * 128 + chunk * 16 + cq * 2) =
            __floats2bfloat162_rn(d[0], d[1]);
      }
    // the dl tile is read by wgmma (the async proxy) after both halves land
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(BWD_THREADS) : "memory");
    // at H = 64 both second products of tile i - 1 read the one box: it is
    // free once both warpgroups passed this barrier (STAGES - 1 tiles ahead)
    if (!P::SPLIT && loader && i > 0 && i - 1 + P::STAGES < n_tiles)
      load_tile(i - 1 + P::STAGES);

    // out [64 x HN] += dl16 [64 x 64] @ K_tile [64 x (this warpgroup's HN)]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<P::HN, 1>(acc, sw128_desc(dl_addr + (i & 1) * BOX_BYTES + kk * 32, 16),
                      sw128_desc(stage + out_cols + kk * 16 * 128, BOX_BYTES), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // the [64, H] f32 block of dh, or of this split's dW partial
  const int Qp = gridDim.x * BT;
  float* o = out + (DW ? static_cast<size_t>(blockIdx.y) * Qp * H : 0);
#pragma unroll
  for (int n = 0; n < P::HN / 8; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = q0 + r + 8 * ii;
      const int col = wg * P::HN + 8 * n + cq;
      *reinterpret_cast<float2*>(&o[static_cast<size_t>(row) * H + col]) =
          make_float2(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
    }
  if constexpr (DW) {
    // db: the 4 lanes of a row, then warpgroup 0's half + warpgroup 1's
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      db_run[ii] += __shfl_xor_sync(0xffffffffu, db_run[ii], 1);
      db_run[ii] += __shfl_xor_sync(0xffffffffu, db_run[ii], 2);
    }
    if (wg == 1 && lane % 4 == 0) {
      db_s[r] = db_run[0];
      db_s[r + 8] = db_run[1];
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(BWD_THREADS) : "memory");
    if (wg == 0 && lane % 4 == 0) {
      float* dbo = db_part + static_cast<size_t>(blockIdx.y) * Qp + q0;
      dbo[r] = db_run[0] + db_s[r];
      dbo[r + 8] = db_run[1] + db_s[r + 8];
    }
  }
}

// ---------------------------------------------------------------------
// the backward past H = 512: output column tiles, S from streamed boxes
// ---------------------------------------------------------------------

constexpr int WIDE_STAGES = 4;          // (Q box, K box) pairs of S in flight
constexpr int WIDE_PAIR = 2 * BOX_BYTES;  // a stage: 16 KB

template <int CT>
struct BwdWide {
  static constexpr int KEEP_BOXES = CT / BOX;         // boxes of a K tile's CT columns
  static constexpr int KEEP = KEEP_BOXES * BOX_BYTES;  // bytes of them
  static constexpr int HN = CT / 2;                    // output columns per warpgroup
  static constexpr int ACC = HN / 2;                   // their f32 registers per thread
  // at CT >= 128 the column boxes are loaded by two threads, one half each
  static constexpr bool SPLIT = KEEP_BOXES >= 2;
  // 1 KB to align to the swizzle's 1024-byte period; the ring, two column
  // buffers, two dl tiles, db's exchange, the full barriers (ring and
  // column buffers) and the release counters
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(WIDE_STAGES) * WIDE_PAIR +
                                 2 * KEEP + 2 * BOX_BYTES + BT * sizeof(float) +
                                 (WIDE_STAGES + 2) * sizeof(uint64_t) +
                                 WIDE_STAGES * sizeof(uint32_t);
  static_assert(SMEM <= SMEM_MAX, "one block per SM: 227 KB of shared memory");
};

// Grid (Q tiles, K ranges, column tiles).  Block (x, y, z) owns Q rows [64x,
// 64x + 64), K tiles [y·per, min(k_tiles, (y + 1)·per)) and output columns
// [e_base + CT·z, e_base + CT·(z + 1)) of H.
//   DW = false: Q = h, K = W; out = dh [64·gridDim.x, H].
//   DW = true:  Q = W, K = h; out = dw_part [gridDim.y, 64·gridDim.x, H],
//               db_part [gridDim.y, 64·gridDim.x] (written by the z = 0
//               blocks where db_part is not null).
template <int CT, bool DW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ce_bwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const float* __restrict__ b, const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ gw,
                   float* __restrict__ out, float* __restrict__ db_part, int M,
                   int V, int H, int k_tiles, int per, int e_base) {
  using P = BwdWide<CT>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = base;
  unsigned char* keep = ring + WIDE_STAGES * WIDE_PAIR;
  unsigned char* dl_s = keep + 2 * P::KEEP;
  float* db_s = reinterpret_cast<float*>(dl_s + 2 * BOX_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(db_s + BT);
  uint64_t* keep_full = full + WIDE_STAGES;
  uint32_t* released = reinterpret_cast<uint32_t*>(keep_full + 2);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int q0 = blockIdx.x * BT;
  const int t0 = blockIdx.y * per;
  const int n_tiles = max(0, min(k_tiles, t0 + per) - t0);
  const int e0 = e_base + blockIdx.z * CT;   // the block's first output column
  const int nb = H / BOX;                    // boxes of S's contraction
  const int total = n_tiles * nb;            // stream j: tile j / nb, box j % nb

  // box j of S's stream into stage j % WIDE_STAGES: Q's and the K tile's
  // box of the same 64 columns
  auto load_pair = [&](int j) {
    const int s = j % WIDE_STAGES;
    unsigned char* st = ring + s * WIDE_PAIR;
    const int x = (j % nb) * BOX;
    mbar_expect_tx(&full[s], WIDE_PAIR);
    tma_load(st, &q_map, &full[s], x, q0);
    tma_load(st + BOX_BYTES, &k_map, &full[s], x, (t0 + j / nb) * BT);
  };
  // the CT output columns of K tile t0 + i into buffer i & 1: this
  // warpgroup's half (at CT = 64 thread 0 loads the one box)
  auto load_keep = [&](int i) {
    unsigned char* dst = keep + (i & 1) * P::KEEP;
    uint64_t* bar = &keep_full[i & 1];
    const int row = (t0 + i) * BT;
    constexpr int NB = P::SPLIT ? P::KEEP_BOXES / 2 : 1;
    const int c0 = P::SPLIT ? wg * NB : 0;
    mbar_expect_tx(bar, NB * BOX_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load(dst + (c0 + c) * BOX_BYTES, &k_map, bar, e0 + (c0 + c) * BOX, row);
  };
  // this warpgroup's wgmmas of stream box j retired: the later of the two
  // leaders refills its stage WIDE_STAGES boxes ahead
  auto release = [&](int j) {
    if (!leader) return;
    const int s = j % WIDE_STAGES;
    __threadfence_block();
    const bool later = atomicAdd(&released[s], 1u) & 1u;
    __threadfence_block();
    if (later && j + WIDE_STAGES < total) load_pair(j + WIDE_STAGES);
  };
  if (tid == 0) {
    for (int s = 0; s < WIDE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    for (int k = 0; k < 2; ++k) mbar_init(&keep_full[k], P::SPLIT ? 2 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(WIDE_STAGES, total); ++j) load_pair(j);
  if (P::SPLIT ? leader : tid == 0)
    for (int i = 0; i < min(2, n_tiles); ++i) load_keep(i);

  // This thread's accumulator fragment: rows r + 8i (i = 0, 1) of the 64;
  // S columns 32·wg + 8n + 2·(lane % 4) + j (n < 4, j < 2) at register 4n
  // + 2i + j; output columns e0 + HN·wg + 8n + 2·(lane % 4) + j (n < HN /
  // 8) likewise.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // per-Q-row operands: dh: lse, gw, label of h rows; dW: the bias of
  // vocab rows, -inf past V
  float q_lse[2], q_gw[2], q_bias[2];
  int q_lab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + r + 8 * i;
    if constexpr (DW) {
      q_bias[i] = n < V ? b[n] : -INFINITY;
    } else {
      const bool in = n < M;
      q_lse[i] = in ? lse[n] : 0.0f;
      q_gw[i] = in ? gw[n] : 0.0f;
      q_lab[i] = in ? labels[n] : -1;
    }
  }

  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t keep_addr = smem_addr(keep);
  const uint32_t dl_addr = smem_addr(dl_s);
  // this warpgroup's output columns in a column buffer: their box, bytes
  // within it
  const uint32_t out_cols = (wg * P::HN / BOX) * BOX_BYTES + (wg * P::HN % BOX) * 2;

  // the first second product (tile 0, k16 step 0) overwrites acc (scale_d
  // 0), as mat_ring.cuh's does, so the launches give no block an empty K
  // range
  float acc[P::ACC];
  float db_run[2] = {0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t0 + i) * BT;        // the tile's first K row
    // per-K-row operands of this thread's 8 S columns, requested before
    // S: dh: the bias of vocab rows, -inf past V; dW: lse, gw, label of h
    // rows
    float k_bias[8], k_lse[8], k_gw[8];
    int k_lab[8];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + 32 * wg + 8 * n + cq + j;
        if constexpr (DW) {
          const bool in = col < M;
          k_lse[2 * n + j] = in ? lse[col] : 0.0f;
          k_gw[2 * n + j] = in ? gw[col] : 0.0f;
          k_lab[2 * n + j] = in ? labels[col] : -1;
        } else {
          k_bias[2 * n + j] = col < V ? b[col] : -INFINITY;
        }
      }

    // S [64 x 32] = Q @ (K rows 32·wg .. 32·wg + 31)^T, contracting H box
    // by box from the ring
    float sacc[16];
    for (int c = 0; c < nb; ++c) {
      const int j = i * nb + c;
      const int s = j % WIDE_STAGES;
      mbar_wait(&full[s], (j / WIDE_STAGES) & 1);
      const uint32_t st = ring_addr + s * WIDE_PAIR;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<32, 0>(sacc, sw128_desc(st + kk * 32, 16),
                     sw128_desc(st + BOX_BYTES + wg * 4096 + kk * 32, 16), (c | kk) != 0);
      wgmma_commit();
      // the group before this one has retired: at c = 0 this warpgroup's
      // second product of tile i - 1, whose half of its column buffer then
      // takes tile i + 1; else S's box c - 1, whose stage is released
      wgmma_wait<1>();
      if (c > 0) release(j - 1);
      else if (P::SPLIT && leader && i > 0 && i + 1 < n_tiles) load_keep(i + 1);
    }
    wgmma_wait<0>();
    reg_fence(sacc);
    release(i * nb + nb - 1);

    // dl in f32 (db), rounded to bf16 into this tile's swizzled dl buffer,
    // as ce_bwd_kernel forms it
    unsigned char* dl_buf = dl_s + (i & 1) * BOX_BYTES;
    const int col0 = k0 + 32 * wg + cq;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = r + 8 * ii;
        float d[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * ii + j;
          const int kc = 2 * n + j;
          if constexpr (DW) {
            d[j] = dlogit(sacc[e], q_bias[ii], k_lse[kc], q0 + row, k_lab[kc],
                          k_gw[kc]);
            db_run[ii] += d[j];
          } else {
            d[j] = dlogit(sacc[e], k_bias[kc], q_lse[ii], 8 * n + j,
                          q_lab[ii] - col0, q_gw[ii]);
          }
        }
        const int chunk = (4 * wg + n) ^ (row & 7);
        *reinterpret_cast<__nv_bfloat162*>(dl_buf + row * 128 + chunk * 16 + cq * 2) =
            __floats2bfloat162_rn(d[0], d[1]);
      }
    // the dl tile is read by wgmma (the async proxy) after both halves land
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(BWD_THREADS) : "memory");
    // at CT = 64 both second products of tile i - 1 read the one column box:
    // it is free once both warpgroups passed this barrier
    if (!P::SPLIT && tid == 0 && i > 0 && i + 1 < n_tiles) load_keep(i + 1);

    // out [64 x HN] += dl16 [64 x 64] @ K_tile [64 x (this warpgroup's HN)]
    mbar_wait(&keep_full[i & 1], (i >> 1) & 1);
    const uint32_t kb = keep_addr + (i & 1) * P::KEEP;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<P::HN, 1>(acc, sw128_desc(dl_addr + (i & 1) * BOX_BYTES + kk * 32, 16),
                      sw128_desc(kb + out_cols + kk * 16 * 128, BOX_BYTES), (i | kk) != 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // the [64, CT] f32 block of dh, or of this split's dW partial
  const int Qp = gridDim.x * BT;
  float* o = out + (DW ? static_cast<size_t>(blockIdx.y) * Qp * H : 0);
#pragma unroll
  for (int n = 0; n < P::HN / 8; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = q0 + r + 8 * ii;
      const int col = e0 + wg * P::HN + 8 * n + cq;
      *reinterpret_cast<float2*>(&o[static_cast<size_t>(row) * H + col]) =
          make_float2(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
    }
  if constexpr (DW) {
    if (db_part == nullptr || blockIdx.z != 0) return;
    // db: the 4 lanes of a row, then warpgroup 0's half + warpgroup 1's
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      db_run[ii] += __shfl_xor_sync(0xffffffffu, db_run[ii], 1);
      db_run[ii] += __shfl_xor_sync(0xffffffffu, db_run[ii], 2);
    }
    if (wg == 1 && lane % 4 == 0) {
      db_s[r] = db_run[0];
      db_s[r + 8] = db_run[1];
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(BWD_THREADS) : "memory");
    if (wg == 0 && lane % 4 == 0) {
      float* dbo = db_part + static_cast<size_t>(blockIdx.y) * Qp + q0;
      dbo[r] = db_run[0] + db_s[r];
      dbo[r + 8] = db_run[1] + db_s[r + 8];
    }
  }
}

// ---------------------------------------------------------------------
// the backward at H = 1024: a cluster of two CTAs, one a half of H
// ---------------------------------------------------------------------

constexpr int CLUSTER = 2;                        // column halves of a cluster (grid z)
constexpr int CLUSTER_CT = 512;                   // the columns of H a CTA holds
constexpr int CLUSTER_H = CLUSTER * CLUSTER_CT;   // the width the cluster takes

// The shape rule past 512: the widths ce_bwd_cluster_kernel takes.  Each
// further CTA would add a 16 KB partial to every CTA's exchange buffer,
// which at 1536 and beyond no longer fits beside the Q part and two K parts;
// those widths take ce_bwd_wide_kernel.
__host__ __device__ constexpr bool cluster_width(int H) { return H == CLUSTER_H; }

struct BwdCluster {
  static constexpr int BOXES = CLUSTER_CT / BOX;    // boxes of a part's row
  static constexpr int PART = BT * CLUSTER_CT * 2;  // 64 KB: 64 rows x 512 columns
  static constexpr int STAGES = 2;                  // K parts in flight
  static constexpr int HN = CLUSTER_CT / 2;         // output columns per warpgroup
  static constexpr int ACC = HN / 2;                // their f32 registers per thread
  static constexpr int XCH = BWD_THREADS * 16 * sizeof(float);  // 16 KB: a partial S
  // 1 KB to align to the swizzle's period; the Q part, the K ring, two dl
  // tiles, the peer's partial S, db's exchange, the full barriers, Q's, and
  // the exchange's full and free barriers
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(PART) * (1 + STAGES) +
                                 2 * BOX_BYTES + XCH + BT * sizeof(float) +
                                 (STAGES + 3) * sizeof(uint64_t);
  static_assert(SMEM <= SMEM_MAX, "one block per SM: 227 KB of shared memory");
};

// Grid (Q tiles, K ranges, CLUSTER), clusters of (1, 1, CLUSTER).  CTA
// (x, y, z), rank z in its cluster, holds columns [512z, 512z + 512) of Q
// rows [64x, 64x + 64) and of K tiles [y·per, min(k_tiles, (y + 1)·per)),
// and owns those output columns.
//   DW = false: Q = h, K = W; out = dh [64·q_tiles, H].
//   DW = true:  Q = W, K = h; out = dw_part [gridDim.y, 64·q_tiles, H],
//               db_part [gridDim.y, 64·q_tiles] (from the z = 0 CTAs).
template <bool DW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ce_bwd_cluster_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const float* __restrict__ b, const int* __restrict__ labels,
                      const float* __restrict__ lse, const float* __restrict__ gw,
                      float* __restrict__ out, float* __restrict__ db_part, int M,
                      int V, int k_tiles, int per, int q_tiles) {
  using P = BwdCluster;
  constexpr int H = CLUSTER_H;
  // the same offsets in every CTA: the peer's buffers are this CTA's mapped
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + P::PART;
  unsigned char* dl_s = k_s + P::STAGES * P::PART;
  float* xch = reinterpret_cast<float*>(dl_s + 2 * BOX_BYTES);
  float* db_s = xch + P::XCH / sizeof(float);
  uint64_t* full = reinterpret_cast<uint64_t*>(db_s + BT);
  uint64_t* q_bar = full + P::STAGES;
  uint64_t* xch_full = q_bar + 1;   // the peer's partial of this tile is in xch
  uint64_t* xch_free = xch_full + 1;  // the peer has read this CTA's last partial

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const uint32_t rank = cluster_ctarank();
  const int e0 = rank * CLUSTER_CT;   // this CTA's first column of H
  const int q0 = blockIdx.x * BT;
  const int t0 = blockIdx.y * per;
  const int n_tiles = max(0, min(k_tiles, t0 + per) - t0);
  // the peer: the other column half of these Q rows
  const uint32_t peer = rank ^ 1;
  const uint32_t peer_xch = cluster_map(smem_addr(xch), peer);
  const uint32_t peer_full = cluster_map(smem_addr(xch_full), peer);
  const uint32_t peer_free = cluster_map(smem_addr(xch_free), peer);

  // this CTA's part of K tile t0 + i into stage i % STAGES: each
  // warpgroup's leader the half of the boxes that its second product reads
  auto load_tile = [&](int i) {
    const int s = i % P::STAGES;
    unsigned char* dst = k_s + s * P::PART;
    const int row = (t0 + i) * BT;
    if (wg == 0) load_boxes<0, P::BOXES / 2>(dst, &k_map, &full[s], row, e0);
    else load_boxes<P::BOXES / 2, P::BOXES>(dst, &k_map, &full[s], row, e0);
  };
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) mbar_init(&full[s], 2);
    mbar_init(q_bar, 1);
    mbar_init(xch_full, 1);
    mbar_init(xch_free, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // xch_full's phase i: this thread's arrival and the peer's 16 KB
    mbar_expect_tx(xch_full, P::XCH);
  }
  // both CTAs' barriers are set up before either reaches the other's
  cluster_arrive();
  cluster_wait();
  if (tid == 0) load_boxes<0, P::BOXES>(q_s, &q_map, q_bar, q0, e0);
  if (leader)
    for (int i = 0; i < min(P::STAGES, n_tiles); ++i) load_tile(i);

  // This thread's accumulator fragment: rows r + 8i (i = 0, 1) of the 64;
  // S columns 32·wg + 8n + 2·(lane % 4) + j (n < 4, j < 2) at register 4n
  // + 2i + j; output columns e0 + HN·wg + 8n + 2·(lane % 4) + j (n < HN /
  // 8) likewise.  The peer's thread of the same index holds the same
  // positions of its partial S.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float q_lse[2], q_gw[2], q_bias[2];
  int q_lab[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = q0 + r + 8 * i;
    if constexpr (DW) {
      q_bias[i] = n < V ? b[n] : -INFINITY;
    } else {
      const bool in = n < M;
      q_lse[i] = in ? lse[n] : 0.0f;
      q_gw[i] = in ? gw[n] : 0.0f;
      q_lab[i] = in ? labels[n] : -1;
    }
  }

  const uint32_t q_addr = smem_addr(q_s);
  const uint32_t k_addr = smem_addr(k_s);
  const uint32_t dl_addr = smem_addr(dl_s);
  // this warpgroup's output columns in a K part: boxes 4·wg ..
  const uint32_t out_cols = wg * (P::HN / BOX) * BOX_BYTES;

  // the first second product (tile 0, k16 step 0) overwrites acc (scale_d 0)
  float acc[P::ACC];
  float db_run[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % P::STAGES;
    const int k0 = (t0 + i) * BT;        // the tile's first K row
    const uint32_t stage = k_addr + s * P::PART;
    mbar_wait(&full[s], (i / P::STAGES) & 1);

    // this CTA's partial S [64 x 32] = Q part @ (K part rows 32·wg ..)^T,
    // contracting its 512 columns
    float sacc[16];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < P::BOXES; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<32, 0>(sacc, sw128_desc(q_addr + c * BOX_BYTES + kk * 32, 16),
                     sw128_desc(stage + c * BOX_BYTES + wg * 4096 + kk * 32, 16),
                     (c | kk) != 0);
    wgmma_commit();

    // per-K-row operands of this thread's 8 S columns, loaded while S runs
    float k_bias[8], k_lse[8], k_gw[8];
    int k_lab[8];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + 32 * wg + 8 * n + cq + j;
        if constexpr (DW) {
          const bool in = col < M;
          k_lse[2 * n + j] = in ? lse[col] : 0.0f;
          k_gw[2 * n + j] = in ? gw[col] : 0.0f;
          k_lab[2 * n + j] = in ? labels[col] : -1;
        } else {
          k_bias[2 * n + j] = col < V ? b[col] : -INFINITY;
        }
      }

    if (i > 0) {
      // this warpgroup's second product of the previous tile has retired:
      // refill the half of its stage that the product read
      wgmma_wait<1>();
      if (leader && i - 1 + P::STAGES < n_tiles) load_tile(i - 1 + P::STAGES);
    }
    wgmma_wait<0>();
    reg_fence(sacc);

    // The exchange: this thread's 16 partial sums into the peer's xch
    // (once the peer has read the last ones), the peer's out of this CTA's.
    // Each CTA adds the two in the same order (a + b = b + a in IEEE), so
    // both hold the same S and form the same dl.  Laid out as 16-byte
    // columns of 256 threads, so a warp's stores and loads are contiguous.
    if (i > 0) mbar_wait<true>(xch_free, (i - 1) & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st_async(peer_xch + (c * BWD_THREADS + tid) * 16,
               make_float4(sacc[4 * c], sacc[4 * c + 1], sacc[4 * c + 2], sacc[4 * c + 3]),
               peer_full);
    mbar_wait<true>(xch_full, i & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(xch)[c * BWD_THREADS + tid];
      sacc[4 * c] += v.x;
      sacc[4 * c + 1] += v.y;
      sacc[4 * c + 2] += v.z;
      sacc[4 * c + 3] += v.w;
    }

    // dl in f32 (db), rounded to bf16 into this tile's swizzled dl buffer,
    // as ce_bwd_kernel forms it
    unsigned char* dl_buf = dl_s + (i & 1) * BOX_BYTES;
    const int col0 = k0 + 32 * wg + cq;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = r + 8 * ii;
        float d[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * ii + j;
          const int kc = 2 * n + j;
          if constexpr (DW) {
            d[j] = dlogit(sacc[e], q_bias[ii], k_lse[kc], q0 + row, k_lab[kc],
                          k_gw[kc]);
            db_run[ii] += d[j];
          } else {
            d[j] = dlogit(sacc[e], k_bias[kc], q_lse[ii], 8 * n + j,
                          q_lab[ii] - col0, q_gw[ii]);
          }
        }
        const int chunk = (4 * wg + n) ^ (row & 7);
        *reinterpret_cast<__nv_bfloat162*>(dl_buf + row * 128 + chunk * 16 + cq * 2) =
            __floats2bfloat162_rn(d[0], d[1]);
      }
    // the dl tile is read by wgmma (the async proxy) after both halves land
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(BWD_THREADS) : "memory");
    // every thread has read the peer's partial: expect the next one, and
    // let the peer send it
    if (tid == 0 && i + 1 < n_tiles) {
      mbar_expect_tx(xch_full, P::XCH);
      mbar_arrive_remote(peer_free);
    }

    // out [64 x HN] += dl16 [64 x 64] @ K part [64 x (this warpgroup's HN)]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<P::HN, 1>(acc, sw128_desc(dl_addr + (i & 1) * BOX_BYTES + kk * 32, 16),
                      sw128_desc(stage + out_cols + kk * 16 * 128, BOX_BYTES), (i | kk) != 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  reg_fence(acc);
  // Nothing reaches this CTA's shared memory from the cluster any more:
  // every partial and release sent to it was waited for in the loop.

  // the [64, 512] f32 block of dh, or of this split's dW partial
  const int Qp = q_tiles * BT;
  float* o = out + (DW ? static_cast<size_t>(blockIdx.y) * Qp * H : 0);
#pragma unroll
  for (int n = 0; n < P::HN / 8; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = q0 + r + 8 * ii;
      const int col = e0 + wg * P::HN + 8 * n + cq;
      *reinterpret_cast<float2*>(&o[static_cast<size_t>(row) * H + col]) =
          make_float2(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
    }
  if constexpr (DW) {
    if (blockIdx.z != 0) return;
    // db: the 4 lanes of a row, then warpgroup 0's half + warpgroup 1's
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      db_run[ii] += __shfl_xor_sync(0xffffffffu, db_run[ii], 1);
      db_run[ii] += __shfl_xor_sync(0xffffffffu, db_run[ii], 2);
    }
    if (wg == 1 && lane % 4 == 0) {
      db_s[r] = db_run[0];
      db_s[r + 8] = db_run[1];
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(BWD_THREADS) : "memory");
    if (wg == 0 && lane % 4 == 0) {
      float* dbo = db_part + static_cast<size_t>(blockIdx.y) * Qp + q0;
      dbo[r] = db_run[0] + db_s[r];
      dbo[r + 8] = db_run[1] + db_s[r + 8];
    }
  }
}

// ---------------------------------------------------------------------
// host side: launches
// ---------------------------------------------------------------------

// Q [q_rows, H] resident, K [k_rows, H] streamed; grid (ceil(q_rows / 64),
// splits), each block over `per` K tiles
template <int H, bool DW>
int launch_bwd(const bf16* q, int q_rows, const bf16* k, int k_rows,
               const float* b, const int* labels, const float* lse,
               const float* gw, float* out, float* db_part, int M, int V,
               int splits, int per, cudaStream_t st) {
  CUtensorMap q_map, k_map;
  int err = row_tile_map(&q_map, q, q_rows, H);
  if (err) return err;
  err = row_tile_map(&k_map, k, k_rows, H);
  if (err) return err;
  constexpr size_t smem = Bwd<H>::SMEM;
  err = allow_smem(ce_bwd_kernel<H, DW>, smem);
  if (err) return err;
  const dim3 grid((q_rows + BT - 1) / BT, splits);
  ce_bwd_kernel<H, DW><<<grid, BWD_THREADS, smem, st>>>(
      q_map, k_map, b, labels, lse, gw, out, db_part, M, V,
      (k_rows + BT - 1) / BT, per);
  return static_cast<int>(cudaGetLastError());
}

// one launch of ce_bwd_wide_kernel<CT, DW> over `tiles` column tiles from
// column e_base
template <int CT, bool DW>
int launch_wide(const CUtensorMap& q_map, const CUtensorMap& k_map, int q_rows,
                int k_rows, const float* b, const int* labels, const float* lse,
                const float* gw, float* out, float* db_part, int M, int V, int H,
                int splits, int per, int tiles, int e_base, cudaStream_t st) {
  constexpr size_t smem = BwdWide<CT>::SMEM;
  int err = allow_smem(ce_bwd_wide_kernel<CT, DW>, smem);
  if (err) return err;
  const dim3 grid((q_rows + BT - 1) / BT, splits, tiles);
  ce_bwd_wide_kernel<CT, DW><<<grid, BWD_THREADS, smem, st>>>(
      q_map, k_map, b, labels, lse, gw, out, db_part, M, V, H,
      (k_rows + BT - 1) / BT, per, e_base);
  return static_cast<int>(cudaGetLastError());
}

// launches of ce_bwd_cluster_kernel (dh and dW/db) in this process: the card
// tests read it to see which instance ran
int cluster_launches = 0;

// the clusters of ce_bwd_cluster_kernel<DW> the card holds at once
// (two CTAs of BwdCluster::SMEM on neighbouring SMs; ERR_CLUSTER where
// none fits), asked once a device; < 0: -cudaError_t
template <bool DW>
int cluster_slots(const cudaLaunchConfig_t& cfg) {
  static HeldClusters cache;
  return held_clusters(ce_bwd_cluster_kernel<DW>, cfg, cache);
}

// the launch configuration of ce_bwd_cluster_kernel over q_tiles Q tiles
// and `splits` K ranges
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int q_tiles, int splits,
                                  cudaStream_t st) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = CLUSTER;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(q_tiles, splits, CLUSTER);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = BwdCluster::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Q [q_rows, 1024] and K [k_rows, 1024]; clusters of (1, 1, CLUSTER)
// over ceil(q_rows / 64) Q tiles and `splits` K ranges of `per`
// K tiles
template <bool DW>
int launch_bwd_cluster(const bf16* q, int q_rows, const bf16* k, int k_rows,
                       const float* b, const int* labels, const float* lse,
                       const float* gw, float* out, float* db_part, int M, int V,
                       int splits, int per, cudaStream_t st) {
  CUtensorMap q_map, k_map;
  int err = row_tile_map(&q_map, q, q_rows, CLUSTER_H);
  if (err) return err;
  err = row_tile_map(&k_map, k, k_rows, CLUSTER_H);
  if (err) return err;
  err = allow_smem(ce_bwd_cluster_kernel<DW>, BwdCluster::SMEM);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const int q_tiles = (q_rows + BT - 1) / BT;
  const cudaLaunchConfig_t cfg = cluster_config(attr, q_tiles, splits, st);
  const int slots = cluster_slots<DW>(cfg);
  if (slots < 0) return -slots;
  if (slots == 0) return ERR_CLUSTER;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, ce_bwd_cluster_kernel<DW>,
                                            q_map, k_map, b, labels, lse, gw, out, db_part,
                                            M, V, (k_rows + BT - 1) / BT, per, q_tiles));
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (!err) ++cluster_launches;
  return err;
}

// Past H = 512: Q [q_rows, H] and K [k_rows, H] streamed; column tiles of
// 512 (one launch, grid z), then one launch each of 256, 128 and 64 for
// what is left of H (ops/fused_ce.py: col_tiles); db from the first
template <bool DW>
int launch_bwd_wide(const bf16* q, int q_rows, const bf16* k, int k_rows,
                    const float* b, const int* labels, const float* lse,
                    const float* gw, float* out, float* db_part, int M, int V,
                    int H, int splits, int per, cudaStream_t st) {
  CUtensorMap q_map, k_map;
  int err = row_tile_map(&q_map, q, q_rows, H);
  if (err) return err;
  err = row_tile_map(&k_map, k, k_rows, H);
  if (err) return err;
#define VCT_WIDE(CT, TILES, E)                                                 \
  launch_wide<CT, DW>(q_map, k_map, q_rows, k_rows, b, labels, lse, gw, out,   \
                      (E) == 0 ? db_part : nullptr, M, V, H, splits, per, TILES, \
                      E, st)
  int e = H / 512 * 512;
  err = VCT_WIDE(512, H / 512, 0);
  if (!err && H - e >= 256) { err = VCT_WIDE(256, 1, e); e += 256; }
  if (!err && H - e >= 128) { err = VCT_WIDE(128, 1, e); e += 128; }
  if (!err && H - e >= 64) err = VCT_WIDE(64, 1, e);
#undef VCT_WIDE
  return err;
}

// H at compile time (64..512), or 0 for the column-tiled kernels past 512
template <int HH>
int launch_dh(const bf16* h, const bf16* w, const float* b, const int* labels,
              const float* lse, const float* gw, float* dh, int M, int H, int V,
              cudaStream_t st) {
  const int v_tiles = (V + BT - 1) / BT;
  if constexpr (HH == 0) {
    if (cluster_width(H))
      return launch_bwd_cluster<false>(h, M, w, V, b, labels, lse, gw, dh, nullptr, M, V,
                                       1, v_tiles, st);
    return launch_bwd_wide<false>(h, M, w, V, b, labels, lse, gw, dh, nullptr, M, V, H,
                                  1, v_tiles, st);
  } else
    return launch_bwd<HH, false>(h, M, w, V, b, labels, lse, gw, dh, nullptr, M, V,
                                 1, v_tiles, st);
}

template <int HH>
int launch_dwdb(const bf16* h, const bf16* w, const float* b, const int* labels,
                const float* lse, const float* gw, float* dw_part,
                float* db_part, float* dw, float* db, int M, int H, int V,
                int splits, int per, cudaStream_t st) {
  int err;
  if constexpr (HH == 0)
    err = cluster_width(H)
              ? launch_bwd_cluster<true>(w, V, h, M, b, labels, lse, gw, dw_part, db_part,
                                         M, V, splits, per, st)
              : launch_bwd_wide<true>(w, V, h, M, b, labels, lse, gw, dw_part, db_part, M,
                                      V, H, splits, per, st);
  else
    err = launch_bwd<HH, true>(w, V, h, M, b, labels, lse, gw, dw_part, db_part, M, V,
                               splits, per, st);
  if (err) return err;
  const int Vp = (V + BT - 1) / BT * BT;
  err = sum_splits(dw_part, splits, static_cast<size_t>(Vp) * H,
                   static_cast<size_t>(V) * H, dw, st);
  if (err) return err;
  return sum_splits(db_part, splits, Vp, V, db, st);
}

}  // namespace

// Shape rule: H is 64, 128, 256, 512, or past 512 a multiple of 64 up to
// CE_H_MAX; M and V anything positive.  Each returns a cudaError_t as int.
#define VCT_CE_ARGS                                                      \
  static_cast<const bf16*>(h), static_cast<const bf16*>(w),               \
      static_cast<const float*>(b), static_cast<const int*>(labels)

// h16 [M, H], w16 [V, H] bf16; b [V] f32; labels [M] int32 -> lse, ll [M]
// f32.  A block takes chunk_tiles vocab tiles of 128 columns; part: [chunks
// · (rows == 64 ? 2 : 1), M, 3] f32 workspace, chunks = ceil(ceil(V / 128)
// / chunk_tiles), rows from vct_fused_ce_fwd_block.  ops/fused_ce.py's
// ce_fwd_plan picks chunk_tiles.
extern "C" int vct_fused_ce_fwd(const void* h, const void* w, const void* b,
                                const void* labels, void* part, void* lse,
                                void* ll, int M, int H, int V, int chunk_tiles,
                                void* stream) {
  if (bad_shape(M, H, V) || chunk_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_h<false>(VCT_CE_ARGS, static_cast<float*>(part), nullptr,
                             static_cast<float*>(lse), static_cast<float*>(ll), M, H,
                             V, chunk_tiles, static_cast<cudaStream_t>(stream));
}

// + lse, gw [M] f32 -> dh [ceil(M / 64) * 64, H] f32 (the rows past M come
// out zero)
extern "C" int vct_fused_ce_dh(const void* h, const void* w, const void* b,
                               const void* labels, const void* lse,
                               const void* gw, void* dh, int M, int H, int V,
                               void* stream) {
  if (bad_shape(M, H, V)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_dh<HH>(VCT_CE_ARGS, static_cast<const float*>(lse),                  \
                static_cast<const float*>(gw), static_cast<float*>(dh), M, H, \
                V, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// + lse, gw [M] f32 -> dw [V, H], db [V] f32.  Split y sums the 64-row tiles
// [y * per, min(ceil(M / 64), (y + 1) * per)) of h.  Workspaces: dw_part
// [splits, Vp, H], db_part [splits, Vp] f32, Vp = ceil(V / 64) * 64.
extern "C" int vct_fused_ce_dwdb(const void* h, const void* w, const void* b,
                                 const void* labels, const void* lse,
                                 const void* gw, void* dw_part, void* db_part,
                                 void* dw, void* db, int M, int H, int V,
                                 int splits, int per, void* stream) {
  // every split takes at least one row tile (past 512 the first product
  // overwrites the accumulators)
  if (bad_shape(M, H, V) || splits <= 0 || per <= 0 ||
      static_cast<long>(splits - 1) * per >= (M + BT - 1) / BT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_dwdb<HH>(VCT_CE_ARGS, static_cast<const float*>(lse),                \
                  static_cast<const float*>(gw), static_cast<float*>(dw_part),\
                  static_cast<float*>(db_part), static_cast<float*>(dw),      \
                  static_cast<float*>(db), M, H, V, splits, per, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// The forward's block at width H, of the flash schedule (write_lg 0) or of
// the written-logits one (1), as rows · 2 + resident; -1 for a width the
// kernels do not take
extern "C" int vct_fused_ce_fwd_block(int H, int write_lg) {
  return ce_width(H) ? fwd_block(H, write_lg != 0) : -1;
}

// the dynamic shared memory of the forward kernel at width H, of the flash
// schedule (write_lg 0) or of the written-logits one (1) (bytes); -1 for a
// width the kernels do not take
extern "C" int vct_fused_ce_fwd_smem(int H, int write_lg) {
  return ce_width(H) ? fwd_smem(H, write_lg != 0) : -1;
}

// the dynamic shared memory of the backward kernels (bytes): ce_bwd_kernel
// at H = 64 .. 512; ce_bwd_wide_kernel of CT columns at H = -CT (CT = 64 ..
// 512), and at any H past 512 of 512 columns (its shared memory does not
// depend on H); ce_bwd_cluster_kernel at H = -1024
extern "C" int vct_fused_ce_bwd_smem(int H) {
  switch (H) {
    case 64: return static_cast<int>(Bwd<64>::SMEM);
    case 128: return static_cast<int>(Bwd<128>::SMEM);
    case 256: return static_cast<int>(Bwd<256>::SMEM);
    case 512: return static_cast<int>(Bwd<512>::SMEM);
    case -64: return static_cast<int>(BwdWide<64>::SMEM);
    case -128: return static_cast<int>(BwdWide<128>::SMEM);
    case -256: return static_cast<int>(BwdWide<256>::SMEM);
    case -1024: return static_cast<int>(BwdCluster::SMEM);
    default: return static_cast<int>(BwdWide<512>::SMEM);
  }
}

// The shape rule past 512 (ops/fused_ce.py: bwd_cluster): the CTAs of a
// cluster of ce_bwd_cluster_kernel at width H, 0 where another kernel runs
extern "C" int vct_fused_ce_bwd_cluster(int H) {
  return ce_width(H) && cluster_width(H) ? CLUSTER : 0;
}

// the clusters of ce_bwd_cluster_kernel the current device holds at once
// (dh's instance; 0: none fits), or -cudaError_t
extern "C" int vct_fused_ce_bwd_cluster_slots() {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, 1, 1, nullptr);
  const int err = allow_smem(ce_bwd_cluster_kernel<false>, BwdCluster::SMEM);
  return err ? -err : cluster_slots<false>(cfg);
}

// the launches of ce_bwd_cluster_kernel (dh and dW/db) in this process
extern "C" int vct_fused_ce_bwd_cluster_launches() { return cluster_launches; }

// The forward's shape rule (ops/fused_ce.py: fwd_cluster), of the flash
// schedule (write_lg 0) or of the written-logits one (1): the CTAs of a
// cluster of ce_fwd_kernel at width H, 0 where its blocks run alone
extern "C" int vct_fused_ce_fwd_cluster(int H, int write_lg) {
  return ce_width(H) ? fwd_cluster(H, write_lg != 0) : 0;
}

// the clusters of the flash forward's instance at H = 1024 the current
// device holds at once (0: none fits), or -cudaError_t
extern "C" int vct_fused_ce_fwd_cluster_slots() {
  const int smem = fwd_smem(1024, false);
  const int err = allow_smem(ce_fwd_kernel<16, 1, true, false, FWD_CLUSTER>, smem);
  if (err) return -err;
  cudaLaunchAttribute attr[1];
  return fwd_held_clusters<16, 1, true, false, FWD_CLUSTER>(
      fwd_cluster_config<FWD_CLUSTER>(attr, dim3(FWD_CLUSTER, 1), smem, nullptr));
}

// the launches of the flash forward's cluster instances in this process
extern "C" int vct_fused_ce_fwd_cluster_launches() { return fwd_cluster_launches; }
