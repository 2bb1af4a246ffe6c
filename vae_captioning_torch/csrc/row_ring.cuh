// The product loop of the kernels that keep a block's rows of A in shared
// memory and stream the vocabulary B through a TMA ring, for Hopper
// (sm_90a): the CE forward of both CE schedules (fused_ce.cuh,
// ce_fwd_kernel) and the decode's logits top-k, its int8 variant and the
// sampler (fused_logits_topk.cu, logits_topk_kernel).  Both compute
//
//   S = A @ B^T      A [M, K] (the block's rows), B [V, K] (the vocabulary)
//
// one vocab tile of 128 rows of B at a time, each tile's S in the two
// consumer warpgroups' registers, where the caller folds it before it asks
// for the next tile.
//
// * Boxes: TMA boxes of 128 bytes per row with the 128-byte swizzle, 64
//   rows of A (8 KB) or 128 rows of B (16 KB); a box row holds 64 bf16 or
//   128 int8 values, four wgmma k-steps 32 bytes apart in both (Op:
//   Bf16Op, bf16 x bf16 -> f32 on m64nNk16; S8Op, s8 x s8 -> s32 on
//   m64nNk32).  A tile's product runs over `boxes` boxes, K's bytes / 128
//   rounded up (TMA reads zeros past K).
// * RG, the block's 64-row groups of A.  RG = 2: 128 rows, warpgroup g
//   owns rows 64g.. and all 128 columns of every tile (m64n128, 64
//   accumulators a thread).  RG = 1: 64 rows, warpgroup g owns columns
//   64g.. of every tile (m64n64, 32 accumulators), or, with ALTERNATE,
//   all 128 columns of every other tile (tiles g, g + 2, ..; m64n128), so
//   that one warpgroup's products run while the other folds its tile.  A
//   warpgroup still waits for and releases every box of the other's
//   tiles (skip), so that its phases of each stage stay in step.
// * RES: A resident, loaded once per block, or streamed beside each B box
//   in the same stage (for K too wide to keep).
// * The ring: one full mbarrier per stage, at most 8 stages, as many as
//   the shared memory left after A (and the caller's EXTRA bytes) holds.
//   Each warpgroup commits one wgmma group per box and, once the previous
//   box's group retired, its leader counts that release in shared memory;
//   the later of the two leaders refills the stage, `stages` boxes ahead.
//   Nobody waits to refill.
// * BOXES: the boxes per tile as a compile-time constant (the CE forward,
//   templated on K; the decode kernels at their main width) or 0 for a
//   runtime count (the decode kernels at any other multiple of 32); the
//   layout is the same function of it either way (ring_layout).
// * CLUSTER (the CE forward's 64-row blocks past H = 512; 1 elsewhere, and
//   then none of what follows is compiled): a cluster of CLUSTER CTAs
//   along M, each with its own rows of A resident, that share every B box.
//   Each CTA loads 128 / CLUSTER rows of the box by one TMA multicast into
//   the same stage of every CTA of the cluster, and its full barrier
//   expects the whole box, so each B byte is read from L2 once per
//   CLUSTER blocks.  A stage may be refilled only once the cluster's
//   2·CLUSTER consumer warpgroups have all released it: each warpgroup's
//   leader arrives on the stage's empty barrier in every CTA of the
//   cluster (a remote arrive; none for a box no refill waits for), and a
//   producer warp beside the consumers (produce) waits on its own CTA's
//   empty barrier before it loads.  No consumer waits to refill.
//
// Also the fold helpers both callers share: ex2, and the logit of a vocab
// column past V (its bias), whose exp is exactly 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;     // the logit of a vocab column past V

// 2^x through ex2.approx (2 ulp); 2^-inf = 0.  e^(x - m) is
// ex2(x·LOG2E - m·LOG2E), one FFMA and one ex2.
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// dynamic shared memory above 48 KB, and the whole carve-out for it
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

struct Bf16Op {
  using Acc = float;
  static constexpr int BOX_X = BOX;         // columns of a 128-byte box row
  template <int N>
  __device__ __forceinline__ static void mma(float (&d)[N / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
    wgmma<N, 0>(d, a, b, scale_d);
  }
};

struct S8Op {
  using Acc = int;
  static constexpr int BOX_X = 128;
  template <int N>
  __device__ __forceinline__ static void mma(int (&d)[N / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
    wgmma_s8<N>(d, a, b, scale_d);
  }
};

constexpr int RING_TV = 128;               // vocab rows of a B box: a tile
constexpr int RING_B_BYTES = RING_TV * 128;  // 16 KB
constexpr int SMEM_MAX = 232448;           // one block per SM: 227 KB

struct RingLayout {
  int q_bytes;       // resident A
  int stage_bytes;   // a B box, and A's boxes when streamed
  int stages;
  int smem;          // dynamic shared memory of the block
};

// 1 KB to align to the swizzle's 1024-byte period; A, the ring, the
// caller's extra bytes, the full barriers, the release counters (padded to
// 8 bytes), A's barrier and, in a cluster, the empty barriers
__host__ __device__ constexpr RingLayout ring_layout(int boxes, int rg, bool res,
                                                     int extra, int cluster = 1) {
  const int q = res ? rg * boxes * BOX_BYTES : 0;
  const int stage = RING_B_BYTES + (res ? 0 : rg * BOX_BYTES);
  const int room = (SMEM_MAX - 1024 - q - extra - 256) / stage;
  const int stages = room < 8 ? room : 8;
  return RingLayout{q, stage, stages,
                    1024 + q + stage * stages + extra + stages * 12 + 16 +
                        (cluster > 1 ? stages * 8 : 0)};
}

template <class Op, int RG, bool RES, int BOXES = 0, int EXTRA = 0, int CLUSTER = 1,
          bool ALTERNATE = false>
struct RowRing {
  static_assert(RG == 1 || RG == 2, "RG: one or two 64-row groups");
  static_assert(CLUSTER == 1 || (RES && CLUSTER == 2), "a cluster of 2 CTAs, A resident");
  static_assert(!ALTERNATE || RG == 1, "alternate tiles: the warpgroups of 64 rows");
  // a warpgroup's columns of a tile
  static constexpr int N = RG == 2 || ALTERNATE ? RING_TV : RING_TV / 2;
  // the layout of a compile-time box count (scalars: device code reads them)
  static constexpr int FIXED_STAGES =
      ring_layout(BOXES > 0 ? BOXES : 1, RG, RES, EXTRA, CLUSTER).stages;
  static constexpr int FIXED_STAGE_BYTES =
      ring_layout(BOXES > 0 ? BOXES : 1, RG, RES, EXTRA, CLUSTER).stage_bytes;
  static constexpr int SMEM = ring_layout(BOXES > 0 ? BOXES : 1, RG, RES, EXTRA, CLUSTER).smem;
  // in a cluster: the rows of a B box each CTA loads, and its offset's step
  static constexpr int PART_ROWS = RING_TV / CLUSTER;
  static constexpr int PART_BYTES = RING_B_BYTES / CLUSTER;
  // A resident at a compile-time box count: the low words of this
  // warpgroup's BOXES·4 k-step A descriptors are made once a block and
  // pinned in registers (the high word is the same in all of them); not
  // beside ALTERNATE's 64 accumulators, where they spill
  static constexpr bool PIN_A = RES && BOXES > 0 && !ALTERNATE;
  using Acc = typename Op::Acc;

  unsigned char* q_s;
  unsigned char* ring;
  unsigned char* extra;        // EXTRA bytes for the caller
  uint64_t* full;
  uint32_t* released;
  uint64_t* q_bar;
  uint64_t* empty;             // CLUSTER > 1: a stage's releases in the cluster
  uint32_t empty_at[CLUSTER];  // CLUSTER > 1: empty[0] in each CTA (shared::cluster)
  uint32_t rank;               // CLUSTER > 1: this CTA's rank in its cluster
  const CUtensorMap* a_map;
  const CUtensorMap* b_map;
  int boxes_, stages_, stage_bytes_;
  int m0, t0, total;           // first row, first vocab tile, boxes streamed
  // the matrix descriptors of this warpgroup's first A box (resident:
  // box 0; streamed: in stage 0) and of its B rows in stage 0
  uint64_t a_desc, b_desc;
  uint32_t a_lo[PIN_A ? BOXES * 4 : 1];   // PIN_A: k-step x = 4·box + kk

  __device__ __forceinline__ int boxes() const {
    if constexpr (BOXES > 0) return BOXES; else return boxes_;
  }
  __device__ __forceinline__ int stages() const {
    if constexpr (BOXES > 0) return FIXED_STAGES; else return stages_;
  }
  __device__ __forceinline__ int stage_bytes() const {
    if constexpr (BOXES > 0) return FIXED_STAGE_BYTES; else return stage_bytes_;
  }

  // smem: the block's dynamic shared memory, ring_layout(boxes, RG, RES,
  // EXTRA).smem bytes; rows [m0, m0 + 64·RG) of A, vocab tiles [t0, t0 +
  // n_tiles) of B
  __device__ RowRing(unsigned char* smem, int boxes, const CUtensorMap* a,
                     const CUtensorMap* b, int m0_, int t0_, int n_tiles)
      : a_map(a), b_map(b), boxes_(boxes), m0(m0_), t0(t0_) {
    const RingLayout L = ring_layout(BOXES > 0 ? BOXES : boxes, RG, RES, EXTRA, CLUSTER);
    stages_ = L.stages;
    stage_bytes_ = L.stage_bytes;
    q_s = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
    ring = q_s + L.q_bytes;
    extra = ring + L.stages * L.stage_bytes;
    full = reinterpret_cast<uint64_t*>(extra + EXTRA);
    released = reinterpret_cast<uint32_t*>(full + L.stages);
    q_bar = reinterpret_cast<uint64_t*>(released + L.stages + (L.stages & 1));
    empty = q_bar + 1;
    if constexpr (CLUSTER > 1) {
      rank = cluster_ctarank();
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) empty_at[r] = cluster_map(smem_addr(empty), r);
    }
    total = n_tiles * boxes;
    const int g = RG == 2 ? threadIdx.x / 128 : 0;   // this warpgroup's row group
    a_desc = sw128_desc(RES ? smem_addr(q_s) + g * boxes * BOX_BYTES
                            : smem_addr(ring) + RING_B_BYTES + g * BOX_BYTES, 16);
    b_desc = sw128_desc(smem_addr(ring) + (RG == 1 && !ALTERNATE ? threadIdx.x / 128 : 0) * BOX_BYTES, 16);
    if constexpr (PIN_A) {
#pragma unroll
      for (int x = 0; x < BOXES * 4; ++x) {
        a_lo[x] = static_cast<uint32_t>(a_desc) + (x / 4) * (BOX_BYTES >> 4) + 2 * (x % 4);
        asm volatile("" : "+r"(a_lo[x]));
      }
    }
  }

  // box j of the stream (tile t0 + j / boxes, bytes 128·(j % boxes)) into
  // stage j % stages, with A's boxes of those bytes when A is streamed; in
  // a cluster this CTA's PART_ROWS rows of it into every CTA's stage, the
  // barrier expecting the whole box
  __device__ __forceinline__ void load(int j) const {
    const int s = j % stages();
    const int x = (j % boxes()) * Op::BOX_X;
    unsigned char* st = ring + s * stage_bytes();
    mbar_expect_tx(&full[s], stage_bytes());
    if constexpr (CLUSTER > 1)
      tma_load_multicast(st + rank * PART_BYTES, b_map, &full[s], x,
                         (t0 + j / boxes()) * RING_TV + rank * PART_ROWS,
                         static_cast<uint16_t>((1u << CLUSTER) - 1));
    else
      tma_load(st, b_map, &full[s], x, (t0 + j / boxes()) * RING_TV);
    if constexpr (!RES) {
#pragma unroll
      for (int g = 0; g < RG; ++g)
        tma_load(st + RING_B_BYTES + g * BOX_BYTES, a_map, &full[s], x, m0 + g * BT);
    }
  }

  // this warpgroup's products of box j retired: the later of the two
  // leaders refills its stage `stages` boxes ahead; in a cluster the
  // leader arrives on the stage's empty barrier in every CTA instead
  __device__ __forceinline__ void release(int j) const {
    if (threadIdx.x % 128 != 0) return;
    if constexpr (CLUSTER > 1) {
      if (j + stages() >= total) return;   // no refill waits for it
      const uint32_t off = (j % stages()) * sizeof(uint64_t);
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty_at[r] + off);
    } else {
      const int s = j % stages();
      __threadfence_block();
      const bool later = atomicAdd(&released[s], 1u) & 1u;
      __threadfence_block();
      if (later && j + stages() < total) load(j + stages());
    }
  }

  // A's rows (resident): row group g's boxes at g·boxes..
  __device__ __forceinline__ void load_rows() const {
    mbar_expect_tx(q_bar, RG * boxes() * BOX_BYTES);
#pragma unroll
    for (int g = 0; g < RG; ++g) {
      if constexpr (BOXES > 0) {
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load(q_s + (g * BOXES + c) * BOX_BYTES, a_map, q_bar, c * Op::BOX_X,
                   m0 + g * BT);
      } else {
        for (int c = 0; c < boxes_; ++c)
          tma_load(q_s + (g * boxes_ + c) * BOX_BYTES, a_map, q_bar, c * Op::BOX_X,
                   m0 + g * BT);
      }
    }
  }

  // barriers, then A's rows (resident) and the first `stages` boxes; in a
  // cluster the barriers of every CTA are set up before any CTA goes on,
  // and the producer warp loads (produce)
  __device__ void start() const {
    const int tid = threadIdx.x;
    if (tid == 0) {
      for (int s = 0; s < stages(); ++s) {
        mbar_init(&full[s], 1);
        released[s] = 0;
        if constexpr (CLUSTER > 1) mbar_init(&empty[s], 2 * CLUSTER);
      }
      mbar_init(q_bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if constexpr (CLUSTER > 1) {
      cluster_arrive();
      cluster_wait();
      return;
    }
    __syncthreads();
    if (tid == 0) {
      if constexpr (RES) load_rows();
      for (int j = 0; j < min(stages(), total); ++j) load(j);
    }
  }

  // CLUSTER > 1, one thread of the producer warp: A's rows, then every box
  // of the stream, a refill once the cluster's warpgroups all released the
  // stage's previous box
  __device__ void produce() const {
    static_assert(CLUSTER > 1, "the producer of a cluster");
    load_rows();
    for (int j = 0; j < total; ++j) {
      const int s = j % stages();
      if (j >= stages()) mbar_wait(&empty[s], (j / stages() - 1) & 1);
      load(j);
    }
  }

  // ALTERNATE: tile i is the other warpgroup's; wait for each of its
  // boxes and release it
  __device__ __forceinline__ void skip(int i) const {
    for (int c = 0; c < boxes(); ++c) {
      const int j = i * boxes() + c;
      mbar_wait(&full[j % stages()], (j / stages()) & 1);
      release(j);
    }
  }

  // the resident rows have landed
  __device__ __forceinline__ void wait_rows() const {
    if constexpr (RES) mbar_wait(q_bar, 0);
  }

  // This warpgroup's S of tile i into acc: rows r + 8·ii (ii = 0, 1) of
  // its 64, columns 8n + cq + j (n < N / 8, j < 2; cq = 2·(lane % 4), r =
  // 16·warp + lane / 4) of its N at register 4n + 2·ii + j.
  //
  // Descriptors count 16-byte units, and shared addresses stay below
  // 2^18, so an offset adds to a descriptor's address field without a
  // carry: a k-step (32 bytes) is 2.  With PIN_A a k-step's A descriptor
  // is its pinned low word under the common high word, so the wgmma
  // issues with no arithmetic before it; the compiler otherwise
  // recomputes the sum at every k-step (the flash CE forward took 2%
  // longer so, and 3.4% building each descriptor from its address).
  __device__ __forceinline__ void product(int i, Acc (&acc)[N / 2]) const {
    auto step = [&](int c) {
      const int j = i * boxes() + c;
      const int s = j % stages();
      mbar_wait(&full[s], (j / stages()) & 1);
      const uint32_t stage = (s * stage_bytes()) >> 4;
      const uint64_t da = a_desc + (RES ? c * (BOX_BYTES >> 4) : stage);
      const uint64_t db = b_desc + stage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint64_t dak = da + 2 * kk;
        if constexpr (PIN_A) dak = (a_desc & ~0xffffffffull) | a_lo[4 * c + kk];
        Op::template mma<N>(acc, dak, db + 2 * kk, (c | kk) != 0);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        release(j - 1);
      }
    };
    if constexpr (BOXES > 0) {
#pragma unroll
      for (int c = 0; c < BOXES; ++c) step(c);
    } else {
      for (int c = 0; c < boxes_; ++c) step(c);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    release((i + 1) * boxes() - 1);
  }
};

}  // namespace
