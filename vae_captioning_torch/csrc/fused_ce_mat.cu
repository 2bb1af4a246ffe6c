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
// lg's pad columns V..Vp-1 hold -1e30, so exp gives p = 0 there: dl is 0 on
// them but where a row of weight 0 carries a label in [V, Vp), and that dl
// (-0) meets the zero rows TMA fills in past V (dh) or lands in padded rows
// of dW and db that are never summed out.  The row pitch Vp is a multiple of
// 64 columns (128 bytes), as TMA and the swizzle need.
//
// What bounds it on this card: tensor-core operations, 2 M H V for each of
// the three (362 GFLOP at M = 30720, H = 512, V = 11500: 0.366 ms at the
// dense bf16 rate); the bytes, about 0.75 GB each with the 708 MB of lg,
// take 0.22 ms.  Unlike the flash schedule, nothing recomputes the logits
// product: the backward reads lg instead.  In practice each backward block
// also streams all of the other operand from L2 (5.66 GB a kernel at the
// train shapes) and writes it into shared memory: with the tile's wgmma
// operand reads, about 168 KB of shared-memory traffic per 64 x 64 x 512
// tile against 1024 clocks of tensor work (PERF.md, PR 8).
//
// The forward: the flash forward's wgmma + TMA template (fused_ce.cuh) with
// WRITE_LG: after folding each f32 logits tile into (max, sum-exp) and the
// label pick, each warpgroup rounds it to bf16 (nearest even) into shared
// memory and stores it with TMA into lg, clipped at the row pitch Vp.
//
// The backward: one kernel template, ce_mat_bwd_kernel<H, DW>, for both
// gradients, built on the Hopper primitives of hopper.cuh.  A block owns 64
// rows of the output (h rows for dh, vocab rows for dW) and streams the
// other operand K in tiles of 64 rows, each with the matching 64 x 64 box of
// lg:
//
//   dl  = (exp(f32(lg box) - lse) - onehot(label)) * gw     f32, in place
//   out += bf16(dl) @ K_tile                   [64 x H], contract 64
//
//              dh (DW = false)                 dW/db (DW = true)
//   out rows   64 rows of h (grid x)            64 vocab rows (grid x)
//   K          W, every vocab tile              h, a range of row tiles (split)
//   lg box     rows = out rows, cols = K tile   rows = K tile, cols = out rows
//   A operand  dl, K-major                      dl^T, MN-major (read transposed)
//   lse,gw,lab per out row (loaded once)        per K row (a tile ahead)
//   extra      -                                db = column sums of the f32 dl
//
// * TMA and mbarriers: a stage holds a K tile (64 x 64 boxes, 128-byte
//   swizzle) and its lg box (a tensor map over lg [M, Vp], the same
//   swizzle); a full barrier per stage counts the bytes in.  No resident
//   tile, so the ring has 3 stages at H = 512 (216 KB), more below.
// * dl in place: each thread reads two 16-byte runs of the swizzled lg box,
//   forms dl in f32 (db's sums too), and writes bf16(dl) back into the same
//   slots; a proxy fence and one named barrier later the box is wgmma's A
//   operand.  The dl step waits on no tensor-core product, only on its
//   tile's TMA load, and runs while the previous tile's product is in
//   flight.
// * wgmma: two consumer warpgroups each own half of H (m64n256 at H = 512,
//   128 accumulator registers a thread), B MN-major from the K tile.
// * Refill: a warpgroup's product reads only its half of the K tile, so its
//   leader refills that half as soon as its own product retires.  Both read
//   the whole lg box: the leaders count their releases of a stage in shared
//   memory, and the later of the two also loads the lg box (at H = 64, one
//   K box, the later loads the whole stage).  Nobody waits to refill.
// * Row operands: dh's lse, gw and labels belong to the block's own rows
//   and are loaded once; dW/db's belong to the streamed h rows and are
//   loaded a tile ahead, so that their latency hides behind a tile's work.
// * Ragged edges: TMA fills rows past M or V with zeros; rows past M carry
//   gw = 0 and lse = 0 (a zero lg gives p = exp(0) = 1, times gw = 0), so
//   they add nothing, and rows of weight 0 get dh exactly 0.
// * Determinism: no float atomics.  db's sums run in a fixed order (tiles,
//   then lanes by shuffle, then warps); dW/db's row splits write [splits,
//   Vp, H] partials that a last launch sums in split order (db alike), so
//   the gradients repeat bit for bit.

#include "fused_ce.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAT_THREADS = 256;   // two consumer warpgroups
constexpr int MAT_WARPS = MAT_THREADS / 32;

template <int H>
struct MatBwd {
  static constexpr int BOXES = H / BOX;               // boxes per K tile
  static constexpr int TILE = BT * H * 2;             // bytes of a K tile
  static constexpr int STAGE = TILE + BOX_BYTES;      // + its lg box
  static constexpr int STAGES = H == 512 ? 3 : H == 256 ? 5 : 8;
  static constexpr int HN = H / 2;                    // output columns per warpgroup
  static constexpr int ACC = HN / 2;                  // their f32 registers per thread
  // at H >= 128 a K tile is loaded by two threads, one box half each
  static constexpr bool SPLIT = BOXES >= 2;
  // 1 KB to align the stages to the swizzle's 1024-byte period; the ring,
  // db's exchange (a 64-column row per warp), the full barriers and the
  // release counters
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(STAGE) * STAGES +
                                 MAT_WARPS * BT * sizeof(float) +
                                 STAGES * (sizeof(uint64_t) + sizeof(uint32_t));
  static_assert(SMEM <= 232448, "one block per SM: 227 KB of shared memory");
};

// boxes [C0, C1) of the K tile at `row` into `dst` and, with LG, the lg box
// at (lg_x, lg_y) into `lg_dst`; all the bytes complete on `bar`.  The box
// range is a compile-time constant, as in load_boxes (hopper.cuh).
template <int C0, int C1, bool LG>
__device__ __forceinline__ void load_stage(unsigned char* dst, unsigned char* lg_dst,
                                           const CUtensorMap* k_map,
                                           const CUtensorMap* lg_map, uint64_t* bar,
                                           int row, int lg_x, int lg_y) {
  mbar_expect_tx(bar, (C1 - C0 + (LG ? 1 : 0)) * BOX_BYTES);
#pragma unroll
  for (int c = C0; c < C1; ++c)
    tma_load(dst + c * BOX_BYTES, k_map, bar, c * BOX, row);
  if constexpr (LG) tma_load(lg_dst, lg_map, bar, lg_x, lg_y);
}

// Grid (output row tiles, K ranges).  Block (x, y) owns output rows [64x,
// 64x + 64) and K tiles [y·per, min(k_tiles, (y + 1)·per)).
//   DW = false: K = W; out = dh [64·gridDim.x, H].
//   DW = true:  K = h; out = dw_part [gridDim.y, 64·gridDim.x, H],
//               db_part [gridDim.y, 64·gridDim.x].
template <int H, bool DW>
__global__ void __launch_bounds__(MAT_THREADS, 1)
ce_mat_bwd_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap lg_map,
                  const int* __restrict__ labels, const float* __restrict__ lse,
                  const float* __restrict__ gw, float* __restrict__ out,
                  float* __restrict__ db_part, int M, int k_tiles, int per) {
  using P = MatBwd<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  float* db_s = reinterpret_cast<float*>(ring + P::STAGES * P::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(db_s + MAT_WARPS * BT);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + P::STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int x0 = blockIdx.x * BT;
  const int t0 = blockIdx.y * per;
  const int n_tiles = max(0, min(k_tiles, t0 + per) - t0);

  // tile t0 + i into stage i % STAGES: this warpgroup's half of the K boxes
  // (at H = 64 the one box, loaded only with the lg box) and, when `lg`,
  // the lg box: dh reads lg[x0.., k0..], dW/db lg[k0.., x0..]
  auto load = [&](int i, bool lg) {
    const int s = i % P::STAGES;
    unsigned char* dst = ring + s * P::STAGE;
    unsigned char* lg_dst = dst + P::TILE;
    const int k0 = (t0 + i) * BT;
    const int lx = DW ? x0 : k0, ly = DW ? k0 : x0;
    if constexpr (!P::SPLIT) {
      load_stage<0, 1, true>(dst, lg_dst, &k_map, &lg_map, &full[s], k0, lx, ly);
    } else if (wg == 0) {
      if (lg) load_stage<0, P::BOXES / 2, true>(dst, lg_dst, &k_map, &lg_map, &full[s], k0, lx, ly);
      else load_stage<0, P::BOXES / 2, false>(dst, lg_dst, &k_map, &lg_map, &full[s], k0, lx, ly);
    } else {
      if (lg) load_stage<P::BOXES / 2, P::BOXES, true>(dst, lg_dst, &k_map, &lg_map, &full[s], k0, lx, ly);
      else load_stage<P::BOXES / 2, P::BOXES, false>(dst, lg_dst, &k_map, &lg_map, &full[s], k0, lx, ly);
    }
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

  // This thread's part of the dl step: rows er and er + 32 of the lg box,
  // columns 8·ec .. 8·ec + 7 (one 16-byte run each, at its swizzled place;
  // (er + 32) & 7 = er & 7).
  const int er = tid / 8;
  const int ec = tid % 8;
  const int run = er * 128 + ((ec ^ (er & 7)) * 16);
  // lse, gw and label of this thread's two h rows from row0: dh, the
  // block's own rows, fixed; dW/db, the K tile's, loaded a tile ahead so
  // that their latency hides behind a tile's work.  Rows past M get gw = 0
  // and lse = 0.
  float r_lse[2], r_gw[2];
  int r_lab[2];
  auto load_rows = [&](int row0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = row0 + er + 32 * j;
      const bool in = n < M;
      r_lse[j] = in ? lse[n] : 0.0f;
      r_gw[j] = in ? gw[n] : 0.0f;
      r_lab[j] = in ? labels[n] : -1;
    }
  };
  load_rows(DW ? t0 * BT : x0);

  const uint32_t ring_addr = smem_addr(ring);
  // this warpgroup's output columns in a K tile: their box, bytes within it
  const uint32_t out_cols = (wg * P::HN / BOX) * BOX_BYTES + (wg * P::HN % BOX) * 2;

  float acc[P::ACC];
#pragma unroll
  for (int e = 0; e < P::ACC; ++e) acc[e] = 0.0f;
  float db_run[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % P::STAGES;
    const int k0 = (t0 + i) * BT;        // the tile's first K row
    const uint32_t stage = ring_addr + s * P::STAGE;
    unsigned char* lg_box = ring + s * P::STAGE + P::TILE;

    // this tile's row operands, each row's label as an offset from this
    // thread's first column, and (dW/db) the next tile's rows requested
    float t_lse[2], t_gw[2];
    int rel[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      t_lse[j] = r_lse[j];
      t_gw[j] = r_gw[j];
      rel[j] = r_lab[j] - (DW ? x0 + 8 * ec : k0 + 8 * ec);
    }
    if constexpr (DW) {
      if (i + 1 < n_tiles) load_rows(k0 + BT);
    }
    mbar_wait(&full[s], (i / P::STAGES) & 1);

    // dl in f32 (db), rounded to bf16 into the lg box's own slots
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4* slot = reinterpret_cast<uint4*>(lg_box + run + j * 32 * 128);
      uint4 raw = *slot;
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = expf(__bfloat162float(x[e]) - t_lse[j]);
        d[e] = (p - (e == rel[j] ? 1.0f : 0.0f)) * t_gw[j];
      }
      if constexpr (DW) {
#pragma unroll
        for (int e = 0; e < 8; ++e) db_run[e] += d[e];
      }
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(d[2 * e], d[2 * e + 1]);
      *slot = raw;
    }
    // the dl tile is read by wgmma (the async proxy) after both halves land
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(MAT_THREADS) : "memory");

    // out [64 x HN] += A [64 x 64] @ K_tile [64 x (this warpgroup's HN)]:
    // dh: A = dl (rows x contraction, K-major: k16 steps 32 bytes along
    // the row); dW/db: A = dl^T, the box read MN-major (vocab along the
    // 128-byte row, k16 steps of 16 rows)
    const uint32_t a_addr = stage + P::TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b_desc = sw128_desc(stage + out_cols + kk * 16 * 128, BOX_BYTES);
      if constexpr (DW)
        wgmma<P::HN, 1, 1>(acc, sw128_desc(a_addr + kk * 16 * 128, BOX_BYTES), b_desc, 1);
      else
        wgmma<P::HN, 1, 0>(acc, sw128_desc(a_addr + kk * 32, 16), b_desc, 1);
    }
    wgmma_commit();

    // this warpgroup's product of the previous tile has retired: its
    // leader releases that stage and refills its half of the K boxes; the
    // later of the two leaders also refills the lg box, which both read
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

  // the [64, H] f32 block of dh, or of this split's dW partial.  This
  // thread's accumulator fragment: rows r + 8ii (ii = 0, 1) of the 64,
  // columns HN·wg + 8n + 2·(lane % 4) + j at register 4n + 2ii + j.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int Xp = gridDim.x * BT;
  float* o = out + (DW ? static_cast<size_t>(blockIdx.y) * Xp * H : 0);
#pragma unroll
  for (int n = 0; n < P::HN / 8; ++n)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = x0 + r + 8 * ii;
      const int col = wg * P::HN + 8 * n + cq;
      *reinterpret_cast<float2*>(&o[static_cast<size_t>(row) * H + col]) =
          make_float2(acc[4 * n + 2 * ii], acc[4 * n + 2 * ii + 1]);
    }
  if constexpr (DW) {
    // db: the 4 lanes of a warp that share columns (lane % 8), then the
    // 8 warps in order
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      db_run[e] += __shfl_xor_sync(0xffffffffu, db_run[e], 8);
      db_run[e] += __shfl_xor_sync(0xffffffffu, db_run[e], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) db_s[(tid / 32) * BT + 8 * lane + e] = db_run[e];
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(MAT_THREADS) : "memory");
    if (tid < BT) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < MAT_WARPS; ++w) sum += db_s[w * BT + tid];
      db_part[static_cast<size_t>(blockIdx.y) * Xp + x0 + tid] = sum;
    }
  }
}

// K [k_rows, H] streamed against lg [M, Vp]; grid (out_tiles, splits),
// each block over `per` K tiles
template <int H, bool DW>
int launch_mat_bwd(const bf16* k, int k_rows, const bf16* lg, const int* labels,
                   const float* lse, const float* gw, float* out, float* db_part,
                   int M, int V, int out_tiles, int splits, int per,
                   cudaStream_t st) {
  CUtensorMap k_map, lg_map;
  int err = row_tile_map(&k_map, k, k_rows, H);
  if (err) return err;
  // lg is a [M, Vp] bf16 matrix: the same 64 x 64 boxes and swizzle
  err = row_tile_map(&lg_map, lg, M, logits_pitch(V));
  if (err) return err;
  constexpr size_t smem = MatBwd<H>::SMEM;
  err = allow_smem(ce_mat_bwd_kernel<H, DW>, smem);
  if (err) return err;
  ce_mat_bwd_kernel<H, DW><<<dim3(out_tiles, splits), MAT_THREADS, smem, st>>>(
      k_map, lg_map, labels, lse, gw, out, db_part, M, (k_rows + BT - 1) / BT, per);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_mat_dh(const bf16* lg, const bf16* w, const int* labels,
                  const float* lse, const float* gw, float* dh, int M, int V,
                  cudaStream_t st) {
  const int v_tiles = (V + BT - 1) / BT;
  return launch_mat_bwd<H, false>(w, V, lg, labels, lse, gw, dh, nullptr, M, V,
                                  (M + BT - 1) / BT, 1, v_tiles, st);
}

template <int H>
int launch_mat_dwdb(const bf16* h, const bf16* lg, const int* labels,
                    const float* lse, const float* gw, float* dw_part,
                    float* db_part, float* dw, float* db, int M, int V,
                    int splits, int per, cudaStream_t st) {
  const int v_tiles = (V + BT - 1) / BT;
  int err = launch_mat_bwd<H, true>(h, M, lg, labels, lse, gw, dw_part, db_part,
                                    M, V, v_tiles, splits, per, st);
  if (err) return err;
  const int Vp = v_tiles * BT;
  err = sum_splits(dw_part, splits, static_cast<size_t>(Vp) * H,
                   static_cast<size_t>(V) * H, dw, st);
  if (err) return err;
  return sum_splits(db_part, splits, Vp, V, db, st);
}

}  // namespace

// Shape rule: H is 64, 128, 256 or 512; M and V anything positive; lg is [M,
// 64 ceil(V / 64)] bf16.  Each returns a cudaError_t as int.

// h16 [M, H], w16 [V, H] bf16; b [V] f32; labels [M] int32 -> lg [M, Vp]
// bf16, lse, ll [M] f32.  A block takes chunk_tiles vocab tiles of 128
// columns; part: [chunks, M, 3] f32 workspace, chunks = ceil(ceil(V / 128) /
// chunk_tiles) (ops/fused_ce.py's ce_fwd_plan).
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
// [ceil(M / 64) * 64, H] f32 (the rows past M come out zero)
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
// [V, H], db [V] f32.  Split y sums the 64-row tiles [y * per, min(ceil(M /
// 64), (y + 1) * per)) of h.  Workspaces: dw_part [splits, Vp, H], db_part
// [splits, Vp] f32.
extern "C" int vct_fused_ce_mat_dwdb(const void* h, const void* lg,
                                     const void* labels, const void* lse,
                                     const void* gw, void* dw_part,
                                     void* db_part, void* dw, void* db, int M,
                                     int H, int V, int splits, int per,
                                     void* stream) {
  if (bad_shape(M, H, V) || splits <= 0 || per <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_mat_dwdb<HH>(static_cast<const bf16*>(h), static_cast<const bf16*>(lg), \
                      static_cast<const int*>(labels),                        \
                      static_cast<const float*>(lse),                         \
                      static_cast<const float*>(gw),                          \
                      static_cast<float*>(dw_part),                           \
                      static_cast<float*>(db_part), static_cast<float*>(dw),  \
                      static_cast<float*>(db), M, V, splits, per, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// the dynamic shared memory of the written-logits backward kernels at width
// H (bytes)
extern "C" int vct_fused_ce_mat_bwd_smem(int H) {
  switch (H) {
    case 64: return static_cast<int>(MatBwd<64>::SMEM);
    case 128: return static_cast<int>(MatBwd<128>::SMEM);
    case 256: return static_cast<int>(MatBwd<256>::SMEM);
    default: return static_cast<int>(MatBwd<512>::SMEM);
  }
}
