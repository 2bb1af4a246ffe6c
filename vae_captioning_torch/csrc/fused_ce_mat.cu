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
// The backward: one kernel template, ce_mat_bwd_kernel<CT, DW>, for both
// gradients, on the product loop of mat_ring.cuh (which the AG-heads
// backward products share).  A block owns 64 rows of the output (h rows for
// dh, vocab rows for dW) and streams the other operand K in tiles of 64
// rows, each with the matching 64 x 64 box of lg:
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
// * The ring (mat_ring.cuh): a stage holds a K tile and its lg box (a
//   tensor map over lg [M, Vp], 128-byte swizzle); 3 stages at H = 512
//   (216 KB), more below; two consumer warpgroups each own half of H
//   (m64n256 at H = 512); each leader refills its half of the K tile when
//   its product retires, the later of the two also the lg box.
// * dl in place, the loop's per-tile step: each thread reads two 16-byte
//   runs of the swizzled lg box, forms dl in f32 (db's sums too), and
//   writes bf16(dl) back into the same slots; a proxy fence and one named
//   barrier later the box is wgmma's A operand.  The dl step waits on no
//   tensor-core product, only on its tile's TMA load, and runs while the
//   previous tile's product is in flight.
// * Row operands: dh's lse, gw and labels belong to the block's own rows
//   and are loaded once; dW/db's belong to the streamed h rows and are
//   loaded a tile ahead, so that their latency hides behind a tile's work.
// * Ragged edges: TMA fills rows past M or V with zeros; rows past M carry
//   gw = 0 and lse = 0 (a zero lg gives p = exp(0) = 1, times gw = 0), so
//   they add nothing, and rows of weight 0 get dh exactly 0.
// * Determinism: no float atomics.  db's sums run in a fixed order (tiles,
//   then lanes by shuffle, then warps); dW/db's row splits write [splits,
//   Vp, H] partials that a last launch sums in split order (db alike), so
//   the gradients repeat bit for bit.  At one split (H = 1024 at the train
//   shapes) the caller may take the partials as dW and db and skip that
//   launch, a copy of 45 MiB: the same values, but for the sign of an
//   element whose every product is a zero, which the copy's 0 + x makes +0.
// * Past H = 512: output column tiles.  A block owns CT output columns
//   (grid z), CT = 512 at m64n256 a warpgroup, as at H = 512 (the [64, H]
//   output would not fit two warpgroups' registers past it, nor a K tile
//   beside a ring); what is left of H past a multiple of 512 takes one
//   launch each of 256, 128 and 64 columns (ops/fused_ce.py: col_tiles).
//   dl is formed from the lg box with no product, so a column tile only
//   reads lg again and forms dl again: the tensor operations stay 2·M·H·V.
//   db comes from the z = 0 blocks of the first launch.

#include "fused_ce.cuh"
#include "hopper.cuh"
#include "mat_ring.cuh"

namespace {

constexpr int MAT_WARPS = MAT_THREADS / 32;

// the written-logits backward's shared memory at width H: the ring and
// db's exchange (a 64-column row per warp)
template <int H>
__host__ __device__ constexpr size_t mat_bwd_smem() {
  return MatRing<H>::smem(MAT_WARPS * BT * sizeof(float));
}

// Grid (output row tiles, K ranges, column tiles).  Block (x, y, z) owns
// output rows [64x, 64x + 64), K tiles [y·per, min(k_tiles, (y + 1)·per)),
// at least one, and output columns [e_base + CT·z, e_base + CT·(z + 1)) of
// H (at H <= 512: CT = H, one tile).
//   DW = false: K = W; out = dh [64·gridDim.x, H].
//   DW = true:  K = h; out = dw_part [gridDim.y, 64·gridDim.x, H],
//               db_part [gridDim.y, 64·gridDim.x] (written by the z = 0
//               blocks where db_part is not null).
template <int CT, bool DW>
__global__ void __launch_bounds__(MAT_THREADS, 1)
ce_mat_bwd_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap lg_map,
                  const int* __restrict__ labels, const float* __restrict__ lse,
                  const float* __restrict__ gw, float* __restrict__ out,
                  float* __restrict__ db_part, int M, int k_tiles, int per, int H,
                  int e_base) {
  using P = MatRing<CT>;
  static_assert(mat_bwd_smem<CT>() <= 232448, "one block per SM: 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  float* db_s = reinterpret_cast<float*>(mat_ring_extra<CT>(ring));
  const int e0 = e_base + blockIdx.z * CT;   // the block's first output column

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int x0 = blockIdx.x * BT;
  const int t0 = blockIdx.y * per;
  const int n_tiles = min(k_tiles, t0 + per) - t0;

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
  float db_run[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  // the dl step of tile i in its lg box
  auto dl_step = [&](int i, unsigned char* lg_box, auto&& wait) {
    const int k0 = (t0 + i) * BT;        // the tile's first K row
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
    wait();
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
  };

  float acc[P::ACC];
  mat_ring_product<CT, DW>(acc, ring, &k_map, &lg_map, x0, e0, t0, n_tiles, dl_step);

  // the [64, CT] f32 block of dh, or of this split's dW partial
  const int Xp = gridDim.x * BT;
  mat_ring_store<CT>(acc, out + (DW ? static_cast<size_t>(blockIdx.y) * Xp * H : 0), H,
                     x0, e0);
  if constexpr (DW) {
    if (db_part == nullptr || blockIdx.z != 0) return;
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

// K [k_rows, H] streamed against lg [M, Vp]; grid (out_tiles, splits,
// tiles), each block over `per` K tiles and CT columns from e_base
template <int CT, bool DW>
int launch_mat_ct(const CUtensorMap& k_map, const CUtensorMap& lg_map, int k_rows,
                  const int* labels, const float* lse, const float* gw, float* out,
                  float* db_part, int M, int H, int out_tiles, int splits, int per,
                  int tiles, int e_base, cudaStream_t st) {
  constexpr size_t smem = mat_bwd_smem<CT>();
  int err = allow_smem(ce_mat_bwd_kernel<CT, DW>, smem);
  if (err) return err;
  ce_mat_bwd_kernel<CT, DW><<<dim3(out_tiles, splits, tiles), MAT_THREADS, smem, st>>>(
      k_map, lg_map, labels, lse, gw, out, db_part, M, (k_rows + BT - 1) / BT, per, H,
      e_base);
  return static_cast<int>(cudaGetLastError());
}

// HH: H at compile time (64..512), one column tile; 0: past 512, column
// tiles of 512 (one launch, grid z), then one launch each of 256, 128 and
// 64 for what is left of H (ops/fused_ce.py: col_tiles); db from the first
template <int HH, bool DW>
int launch_mat_bwd(const bf16* k, int k_rows, const bf16* lg, const int* labels,
                   const float* lse, const float* gw, float* out, float* db_part,
                   int M, int H, int V, int out_tiles, int splits, int per,
                   cudaStream_t st) {
  CUtensorMap k_map, lg_map;
  int err = row_tile_map(&k_map, k, k_rows, H);
  if (err) return err;
  // lg is a [M, Vp] bf16 matrix: the same 64 x 64 boxes and swizzle
  err = row_tile_map(&lg_map, lg, M, logits_pitch(V));
  if (err) return err;
#define VCT_MAT(CT, TILES, E)                                                  \
  launch_mat_ct<CT, DW>(k_map, lg_map, k_rows, labels, lse, gw, out,           \
                        (E) == 0 ? db_part : nullptr, M, H, out_tiles, splits, \
                        per, TILES, E, st)
  if constexpr (HH > 0) {
    return VCT_MAT(HH, 1, 0);
  } else {
    int e = H / 512 * 512;
    err = VCT_MAT(512, H / 512, 0);
    if (!err && H - e >= 256) { err = VCT_MAT(256, 1, e); e += 256; }
    if (!err && H - e >= 128) { err = VCT_MAT(128, 1, e); e += 128; }
    if (!err && H - e >= 64) err = VCT_MAT(64, 1, e);
    return err;
  }
#undef VCT_MAT
}

template <int HH>
int launch_mat_dh(const bf16* lg, const bf16* w, const int* labels,
                  const float* lse, const float* gw, float* dh, int M, int H, int V,
                  cudaStream_t st) {
  const int v_tiles = (V + BT - 1) / BT;
  return launch_mat_bwd<HH, false>(w, V, lg, labels, lse, gw, dh, nullptr, M, H, V,
                                   (M + BT - 1) / BT, 1, v_tiles, st);
}

template <int HH>
int launch_mat_dwdb(const bf16* h, const bf16* lg, const int* labels,
                    const float* lse, const float* gw, float* dw_part,
                    float* db_part, float* dw, float* db, int M, int H, int V,
                    int splits, int per, cudaStream_t st) {
  const int v_tiles = (V + BT - 1) / BT;
  int err = launch_mat_bwd<HH, true>(h, M, lg, labels, lse, gw, dw_part, db_part,
                                     M, H, V, v_tiles, splits, per, st);
  if (err || dw == nullptr) return err;
  const int Vp = v_tiles * BT;
  err = sum_splits(dw_part, splits, static_cast<size_t>(Vp) * H,
                   static_cast<size_t>(V) * H, dw, st);
  if (err) return err;
  return sum_splits(db_part, splits, Vp, V, db, st);
}

}  // namespace

// Shape rule: H is 64, 128, 256, 512, or past 512 a multiple of 64 up to
// CE_H_MAX; M and V anything positive; lg is [M, 64 ceil(V / 64)] bf16.
// Each returns a cudaError_t as int.

// h16 [M, H], w16 [V, H] bf16; b [V] f32; labels [M] int32 -> lg [M, Vp]
// bf16, lse, ll [M] f32.  A block takes chunk_tiles vocab tiles of 128
// columns; part: [chunks · (rows == 64 ? 2 : 1), M, 3] f32 workspace,
// chunks = ceil(ceil(V / 128) / chunk_tiles), rows from
// vct_fused_ce_fwd_block (ops/fused_ce.py's ce_fwd_plan).
extern "C" int vct_fused_ce_mat_fwd(const void* h, const void* w, const void* b,
                                    const void* labels, void* part, void* lg,
                                    void* lse, void* ll, int M, int H, int V,
                                    int chunk_tiles, void* stream) {
  if (bad_shape(M, H, V) || chunk_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_h<true>(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                            static_cast<const float*>(b), static_cast<const int*>(labels),
                            static_cast<float*>(part), static_cast<bf16*>(lg),
                            static_cast<float*>(lse), static_cast<float*>(ll), M, H, V,
                            chunk_tiles, static_cast<cudaStream_t>(stream));
}

// the launches of the written-logits forward's cluster instances in this
// process
extern "C" int vct_fused_ce_mat_fwd_cluster_launches() { return fwd_cluster_launches; }

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
                    H, V, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// h16 [M, H] bf16, lg [M, Vp] bf16, labels [M] int32, lse, gw [M] f32 -> dw
// [V, H], db [V] f32.  Split y sums the 64-row tiles [y * per, min(ceil(M /
// 64), (y + 1) * per)) of h.  Workspaces: dw_part [splits, Vp, H], db_part
// [splits, Vp] f32.  With dw and db null (one split only) nothing is
// summed: dW and db are the partials' first V rows.
extern "C" int vct_fused_ce_mat_dwdb(const void* h, const void* lg,
                                     const void* labels, const void* lse,
                                     const void* gw, void* dw_part,
                                     void* db_part, void* dw, void* db, int M,
                                     int H, int V, int splits, int per,
                                     void* stream) {
  // every split takes at least one row tile (mat_ring_product)
  if (bad_shape(M, H, V) || splits <= 0 || per <= 0 ||
      static_cast<long>(splits - 1) * per >= (M + BT - 1) / BT ||
      (dw == nullptr) != (db == nullptr) || (dw == nullptr && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_mat_dwdb<HH>(static_cast<const bf16*>(h), static_cast<const bf16*>(lg), \
                      static_cast<const int*>(labels),                        \
                      static_cast<const float*>(lse),                         \
                      static_cast<const float*>(gw),                          \
                      static_cast<float*>(dw_part),                           \
                      static_cast<float*>(db_part), static_cast<float*>(dw),  \
                      static_cast<float*>(db), M, H, V, splits, per, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// the dynamic shared memory of the written-logits backward kernels of CT
// columns (bytes): CT = H at H = 64 .. 512; past 512 the column tiles of
// 512 (and of 64 .. 256 for the rest of H, which take less)
extern "C" int vct_fused_ce_mat_bwd_smem(int H) {
  switch (H) {
    case 64: return static_cast<int>(mat_bwd_smem<64>());
    case 128: return static_cast<int>(mat_bwd_smem<128>());
    case 256: return static_cast<int>(mat_bwd_smem<256>());
    default: return static_cast<int>(mat_bwd_smem<512>());
  }
}
