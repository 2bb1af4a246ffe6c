// Flash linear cross-entropy for Hopper (sm_90a): the forward (logsumexp and
// label logit), dh and dW/db, exported with a plain C interface and loaded
// through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ce.py:
// _fwd_kernel (:59), _dh_kernel (:134) and _dwdb_kernel (:159), called
// through fused_linear_ce.  The forward kernel, its merge launch and the
// WMMA tile helpers live in fused_ce.cuh, which the written-logits schedule
// (fused_ce_mat.cu) shares.
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
// (209 KB with alignment and barriers): one block per SM.  The forward is
// still the WMMA kernel of fused_ce.cuh.

#include "fused_ce.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>

namespace {

// ---------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spin until the barrier's phase of the given parity has completed; a
// phase that never completes (a lost transfer) traps after 2^35 clocks
// (about 17 s) instead of hanging the stream
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  }
}

// one box of a 2-D tensor map (x: column, y: row) into shared memory; the
// bytes complete on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the wgmma issue and wait points
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading byte offset (MN-major: the stride between 64-element column
// blocks; K-major: unused), stride byte offset 1024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// m64nNk16 bf16 x bf16 -> f32, A and B from shared memory; A K-major, B
// K-major (TRANS_B = 0) or MN-major (TRANS_B = 1); d = A·B + (scale_d ? d : 0)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b,
                                      int scale_d) {
  if constexpr (N == 32) wgmma_n32<TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_n64<TRANS_B>(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_n128<TRANS_B>(d, a, b, scale_d);
  else wgmma_n256<TRANS_B>(d, a, b, scale_d);
}

// ---------------------------------------------------------------------
// the backward template
// ---------------------------------------------------------------------

constexpr int BT = 64;                  // rows of Q and of a streamed K tile
constexpr int BWD_THREADS = 256;        // two consumer warpgroups
constexpr int BOX = 64;                 // columns of a TMA box (128 bytes)
constexpr int BOX_BYTES = BT * BOX * 2;  // 8 KB: 64 rows x 128 bytes, swizzled

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

// boxes [C0, C1) of the row tile at `row` into `dst`; the bytes complete
// on `bar`.  The box range is a compile-time constant: with a runtime loop
// here ptxas serialises the kernel's wgmmas (warning C7515).
template <int C0, int C1>
__device__ __forceinline__ void load_boxes(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int row) {
  mbar_expect_tx(bar, (C1 - C0) * BOX_BYTES);
#pragma unroll
  for (int c = C0; c < C1; ++c)
    tma_load(dst + c * BOX_BYTES, map, bar, c * BOX, row);
}

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
// host side: tensor maps and launches
// ---------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, through the runtime (no libcuda
// link); null when the driver has none
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a [rows, H] bf16 row-major matrix in boxes of 64 rows x 64 columns, with
// the 128-byte swizzle; rows past the end read zeros
int row_tile_map(CUtensorMap* map, const bf16* ptr, int rows, int H) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(H) * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BT};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

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

template <int H>
int launch_dh(const bf16* h, const bf16* w, const float* b, const int* labels,
              const float* lse, const float* gw, float* dh, int M, int V,
              cudaStream_t st) {
  const int v_tiles = (V + BT - 1) / BT;
  return launch_bwd<H, false>(h, M, w, V, b, labels, lse, gw, dh, nullptr, M, V,
                              1, v_tiles, st);
}

template <int H>
int launch_dwdb(const bf16* h, const bf16* w, const float* b, const int* labels,
                const float* lse, const float* gw, float* dw_part,
                float* db_part, float* dw, float* db, int M, int V, int splits,
                int per, cudaStream_t st) {
  int err = launch_bwd<H, true>(w, V, h, M, b, labels, lse, gw, dw_part, db_part,
                                M, V, splits, per, st);
  if (err) return err;
  const int Vp = (V + BT - 1) / BT * BT;
  err = sum_splits(dw_part, splits, static_cast<size_t>(Vp) * H,
                   static_cast<size_t>(V) * H, dw, st);
  if (err) return err;
  return sum_splits(db_part, splits, Vp, V, db, st);
}

}  // namespace

// Shape rule: H is 64, 128, 256 or 512; M and V anything positive.  Each
// returns a cudaError_t as int.
#define VCT_CE_ARGS                                                      \
  static_cast<const bf16*>(h), static_cast<const bf16*>(w),               \
      static_cast<const float*>(b), static_cast<const int*>(labels)

// h16 [M, H], w16 [V, H] bf16; b [V] f32; labels [M] int32 -> lse, ll [M]
// f32.  part: [chunks, M, 3] f32 workspace, chunks = ceil(ceil(V / 64) /
// chunk_tiles).
extern "C" int vct_fused_ce_fwd(const void* h, const void* w, const void* b,
                                const void* labels, void* part, void* lse,
                                void* ll, int M, int H, int V, int chunk_tiles,
                                void* stream) {
  if (bad_shape(M, H, V) || chunk_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_fwd<HH, false>(VCT_CE_ARGS, static_cast<float*>(part), nullptr,       \
                        static_cast<float*>(lse), static_cast<float*>(ll), M, \
                        V, chunk_tiles, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
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
                static_cast<const float*>(gw), static_cast<float*>(dh), M, V, \
                st)
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
  if (bad_shape(M, H, V) || splits <= 0 || per <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(HH)                                                              \
  launch_dwdb<HH>(VCT_CE_ARGS, static_cast<const float*>(lse),                \
                  static_cast<const float*>(gw), static_cast<float*>(dw_part),\
                  static_cast<float*>(db_part), static_cast<float*>(dw),      \
                  static_cast<float*>(db), M, V, splits, per, st)
  VCT_CE_SWITCH_H(CALL)
#undef CALL
}

// the dynamic shared memory of the backward kernels at width H (bytes)
extern "C" int vct_fused_ce_bwd_smem(int H) {
  switch (H) {
    case 64: return static_cast<int>(Bwd<64>::SMEM);
    case 128: return static_cast<int>(Bwd<128>::SMEM);
    case 256: return static_cast<int>(Bwd<256>::SMEM);
    default: return static_cast<int>(Bwd<512>::SMEM);
  }
}
