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
// What bounds it on this card: at the train shapes (T = 24, N = 1280, E =
// 256, H = 512) the forward is 96.6 GFLOP (0.098 ms at 989 TFLOP/s) and
// the backward twice that, but each step's product depends on the step
// before, so the T steps run one after the other, and a step is a small
// product (1280 x 2048 x 768, 4 GFLOP) that no tiling spreads over 132 SMs
// at the tensor cores' rate: a step is bound by the bytes its blocks
// stream from L2 (every row tile reads all of the weights, every unit tile
// all of its rows), by how many of them a block keeps in flight, and by
// the latency between launches.  On the TPU one kernel walks t outermost
// and keeps (c, h) in VMEM; blocks on Hopper run in no order and Wh (2 MiB
// bf16) does not fit one block, so here a step is one launch from a host
// loop, and the step loop is shaped by three things measured on the card:
// two blocks an SM stream more than one block with a ring twice as deep;
// an epilogue that reads and writes in the accumulators' fragment order
// (8 rows a warp instruction) costs as much as the step's product; and
// the launch gap and a step's first stages are hidden by programmatic
// dependent launch (PDL), which lets a step's blocks start while the step
// before finishes.  So:
//
// * Forward, one wgmma + TMA launch a step: lstm_cell.cuh's
//   lstm_cell_kernel<32, SeqEpi>, the decode step's product loop (two
//   warpgroups, the four gates of a unit in one thread's registers, each
//   64-deep stage's sum added in f32 registers) on 64 rows x 64 units a
//   block, with A = [x_t | bf16(h)] streamed in the ring beside the
//   weights' gate slabs (2 stages of 40 KB: two blocks an SM).  Its
//   epilogue stages the gate tiles in shared memory and walks whole rows:
//   the mask t < lengths[n], cs[t] (f32), hs[t] (bf16, zero where masked),
//   ga[t] (bf16), the f32 h carry (written where the row steps) and a bf16
//   copy of the h carry, which the next step's A reads by TMA: no block
//   converts h.  With PDL a step's x stages stream while the step before
//   finishes.  hbuf [T + 1, N, H] bf16 holds bf16(h0) (slot 0) and hs
//   (slots 1..T), so the backward's h_prev stack [bf16(h0); hs[0 .. T-2]]
//   is slots 0..T-1 without a copy; the bf16 carry [2, N, H] is a
//   workspace of the call.  (The carry is not hs: a masked row's hs is
//   zero, its carry is not, and its gates, which ga keeps, read the
//   carry.)
// * Backward, one wgmma + TMA launch a step on the recurrence, then the
//   products that do not recur (seq_bwd_kernel<WG, MODE>):
//   - step t (MODE STEP): dh_prev = dg_t @ Wh^T (+ dht for rows masked at
//     t: a masked row's dh carry is dht, since every later step of it is
//     masked too) for 64 rows x 64 units, dg_t's box and Wh's box
//     (K-major: Wh is [H, 4H]) through a 4-stage TMA ring, accumulated in
//     the tensor cores with one group in flight.  The epilogue is the gate
//     derivatives of step t-1 for the same rows and units: the dh tile the
//     block owns is the dh carry they need, so dh never reaches device
//     memory.  The tile goes through shared memory and the epilogue walks
//     whole rows: ga[t-1] and dhs[t-1] come in as boxes by TMA while the
//     product runs, cs[t-1], cs[t-2] (or c0) and the dc carry from memory; it writes dg[t-1] (bf16), the
//     next dc carry (two f32 buffers in turns, the last one dc0) and the
//     block's f32 db partial (its rows summed in registers, its four warps
//     in order).  ga, dhs and the weight boxes of the first stages come in
//     before the PDL wait, dg's boxes after it.  MODE GATES is that
//     epilogue alone for step T-1 (dh = dht), MODE FIRST step 0's product
//     into dh0.  A block takes 110 KB: two an SM.
//   - after the loop: dx = dg @ Wx^T over all T·N rows (MODE DX, the same
//     product with a store epilogue: each row of dx depends only on its
//     own dg row), and dWx = x^T·dg, dWh = h_prev^T·dg on mat_ring.cuh's
//     A^T·B loop (seq_dw_kernel<CT>, DW) with the T·N rows split into
//     ranges so that each grid fills the SMs once; the splits and the db
//     partials are summed in a fixed order.  dg [T, N, 4H] bf16 is the
//     only large workspace.
// * PDL chains: the forward's step 0 and the backward's GATES launch are
//   launched without the attribute, so they start after every kernel
//   before them in the stream has completed; every later launch of the
//   chain has it.  What a launch reads before its wait (x, the weights,
//   ga, dhs) was then complete before the chain's first launch started,
//   and nothing in the chain writes it; what the launch before it writes
//   (h's carry, dg, the dc carry) is read after the wait.
// * Shared memory does not depend on the shape: every layout is fixed at
//   compile time, and static_asserts hold it to 227 KB a block (two
//   blocks an SM for the steps).  ops/fused_lstm_seq.py's lstm_seq_plan
//   picks WG for dx, CT and the splits.
// * Determinism: no float atomics; every cross-block sum is a partial
//   buffer reduced in a fixed order.  A persistent kernel with a grid-wide
//   barrier between steps was not built: PDL already overlaps a step's
//   launch and first stages with the step before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"
#include "mat_ring.cuh"

namespace {

constexpr int THREADS = 256;     // the partial sums

// ---------------------------------------------------------------------
// forward: the cell's sequence epilogue
// ---------------------------------------------------------------------
struct SeqEpi {
  static constexpr bool STREAM_A = true;   // A's boxes by TMA, h's from the bf16 carry
  const float* c;          // c carry before step t: c0 or cs[t-1]
  const float* b;          // [4H]
  const int* lengths;      // [N]
  float* cs_t;             // cs[t] [N, H] f32
  bf16* hs_t;              // hs[t] [N, H] bf16 (slot t + 1)
  bf16* ga_t;              // ga[t] [N, 4H] bf16
  const bf16* hb_cur;      // the bf16 carry A's h was read from
  bf16* hb_next;           // the bf16 carry after step t
  float* h_T;              // the f32 h carry, written where the row steps
  const float* h0;         // at t = 0 h0 (the masked rows' h_T), else null
  float forget_bias;
  int t, H;

  __device__ __forceinline__ void store(int row, size_t o, int u, const float2 (&s)[4],
                                        float2 cc, float2 nc, float2 nh) const {
    const bool m = t < __ldg(&lengths[row]);
    *reinterpret_cast<float2*>(&cs_t[o]) = m ? nc : cc;
    *reinterpret_cast<__nv_bfloat162*>(&hs_t[o]) =
        m ? __floats2bfloat162_rn(nh.x, nh.y) : __floats2bfloat162_rn(0.0f, 0.0f);
    bf16* g = &ga_t[static_cast<size_t>(row) * 4 * H + u];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<__nv_bfloat162*>(&g[q * H]) = __floats2bfloat162_rn(s[q].x, s[q].y);
    *reinterpret_cast<__nv_bfloat162*>(&hb_next[o]) =
        m ? __floats2bfloat162_rn(nh.x, nh.y)
          : *reinterpret_cast<const __nv_bfloat162*>(&hb_cur[o]);
    if (m)
      *reinterpret_cast<float2*>(&h_T[o]) = nh;
    else if (h0 != nullptr)
      *reinterpret_cast<float2*>(&h_T[o]) = *reinterpret_cast<const float2*>(&h0[o]);
  }
};

// ---------------------------------------------------------------------
// backward, per step: dh_prev = dg_t @ Wh^T with the gate derivatives of
// step t-1 in its epilogue (and the products of that shape)
// ---------------------------------------------------------------------
enum BwdMode { BWD_GATES = 0, BWD_STEP = 1, BWD_FIRST = 2, BWD_DX = 3 };

// a block: 64 rows x 64·WG units, one consumer warpgroup per 64 units (WG
// = 2 only for dx); a ring stage holds the 64 x 64 A box and WG weight
// boxes (64 units x 64 K).  The gate modes (GATES, STEP) also hold the
// block's ga boxes (four gates) and dhs box of step s, and the db
// reduction.  Every block takes at most 110 KB: two run on an SM.
template <int WG, int MODE>
struct BwdLayout {
  static constexpr bool PRODUCT = MODE != BWD_GATES;
  static constexpr bool GATES = MODE == BWD_GATES || MODE == BWD_STEP;
  static constexpr int STAGE = (1 + WG) * BOX_BYTES;
  static constexpr int STAGES = MODE == BWD_DX && WG == 1 ? 6 : 4;
  static constexpr int RING = PRODUCT ? STAGES * STAGE : 0;
  static constexpr int OPS = GATES ? 5 * BOX_BYTES : 0;          // ga x 4, dhs
  static constexpr int BARS = (STAGES + 1) * sizeof(uint64_t) + STAGES * sizeof(uint32_t);
  static constexpr int RED = GATES ? 4 * 4 * 64 * 4 : 0;         // [warp][gate][unit] f32
  // 1 KB to align to the swizzle's period; the ring, the operand boxes, the
  // barriers (the ring's full barriers and release counters, the operands'
  // barrier), the db reduction
  static constexpr size_t SMEM = 1024 + RING + OPS + BARS + RED;
  static_assert(WG == 1 || MODE == BWD_DX, "two warpgroups only for dx");
  static_assert(!PRODUCT || RING >= WG * 64 * (64 + 8) * 4, "the staged tile fits the ring");
};

struct BwdArgs {
  const int* lengths;     // [N]
  const float* cs;        // [T, N, H]
  const float* c0;        // [N, H]
  const float* dht;       // [N, H]: the dh carry of every row masked at t
  const float* dc_in;     // the dc carry into step t-1 (GATES: dct)
  float* dc_out;          // the dc carry out of it
  bf16* dg;               // [T, N, 4H]
  float* db_part;         // [T, ceil(N / 64), 4H]
  float* out;             // FIRST: dh0 [N, H]; DX: dx [T·N, E]
  int t;                  // STEP: the product's step (gates of t-1); GATES: the gates' step
  int N, H;
  int rows, ld;           // the product's rows and out's row pitch (DX: T·N, E)
  int a_row;              // the A map's row of the block's row 0 (STEP: t·N)
  int k_tiles;            // 4H / 64
};

// Grid (ceil(rows / 64), units / (64·WG)).  Block (x, y) owns rows [64x,
// 64x + 64) and units [64·WG·y, 64·WG·y + 64·WG), warpgroup w 64 of them.
// The A map is dg [T·N, 4H]; the weight map Wh [H, 4H] (Wx for DX), read
// K-major; ga_map [T·N, 4H] and dhs_map [T·N, H] bring the gate modes'
// bf16 operands.  Every launch but GATES has the PDL attribute.
template <int WG, int MODE>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? 2 : 1)
seq_bwd_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap ga_map,
               const __grid_constant__ CUtensorMap dhs_map, const BwdArgs args) {
  using L = BwdLayout<WG, MODE>;
  constexpr bool PRODUCT = L::PRODUCT;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* ops = ring + L::RING;           // ga boxes 0..3, dhs box 4
  uint64_t* full = reinterpret_cast<uint64_t*>(ops + L::OPS);
  uint64_t* ops_bar = full + L::STAGES;
  uint32_t* released = reinterpret_cast<uint32_t*>(ops_bar + 1);
  float* red = reinterpret_cast<float*>(released + L::STAGES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int m0 = blockIdx.x * 64;
  const int j0 = blockIdx.y * 64 * WG;
  const int uw = j0 + 64 * wg;     // this warpgroup's first unit
  const int N = args.N, H = args.H;
  const int t = args.t;
  const int s = MODE == BWD_GATES ? t : t - 1;   // the gate modes' step
  pdl_launch_next();
  if (tid == 0) {
    for (int q = 0; q < L::STAGES; ++q) {
      mbar_init(&full[q], 1);
      released[q] = 0;
    }
    mbar_init(ops_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (L::GATES) {
      // the gate derivatives' bf16 operands of step s (the forward's ga,
      // the caller's dhs), while the product runs: read before the PDL
      // wait, since nothing in this chain writes them and the chain's first
      // launch (GATES) has no PDL attribute, so it started after their
      // writers completed
      mbar_expect_tx(ops_bar, L::OPS);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load(ops + q * BOX_BYTES, &ga_map, ops_bar, q * H + uw, s * N + m0);
      tma_load(ops + 4 * BOX_BYTES, &dhs_map, ops_bar, uw, s * N + m0);
    }
  }
  __syncthreads();

  // this warpgroup's [64 x 64] tile: the product's first k16 step
  // overwrites it (scale_d 0)
  float acc[32];
  if constexpr (PRODUCT) {
    const int KT = args.k_tiles;
    // K tile kt into slot kt % STAGES: the stage's bytes and weight boxes
    // where `w`, its A box where `a`
    auto load = [&](int kt, bool w, bool a) {
      const int q = kt % L::STAGES;
      unsigned char* dst = ring + q * L::STAGE;
      if (w) {
        mbar_expect_tx(&full[q], L::STAGE);
#pragma unroll
        for (int b = 0; b < WG; ++b)
          tma_load(dst + (1 + b) * BOX_BYTES, &w_map, &full[q], kt * BOX, j0 + 64 * b);
      }
      if (a) tma_load(dst, &a_map, &full[q], kt * BOX, args.a_row + m0);
    };
    // this warpgroup's products of tile kt retired: with one warpgroup its
    // leader refills the slot; with two, the later of the two leaders
    auto release = [&](int kt) {
      if (!leader) return;
      const int q = kt % L::STAGES;
      bool last = true;
      if constexpr (WG == 2) {
        __threadfence_block();
        last = atomicAdd(&released[q], 1u) & 1u;
        __threadfence_block();
      }
      if (last && kt + L::STAGES < KT) load(kt + L::STAGES, true, true);
    };
    // the weight boxes of the first stages come in while the grid before
    // finishes, the A boxes (dg, which it wrote) after it
    if (tid == 0)
      for (int kt = 0; kt < min(L::STAGES, KT); ++kt) load(kt, true, false);
    pdl_wait();
    if (tid == 0)
      for (int kt = 0; kt < min(L::STAGES, KT); ++kt) load(kt, false, true);

    // [64 x 64] += A box (rows x K, K-major) @ weight box^T (units x K,
    // K-major): k16 steps of 32 bytes along both boxes' rows.  One group
    // in flight: a tile's products are issued before the previous tile's
    // retire, and that tile's slot is then refilled.
    const uint32_t ring_addr = smem_addr(ring);
    for (int kt = 0; kt < KT; ++kt) {
      const int q = kt % L::STAGES;
      mbar_wait(&full[q], (kt / L::STAGES) & 1);
      const uint32_t stage = ring_addr + q * L::STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<64, 0, 0>(acc, sw128_desc(stage + kk * 32, 16),
                        sw128_desc(stage + (1 + wg) * BOX_BYTES + kk * 32, 16),
                        (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) release(kt - 1);
    }
    wgmma_wait<0>();
    reg_fence(acc);
  } else {
    pdl_wait();
  }

  // The product's tile goes to shared memory (the ring, free now), so that
  // the epilogue walks whole rows: warp w of a warpgroup takes its rows 16w
  // .. 16w + 15, lane l its units 2l, 2l + 1, and every access of a warp is
  // one row's contiguous run (a fragment's access spans 8 rows).
  // Fragment: rows warp·16 + lane / 4 + 8i, columns 8n + 2·(lane % 4) + j
  // at register 4n + 2i + j.  Every register is stored: a store of the
  // accumulators under a test would serialise the wgmmas (C7515).
  constexpr int LD = 64 + 8;      // the staged tile's row pitch (floats)
  float* tile = reinterpret_cast<float*>(ring) + wg * 64 * LD;
  if constexpr (PRODUCT) {
    __syncthreads();              // every product has read the ring
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            &tile[(warp * 16 + lane / 4 + 8 * i) * LD + 8 * n + 2 * (lane % 4)]) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    __syncthreads();
  }
  const int u = uw + 2 * lane;     // this lane's units u, u + 1
  const int r0 = m0 + warp * 16;   // this warp's first row
  if constexpr (MODE == BWD_DX) {
    for (int rr = 0; rr < 16 && r0 + rr < args.rows; ++rr)
      *reinterpret_cast<float2*>(&args.out[static_cast<size_t>(r0 + rr) * args.ld + u]) =
          *reinterpret_cast<const float2*>(&tile[(warp * 16 + rr) * LD + 2 * lane]);
    return;
  }
  if constexpr (MODE == BWD_FIRST) {
    for (int rr = 0; rr < 16 && r0 + rr < N; ++rr) {
      const size_t o = static_cast<size_t>(r0 + rr) * H + u;
      float2 dh = *reinterpret_cast<const float2*>(&tile[(warp * 16 + rr) * LD + 2 * lane]);
      if (t >= __ldg(&args.lengths[r0 + rr])) {
        const float2 p = __ldg(reinterpret_cast<const float2*>(&args.dht[o]));
        dh.x += p.x;
        dh.y += p.y;
      }
      *reinterpret_cast<float2*>(&args.out[o]) = dh;
    }
    return;
  }

  // The gate derivatives of step s for the warp's 16 rows.  ga and dhs
  // come from the operand boxes (128-byte swizzle: row r's 16-byte chunk c
  // at r·128 + ((c ^ r % 8)·16); the lane's units are chunk l / 4, bytes
  // 4·(l % 4) in it), the f32 operands from memory: every one is read-only
  // here (the dc carry goes to the other buffer), so a lane loads those of
  // all 16 rows before it computes any, and their latencies overlap (4 rows
  // at a time took 6% longer a step on the H100).  The f32 dgates of a
  // lane's units are summed over the warp's rows in registers, then the
  // block's four warps in order.
  const size_t nh = static_cast<size_t>(N) * H;
  const float* c_t = args.cs + static_cast<size_t>(s) * nh;
  const float* c_p = s == 0 ? args.c0 : args.cs + static_cast<size_t>(s - 1) * nh;
  bf16* dg = args.dg + static_cast<size_t>(s) * nh * 4;
  mbar_wait(ops_bar, 0);
  constexpr int ROWS = 16;          // a warp's rows
  float db[4][2] = {};             // gate q, unit j
  {
    float2 sg[ROWS][4], ct[ROWS], cp[ROWS], dcc[ROWS], dy[ROWS], dh[ROWS];
    bool m[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      // rows past N load row N - 1 and store nothing
      const int rr = warp * 16 + k;
      const int row = min(m0 + rr, N - 1);
      const size_t o = static_cast<size_t>(row) * H + u;
      const int len = __ldg(&args.lengths[row]);
      m[k] = s < len;              // the row steps at s
      const int at = rr * 128 + (((lane / 4) ^ (rr % 8)) * 16) + 4 * (lane % 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sg[k][q] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ops + q * BOX_BYTES + at));
      dy[k] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ops + 4 * BOX_BYTES + at));
      ct[k] = __ldg(reinterpret_cast<const float2*>(&c_t[o]));
      cp[k] = __ldg(reinterpret_cast<const float2*>(&c_p[o]));
      dcc[k] = __ldg(reinterpret_cast<const float2*>(&args.dc_in[o]));
      if constexpr (MODE == BWD_GATES) {
        dh[k] = __ldg(reinterpret_cast<const float2*>(&args.dht[o]));
      } else {
        // STEP: the product's row; a row masked at t carries dht
        dh[k] = *reinterpret_cast<const float2*>(&tile[rr * LD + 2 * lane]);
        if (t >= len) {
          const float2 p = __ldg(reinterpret_cast<const float2*>(&args.dht[o]));
          dh[k].x += p.x;
          dh[k].y += p.y;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (r0 + k >= N) break;
      float d[4][2], dc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const auto pick = [j](float2 v) { return j ? v.y : v.x; };
        const float si = pick(sg[k][0]), sf = pick(sg[k][1]);
        const float tg = pick(sg[k][2]), so = pick(sg[k][3]);
        const float dcj = pick(dcc[k]);
        const float dnh = m[k] ? pick(dh[k]) + pick(dy[k]) : 0.0f;
        const float tanh_c = tanhf(pick(ct[k]));
        const float dnc = dnh * so * (1.0f - tanh_c * tanh_c) + (m[k] ? dcj : 0.0f);
        d[0][j] = dnc * tg * si * (1.0f - si);
        d[1][j] = dnc * pick(cp[k]) * sf * (1.0f - sf);
        d[2][j] = dnc * si * (1.0f - tg * tg);
        d[3][j] = dnh * tanh_c * so * (1.0f - so);
        dc[j] = dnc * sf + (m[k] ? 0.0f : dcj);
      }
      const size_t row = static_cast<size_t>(r0 + k);
      *reinterpret_cast<float2*>(&args.dc_out[row * H + u]) = make_float2(dc[0], dc[1]);
      bf16* out = &dg[row * 4 * H + u];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<__nv_bfloat162*>(&out[q * H]) = __floats2bfloat162_rn(d[q][0], d[q][1]);
        db[q][0] += d[q][0];
        db[q][1] += d[q][1];
      }
    }
  }
  // db: [warp][gate][64 units] in shared memory, the warps summed in order
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float2*>(&red[(warp * 4 + q) * 64 + 2 * lane]) =
        make_float2(db[q][0], db[q][1]);
  __syncthreads();
  float* part = args.db_part +
                (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 4 * H;
  for (int e = tid; e < 4 * 64; e += 128) {
    const int q = e / 64, uu = e % 64;
    const float* v = &red[q * 64 + uu];
    part[q * H + uw + uu] = ((v[0] + v[4 * 64]) + v[8 * 64]) + v[12 * 64];
  }
}

// ---------------------------------------------------------------------
// weight gradients: part[z] = A[rows of split z]^T @ dg[the same rows]
// ---------------------------------------------------------------------
// Grid (KO / 64, 4H / CT, splits).  Block (x, y, z) owns output rows [64x,
// 64x + 64) (A's columns), columns [CT·y, CT·y + CT) (dg's) and the K tiles
// (64 rows of T·N) [z·per, min(k_tiles, (z + 1)·per)), at least one:
// mat_ring.cuh's product loop with A read transposed (DW).
template <int CT>
__global__ void __launch_bounds__(MAT_THREADS, 1)
seq_dw_kernel(const __grid_constant__ CUtensorMap dg_map,
              const __grid_constant__ CUtensorMap a_map, float* __restrict__ part,
              int ko, int G, int k_tiles, int per) {
  static_assert(MatRing<CT>::smem(0) <= 232448, "one block per SM: 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int x0 = blockIdx.x * BT;
  const int e0 = blockIdx.y * CT;
  const int t0 = blockIdx.z * per;
  float acc[MatRing<CT>::ACC];
  mat_ring_product<CT, true>(acc, ring, &dg_map, &a_map, x0, e0, t0,
                             min(k_tiles, t0 + per) - t0,
                             [](int, unsigned char*, auto&& wait) { wait(); });
  mat_ring_store<CT>(acc, part + static_cast<size_t>(blockIdx.z) * ko * G, G, x0, e0);
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

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

// the forward's T launches: lstm_cell_kernel<32, SeqEpi> (64 rows x 64
// units a block), A streamed through the ring's STREAM_STAGES stages;
// every launch but step 0's with the PDL attribute
using SeqCell = CellShape<32, true>;
constexpr size_t SEQ_FWD_SMEM = SeqCell::smem(0, SeqCell::STREAM_STAGES);
static_assert(SeqCell::STREAM_STAGES * SeqCell::STAGE >= SeqCell::TILE_BYTES,
              "the staged gate tiles fit the ring");
static_assert(2 * (SEQ_FWD_SMEM + 1024) <= 233472,
              "two blocks an SM: 228 KB, 1 KB of it each block's own");

int launch_fwd(const void* x, const void* wx, const void* wh, const void* b,
               const void* lengths, const void* c0, const void* h0, bf16* hbuf,
               bf16* hcarry, float* cs, bf16* ga, float* h_T, int T, int N, int E, int H,
               cudaStream_t st) {
  constexpr int U = 32;
  using S = SeqCell;
  constexpr size_t smem = SEQ_FWD_SMEM;
  CUtensorMap x_map, wx_map, wh_map, h0_map, carry_map;
  int err = row_tile_map(&x_map, static_cast<const bf16*>(x), T * N, E);
  if (!err) err = row_tile_map(&wx_map, static_cast<const bf16*>(wx), E, 4 * H);
  if (!err) err = row_tile_map(&wh_map, static_cast<const bf16*>(wh), H, 4 * H);
  if (!err) err = row_tile_map(&h0_map, hbuf, N, H);
  if (!err) err = row_tile_map(&carry_map, hcarry, 2 * N, H);
  if (!err) err = allow_cell_smem<U, SeqEpi>(smem);
  if (err) return err;
  SeqEpi epi{};
  epi.b = static_cast<const float*>(b);
  epi.lengths = static_cast<const int*>(lengths);
  epi.h_T = h_T;
  epi.forget_bias = 1.0f;
  epi.H = H;
  const size_t nh = static_cast<size_t>(N) * H;
  const dim3 grid((N + CELL_ROWS - 1) / CELL_ROWS, (H + 2 * U - 1) / (2 * U));
  for (int t = 0; t < T; ++t) {
    // A's h: bf16(h0) (hbuf's slot 0) at t = 0, then the carry's slots in
    // turns; hs[t] in hbuf's slot t + 1
    const int cur = (t + 1) % 2;       // the carry slot A's h is read from (t > 0)
    epi.c = t == 0 ? static_cast<const float*>(c0) : cs + (t - 1) * nh;
    epi.cs_t = cs + t * nh;
    epi.hs_t = hbuf + (t + 1) * nh;
    epi.ga_t = ga + t * 4 * nh;
    epi.hb_cur = t == 0 ? hbuf : hcarry + cur * nh;
    epi.hb_next = hcarry + (t % 2) * nh;
    epi.h0 = t == 0 ? static_cast<const float*>(h0) : nullptr;
    epi.t = t;
    const CellGeometry geo{N, E, H, t * N, t == 0 ? 0 : cur * N, 0, 0, S::STREAM_STAGES};
    err = launch_pdl(lstm_cell_kernel<U, SeqEpi>, grid, S::THREADS, smem, st, t > 0, x_map,
                     wx_map, wh_map, t == 0 ? h0_map : carry_map, epi, geo);
    if (err) return err;
  }
  return 0;
}

// the backward's tensor maps: dg [T·N, 4H] (A), the weights Wh [H, 4H] or
// Wx [E, 4H], ga [T·N, 4H] and dhs [T·N, H]
struct BwdMaps {
  CUtensorMap dg, w, ga, dhs;
};

// every launch but the backward's first (GATES) with the PDL attribute
template <int WG, int MODE>
int launch_bwd(const BwdMaps& maps, const BwdArgs& args, int units, cudaStream_t st) {
  constexpr size_t smem = BwdLayout<WG, MODE>::SMEM;
  static_assert(smem <= 232448, "227 KB of shared memory a block");
  static_assert(WG == 2 || 2 * (smem + 1024) <= 233472, "two blocks an SM");
  thread_local bool allowed[64] = {};
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err) return err;
  if (device >= 64 || !allowed[device]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        seq_bwd_kernel<WG, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    if (device < 64) allowed[device] = true;
  }
  const dim3 grid((args.rows + 63) / 64, units / (64 * WG));
  return launch_pdl(seq_bwd_kernel<WG, MODE>, grid, 128 * WG, smem, st, MODE != BWD_GATES,
                    maps.dg, maps.w, maps.ga, maps.dhs, args);
}

// the recurrence: the gates of step T-1, then one launch a step; the dc
// carry out of step s in dc_buf[s % 2] (dc_buf[0] is dc0)
int launch_steps(const BwdMaps& maps, BwdArgs args, float* const (&dc_buf)[2],
                 const float* dct, float* dh0, int T, cudaStream_t st) {
  const int H = args.H;
  args.t = T - 1;
  args.dc_in = dct;
  args.dc_out = dc_buf[(T - 1) % 2];
  int err = launch_bwd<1, BWD_GATES>(maps, args, H, st);
  if (err) return err;
  for (int t = T - 1; t >= 1; --t) {
    args.t = t;
    args.a_row = t * args.N;
    args.dc_in = dc_buf[t % 2];
    args.dc_out = dc_buf[(t - 1) % 2];
    err = launch_bwd<1, BWD_STEP>(maps, args, H, st);
    if (err) return err;
  }
  args.t = 0;
  args.a_row = 0;
  args.out = dh0;
  return launch_bwd<1, BWD_FIRST>(maps, args, H, st);
}

template <int CT>
int launch_dw(const CUtensorMap& dg_map, const bf16* a, int M, int ko, int G, float* part,
              int per, cudaStream_t st) {
  CUtensorMap a_map;
  int err = row_tile_map(&a_map, a, M, ko);
  if (err) return err;
  constexpr size_t smem = MatRing<CT>::smem(0);
  err = static_cast<int>(cudaFuncSetAttribute(
      seq_dw_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const int k_tiles = (M + BT - 1) / BT;
  const dim3 grid(ko / BT, G / CT, (k_tiles + per - 1) / per);
  seq_dw_kernel<CT><<<grid, MAT_THREADS, smem, st>>>(dg_map, a_map, part, ko, G,
                                                    k_tiles, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape rule of every entry point: E % 64 == 0, H % 64 == 0, T >= 1.
// Each returns a cudaError_t as int: 0 when every launch was accepted.

// hbuf [T+1, N, H] bf16 holds bf16(h0) in slot 0 (the caller's) and hs in
// slots 1..T; hcarry [2, N, H] bf16 (workspace) the bf16 h carry; cs
// [T,N,H] f32, ga [T,N,4H] bf16 and h_T [N,H] f32 are written.
extern "C" int vct_fused_lstm_seq_fwd(
    const void* x, const void* wx, const void* wh, const void* b,
    const void* lengths, const void* c0, const void* h0, void* hbuf, void* hcarry,
    void* cs, void* ga, void* h_T, int T, int N, int E, int H, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  if (E % 64 != 0 || H % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd(x, wx, wh, b, lengths, c0, h0, static_cast<bf16*>(hbuf),
                    static_cast<bf16*>(hcarry), static_cast<float*>(cs), static_cast<bf16*>(ga),
                    static_cast<float*>(h_T), T, N, E, H, static_cast<cudaStream_t>(stream));
}

// h_prev [T, N, H] bf16 is [bf16(h0); hs[0 .. T-2]] (slots 0..T-1 of the
// forward's hbuf).  Workspace (the wrapper allocates it): dg [T,N,4H]
// bf16, dcbuf [N,H] f32, db_part [T, ceil(N / 64), 4H] f32, w_part
// [max(Sx·E, Sh·H), 4H] f32 with Sx = ceil(k_tiles / per_x), Sh =
// ceil(k_tiles / per_h), k_tiles = ceil(T·N / 64).  dx_wg (dx's 64-column
// warpgroups a block; E % (64·dx_wg) == 0), ct (dW's output columns a
// block: 512 or 256, dividing 4H) and the splits' tiles per_x, per_h from
// ops/fused_lstm_seq.py's lstm_seq_plan.
extern "C" int vct_fused_lstm_seq_bwd(
    const void* x, const void* wx, const void* wh, const void* lengths,
    const void* c0, const void* h_prev, const void* cs, const void* ga,
    const void* dhs, const void* dct, const void* dht, void* dx, void* dc0,
    void* dh0, void* dwx, void* dwh, void* db, void* dg, void* dcbuf,
    void* db_part, void* w_part, int T, int N, int E, int H, int dx_wg, int ct,
    int per_x, int per_h, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  const int G = 4 * H;
  if (E % 64 != 0 || H % 64 != 0 || (dx_wg != 1 && dx_wg != 2) || E % (64 * dx_wg) != 0 ||
      (ct != 512 && ct != 256) || G % ct != 0 || per_x <= 0 || per_h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = T * N;
  BwdMaps maps;
  int err = row_tile_map(&maps.dg, static_cast<const bf16*>(dg), M, G);
  if (!err) err = row_tile_map(&maps.w, static_cast<const bf16*>(wh), H, G);
  if (!err) err = row_tile_map(&maps.ga, static_cast<const bf16*>(ga), M, G);
  if (!err) err = row_tile_map(&maps.dhs, static_cast<const bf16*>(dhs), M, H);
  if (err) return err;

  BwdArgs args{};
  args.lengths = static_cast<const int*>(lengths);
  args.cs = static_cast<const float*>(cs);
  args.c0 = static_cast<const float*>(c0);
  args.dht = static_cast<const float*>(dht);
  args.dg = static_cast<bf16*>(dg);
  args.db_part = static_cast<float*>(db_part);
  args.N = N;
  args.H = H;
  args.rows = N;
  args.ld = H;
  args.k_tiles = G / BOX;
  float* const dc_buf[2] = {static_cast<float*>(dc0), static_cast<float*>(dcbuf)};
  err = launch_steps(maps, args, dc_buf, static_cast<const float*>(dct),
                     static_cast<float*>(dh0), T, st);
  if (err) return err;

  // dx = dg @ Wx^T over all T·N rows
  err = row_tile_map(&maps.w, static_cast<const bf16*>(wx), E, G);
  if (err) return err;
  args.t = 0;
  args.a_row = 0;
  args.rows = M;
  args.ld = E;
  args.out = static_cast<float*>(dx);
  err = dx_wg == 2 ? launch_bwd<2, BWD_DX>(maps, args, E, st)
                   : launch_bwd<1, BWD_DX>(maps, args, E, st);
  if (err) return err;

  // dWx = x^T dg and dWh = h_prev^T dg, each over row splits summed in order
  const int k_tiles = (M + BT - 1) / BT;
  float* part = static_cast<float*>(w_part);
  const struct { const void* a; int ko; int per; void* out; } jobs[2] = {
      {x, E, per_x, dwx}, {h_prev, H, per_h, dwh}};
  for (const auto& job : jobs) {
    err = ct == 512
              ? launch_dw<512>(maps.dg, static_cast<const bf16*>(job.a), M, job.ko, G, part,
                               job.per, st)
              : launch_dw<256>(maps.dg, static_cast<const bf16*>(job.a), M, job.ko, G, part,
                               job.per, st);
    if (err) return err;
    err = sum_parts(part, (k_tiles + job.per - 1) / job.per,
                    static_cast<size_t>(job.ko) * G, static_cast<float*>(job.out), st);
    if (err) return err;
  }
  return sum_parts(static_cast<const float*>(db_part), T * ((N + 63) / 64),
                   static_cast<size_t>(G), static_cast<float*>(db), st);
}

// The launches' dynamic shared memory (bytes), none of it shape-dependent:
// a forward step's; a backward launch's of seq_bwd_kernel<wg, mode> (mode a
// BwdMode; 0 for an instance that is not built); dW's at column tile ct (0
// for another ct)
extern "C" int vct_fused_lstm_seq_fwd_smem() { return static_cast<int>(SEQ_FWD_SMEM); }

extern "C" int vct_fused_lstm_seq_bwd_smem(int wg, int mode) {
  if (wg == 2) return mode == BWD_DX ? static_cast<int>(BwdLayout<2, BWD_DX>::SMEM) : 0;
  if (wg != 1) return 0;
  switch (mode) {
    case BWD_GATES: return static_cast<int>(BwdLayout<1, BWD_GATES>::SMEM);
    case BWD_STEP: return static_cast<int>(BwdLayout<1, BWD_STEP>::SMEM);
    case BWD_FIRST: return static_cast<int>(BwdLayout<1, BWD_FIRST>::SMEM);
    case BWD_DX: return static_cast<int>(BwdLayout<1, BWD_DX>::SMEM);
    default: return 0;
  }
}

extern "C" int vct_fused_lstm_seq_dw_smem(int ct) {
  if (ct == 512) return static_cast<int>(MatRing<512>::smem(0));
  if (ct == 256) return static_cast<int>(MatRing<256>::smem(0));
  return 0;
}
