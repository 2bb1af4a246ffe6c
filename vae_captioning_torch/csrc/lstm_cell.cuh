// The LSTM cell's product loop that the decode step (fused_lstm_step.cu,
// row 1) and the teacher-forcing sequence forward (fused_lstm_seq.cu, row
// 6) share, as one kernel template parametrised by its epilogue:
//
//     gates = [x, bf16(h)] @ [Wx; Wh] + b      bf16 operands, f32 sums
//     si, sf, tg, so = sigmoid(i), sigmoid(f + forget_bias), tanh(g), sigmoid(o)
//     nc = sf·c + si·tg,  nh = so·tanh(nc)     gate order i, f, g, o
//
// then Epi::store(row, o, u, ...) writes what its caller keeps.
//
// * lstm_cell_kernel<U, Epi>, wgmma + TMA on the primitives of hopper.cuh.
//   A block owns 64 rows and 2U hidden units; each of its two consumer
//   warpgroups owns U of the units (U = 64 or 32) and multiplies the same A
//   rows by its four gate slabs i | f | g | o, two gates at a time: at U =
//   64 one m64n128k16 product a k16 step (two slab boxes, 16 KB apart, are
//   one MN-major operand), at U = 32 two m64n32k16 products.  With the
//   m64nN layout (column 8n + 2·(lane % 4) + j) the thread that holds unit
//   u of the i slab holds it in the f, g and o slabs too.
// * A, two ways (Epi::STREAM_A):
//   - resident (the decode step): x's boxes come in by TMA (zero past E and
//     past N), and the block converts its f32 h rows to bf16 once, into
//     swizzled boxes beside them (zero past H and past N).  Where E + H
//     leaves no room for two ring stages beside it, A is taken in chunks.
//     The gate maths, the c read and the epilogue's stores run from the
//     accumulator registers: no staging tile.
//   - streamed (the sequence, which keeps a bf16 copy of its h carry): each
//     K stage's A box, x's or h's, comes in by TMA in the ring stage beside
//     its weight boxes, so a block needs no more shared memory than its
//     ring, and two blocks run on an SM (2 stages of 40 KB at U = 32): one
//     block's loads, gate maths and epilogue overlap the other's.  The
//     sequence launches its steps after the first with programmatic
//     dependent launch (launch_pdl, hopper.cuh): a step's x stages (E / 64 of
//     its (E + H) / 64) stream while the step before finishes; its h
//     stages and epilogue wait for it.  The gate
//     tiles go through shared memory (the ring, free after the products),
//     and the gate maths and the epilogue walk whole rows (a warp a row,
//     lanes across the units), so that every store of a warp is one row's
//     contiguous run: from the registers' fragment each spans 8 rows.
//   K stages of 64: ceil(E / 64) over x, then ceil(H / 64) over h; a
//   stage's weight rows start at 64c in wx_map (x part) or wh_row + 64t in
//   wh_map (h part): one [E + H, 4H] matrix passes one map twice with
//   wh_row = E, and then W rows that a padded x stage reads from the h part
//   meet zero A.
// * B: the weights' slab boxes [64 K rows x 64 columns] (128-byte swizzle,
//   read MN-major) stream through a TMA ring behind full mbarriers, 4·(2U /
//   64) boxes a stage; the later of the two leaders to release a stage
//   refills it.  A slab box's columns past the slab's H are the next
//   slab's (or zeros past 4H): pad units, computed and never stored.
// * The products of a stage retire before its release, so that the stage
//   is refilled while the next one is multiplied.
// * Sums: a stage's 64-deep products accumulate in the tensor cores, and
//   the stages' sums are added in f32 registers.  Chained over the whole
//   contraction in the tensor cores instead, the gates drifted from an f32
//   dot product (the plain version's): at E + H = 1792, c' came 1.27e-5
//   from the plain version's, past the step's 1e-5 tolerance.
// * No float atomics: the cell is deterministic.

#pragma once

#include "hopper.cuh"

#include <algorithm>
#include <utility>

namespace {

constexpr int CELL_ROWS = 64;       // rows of a warpgroup's tile
constexpr int CONVERT = 8;          // h runs a thread has in flight

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// A block's shape: 256 threads, 64 rows x 2U units; a ring stage holds the
// four gate slabs of the block's units (SB boxes each) and, where A
// streams, its A box
template <int U, bool STREAM_A>
struct CellShape {
  static constexpr int THREADS = 256;
  static constexpr int SB = 2 * U / BOX;
  static constexpr int W_BYTES = 4 * SB * BOX_BYTES;
  static constexpr int STAGE = W_BYTES + (STREAM_A ? BOX_BYTES : 0);
  // the staged gate tiles where A streams: [64 rows][4 gates][2U units +
  // 2] f32 (a row pitch of 8 banks mod 32, so a warp's float2 stores of
  // its fragment meet no bank twice)
  static constexpr int TILE_LD = 2 * U + 2;
  static constexpr int TILE_BYTES = 64 * 4 * TILE_LD * 4;
  // the ring's stages where A streams: 2, so that two blocks run on an SM
  // (one block's loads and epilogue overlap the other's)
  static constexpr int STREAM_STAGES = 2;

  // 1 KB to align to the swizzle's 1024-byte period; the resident A chunk,
  // the ring, the full barriers, the release counters (padded to 8 bytes)
  // and A's barrier
  static constexpr size_t smem(int chunk_boxes, int stages) {
    return 1024 + static_cast<size_t>(chunk_boxes) * BOX_BYTES +
           static_cast<size_t>(stages) * STAGE +
           stages * (sizeof(uint64_t) + sizeof(uint32_t)) + 2 * sizeof(uint64_t);
  }
};

// The decode step's layout (A resident): the A chunk (K boxes resident at
// once) and the ring's stages, A whole where two ring stages fit beside
// it, else in chunks of what fits; as many stages as then fit, at most
// four.  (Where A streams, the ring has STREAM_STAGES stages.)
struct CellLayout {
  int chunk_boxes, stages;
  size_t smem;
};

template <int U>
CellLayout cell_layout(int E, int H) {
  using S = CellShape<U, false>;
  constexpr long ROOM = 232448;    // one block per SM: 227 KB
  const long boxes = (E + BOX - 1) / BOX + (H + BOX - 1) / BOX;
  const int chunk = static_cast<int>(
      std::min(boxes, (ROOM - static_cast<long>(S::smem(0, 2))) / BOX_BYTES));
  const int stages = static_cast<int>(std::min(
      4L, (ROOM - static_cast<long>(S::smem(chunk, 0))) /
              static_cast<long>(S::STAGE + sizeof(uint64_t) + sizeof(uint32_t))));
  return {chunk, stages, S::smem(chunk, stages)};
}

// Where a launch's operands lie: the block's rows start at row x_row + 64x
// of x's map and h_row + 64x of h's (bf16, Epi::STREAM_A); the h part of
// the weights starts at row wh_row of wh's map.  A resident is taken in
// chunks of chunk_boxes K boxes; the ring holds `stages` stages.
struct CellGeometry {
  int N, E, H;
  int x_row, h_row, wh_row;
  int chunk_boxes, stages;
};

// the activated gates of two units, c' and h' from the pre-activations
// (without bias) and the c carry
struct CellOut {
  float2 s[4];           // si, sf, tg, so
  float2 nc, nh;
};

__device__ __forceinline__ CellOut cell_maths(const float2 (&pre)[4], const float2 (&bias)[4],
                                              float forget_bias, float2 cc) {
  CellOut r;
  r.s[0] = make_float2(sigmoid_f32(pre[0].x + bias[0].x), sigmoid_f32(pre[0].y + bias[0].y));
  r.s[1] = make_float2(sigmoid_f32(pre[1].x + bias[1].x + forget_bias),
                       sigmoid_f32(pre[1].y + bias[1].y + forget_bias));
  r.s[2] = make_float2(tanhf(pre[2].x + bias[2].x), tanhf(pre[2].y + bias[2].y));
  r.s[3] = make_float2(sigmoid_f32(pre[3].x + bias[3].x), sigmoid_f32(pre[3].y + bias[3].y));
  r.nc = make_float2(r.s[1].x * cc.x + r.s[0].x * r.s[2].x,
                     r.s[1].y * cc.y + r.s[0].y * r.s[2].y);
  r.nh = make_float2(r.s[3].x * tanhf(r.nc.x), r.s[3].y * tanhf(r.nc.y));
  return r;
}

// Grid (ceil(N / 64), ceil(H / 2U)).  Block (x, y) computes rows [64x, 64x
// + 64) and units [2U·y, 2U·y + 2U), warpgroup w the U units from 2U·y +
// U·w.  Epi gives STREAM_A, the f32 h rows to convert (h, where not
// STREAM_A), the bias b, forget_bias, the c rows (c) and store(row, o, u,
// s, c, nc, nh): s[g] the activated gate g (i, f, g, o) of units u and u +
// 1, o = row·H + u, for every row < N and unit u < H.
template <int U, class Epi>
__global__ void __launch_bounds__(256, 1)
lstm_cell_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap wx_map,
                 const __grid_constant__ CUtensorMap wh_map,
                 const __grid_constant__ CUtensorMap h_map,
                 const Epi epi, const CellGeometry geo) {
  constexpr bool STREAM_A = Epi::STREAM_A;
  using S = CellShape<U, STREAM_A>;
  constexpr int SB = S::SB, W_BYTES = S::W_BYTES, STAGE = S::STAGE, THREADS = S::THREADS;
  constexpr int ACC = U / 2;              // f32 registers of a [64 x U] tile
  const int N = geo.N, E = geo.E, H = geo.H;
  const int chunk_boxes = geo.chunk_boxes, stages = geo.stages;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* a_s = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = a_s + chunk_boxes * BOX_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + stages);
  uint64_t* a_bar = reinterpret_cast<uint64_t*>(released + stages + (stages & 1));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int m0 = blockIdx.x * CELL_ROWS;
  const int u0 = blockIdx.y * 2 * U;
  const int nx = (E + BOX - 1) / BOX;     // K boxes over x
  const int total = nx + (H + BOX - 1) / BOX;

  // K stage j's weight rows into slot j % stages: slab g's 2U columns from
  // g·H + u0, in SB boxes; where A streams, its A box after them.  A
  // streamed A is the sequence's, launched with PDL: the x stages do not
  // depend on the step before, the h stages do (the thread that loads the
  // first of them waits for that step first)
  bool waited = false;
  auto load = [&](int j) {
    if (STREAM_A && j >= nx && !waited) {
      pdl_wait();
      waited = true;
    }
    const int s = j % stages;
    unsigned char* dst = ring + s * STAGE;
    const CUtensorMap* map = j < nx ? &wx_map : &wh_map;
    const int row = j < nx ? j * BOX : geo.wh_row + (j - nx) * BOX;
    mbar_expect_tx(&full[s], STAGE);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int bb = 0; bb < SB; ++bb)
        tma_load(dst + (g * SB + bb) * BOX_BYTES, map, &full[s],
                 g * H + u0 + bb * BOX, row);
    if constexpr (STREAM_A) {
      if (j < nx)
        tma_load(dst + W_BYTES, &x_map, &full[s], j * BOX, geo.x_row + m0);
      else
        tma_load(dst + W_BYTES, &h_map, &full[s], (j - nx) * BOX, geo.h_row + m0);
    }
  };
  // this warpgroup's products of stage j retired: the later of the two
  // leaders refills its slot `stages` ahead
  auto release = [&](int j) {
    if (!leader) return;
    const int s = j % stages;
    __threadfence_block();
    const bool later = atomicAdd(&released[s], 1u) & 1u;
    __threadfence_block();
    if (later && j + stages < total) load(j + stages);
  };
  if constexpr (STREAM_A) pdl_launch_next();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(stages, total); ++j) load(j);

  // This warpgroup's slab columns within a stage: U = 64, its own box of
  // each slab; U = 32, its half of the slab's one box
  const uint32_t b_cols = U == 64 ? wg * BOX_BYTES : wg * U * 2;
  const uint32_t a_addr = smem_addr(a_s);
  const uint32_t ring_addr = smem_addr(ring);
  float acc[4 * ACC];    // gate g at [g·ACC, g·ACC + ACC)
  float part[2 * ACC];   // a stage's products of two gates
#pragma unroll
  for (int e = 0; e < 4 * ACC; ++e) acc[e] = 0.0f;
  uint32_t a_phase = 0;

  // one pass where A streams; else a pass per resident chunk of A
  for (int q0 = 0; q0 < total; q0 += STREAM_A ? total : chunk_boxes) {
    const int q1 = STREAM_A ? total : min(total, q0 + chunk_boxes);
    if constexpr (!STREAM_A) {
      // the chunk's x boxes by TMA
      const int x1 = min(q1, nx);
      if (tid == 0 && q0 < x1) {
        mbar_expect_tx(a_bar, (x1 - q0) * BOX_BYTES);
        for (int a = q0; a < x1; ++a)
          tma_load(a_s + (a - q0) * BOX_BYTES, &x_map, a_bar, a * BOX, geo.x_row + m0);
      }
      // its h boxes: f32 rows rounded to bf16, each 16-byte run (8
      // columns) at its swizzled place; zeros past H and past N.  A thread
      // loads CONVERT runs before it converts any, so their latencies
      // overlap.
      const float* h = epi.h;
      const int h0 = max(q0, nx);
      const int runs = (q1 - h0) * CELL_ROWS * 8;
      for (int v0 = tid; v0 < runs; v0 += CONVERT * THREADS) {
        float4 f[CONVERT][2];
#pragma unroll
        for (int u = 0; u < CONVERT; ++u) {
          const int v = v0 + u * THREADS;
          const int row = m0 + (v / 8) % CELL_ROWS;
          const int col = (h0 - nx + v / (CELL_ROWS * 8)) * BOX + 8 * (v % 8);
          f[u][0] = f[u][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (v < runs && row < N && col < H) {
            const float4* src = reinterpret_cast<const float4*>(
                &h[static_cast<size_t>(row) * H + col]);
            f[u][0] = __ldg(src);
            f[u][1] = __ldg(src + 1);
          }
        }
#pragma unroll
        for (int u = 0; u < CONVERT; ++u) {
          const int v = v0 + u * THREADS;
          if (v >= runs) break;
          const int r = (v / 8) % CELL_ROWS;
          const int ec = v % 8;
          uint4 out;
          __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(&out);
          d2[0] = __floats2bfloat162_rn(f[u][0].x, f[u][0].y);
          d2[1] = __floats2bfloat162_rn(f[u][0].z, f[u][0].w);
          d2[2] = __floats2bfloat162_rn(f[u][1].x, f[u][1].y);
          d2[3] = __floats2bfloat162_rn(f[u][1].z, f[u][1].w);
          *reinterpret_cast<uint4*>(a_s + (h0 + v / (CELL_ROWS * 8) - q0) * BOX_BYTES +
                                    r * 128 + ((ec ^ (r & 7)) * 16)) = out;
        }
      }
      // the converted boxes are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (q0 < x1) {
        mbar_wait(a_bar, a_phase);
        a_phase ^= 1;
      }
    }

    // the four gate tiles [64 x U] += A box @ slab boxes, stage by stage.
    // A stage's products go into part (the first k16 step overwrites it),
    // which f32 adds then sum into acc (the note on sums above)
    for (int a = q0; a < q1; ++a) {
      const int s = a % stages;
      mbar_wait(&full[s], (a / stages) & 1);
      const uint32_t stage = ring_addr + s * STAGE + b_cols;
      const uint32_t ab = STREAM_A ? ring_addr + s * STAGE + W_BYTES
                                   : a_addr + (a - q0) * BOX_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // gates 2·half and 2·half + 1 into part
        wgmma_fence();
        if constexpr (U == 64) {
          // this warpgroup's boxes of the two slabs, 2 boxes apart, are one
          // MN-major B operand of 128 columns: one product a k16 step
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma<2 * U, 1, 0>(part, sw128_desc(ab + kk * 32, 16),
                               sw128_desc(stage + 2 * half * SB * BOX_BYTES + kk * 16 * 128,
                                          SB * BOX_BYTES),
                               kk != 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int g = 0; g < 2; ++g)
              wgmma<U, 1, 0>(*reinterpret_cast<float(*)[ACC]>(&part[g * ACC]),
                             sw128_desc(ab + kk * 32, 16),
                             sw128_desc(stage + (2 * half + g) * SB * BOX_BYTES +
                                            kk * 16 * 128,
                                        BOX_BYTES),
                             kk != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(part);
#pragma unroll
        for (int e = 0; e < 2 * ACC; ++e) acc[2 * ACC * half + e] += part[e];
      }
      // the stage's products have retired: the stage is refilled while the
      // next one is multiplied
      release(a);
    }
    if constexpr (!STREAM_A) __syncthreads();    // every product has read this A chunk
  }

  // This thread's fragment of each gate tile: rows r + 8i (i = 0, 1) of
  // the 64, units uw + 8n + cq + j (n < U / 8, j < 2) at register 4n + 2i +
  // j
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int uw = u0 + wg * U;
  const float fb = epi.forget_bias;
  if constexpr (STREAM_A) {
    // the gate tiles into the ring (every product has read it), then a warp
    // a row: lane l the units u0 + 2l, 2l + 1 (2U = 64 of them; at U = 64
    // a lane takes 4 in two halves).  The epilogue reads the c carry and
    // writes what the step before read: it waits for that step.
    float* tile = reinterpret_cast<float*>(ring);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int n = 0; n < U / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(
              &tile[((r + 8 * i) * 4 + g) * S::TILE_LD + wg * U + 8 * n + cq]) =
              make_float2(acc[g * ACC + 4 * n + 2 * i], acc[g * ACC + 4 * n + 2 * i + 1]);
    __syncthreads();
    pdl_wait();
    const int w8 = tid / 32;               // 8 warps
#pragma unroll
    for (int hu = 0; hu < 2 * U / 64; ++hu) {
      const int uu = 64 * hu + 2 * lane;   // the lane's units in the block
      const int u = u0 + uu;
      if (u >= H) continue;
      float2 bias[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        bias[g] = __ldg(reinterpret_cast<const float2*>(&epi.b[g * H + u]));
      for (int rr = w8; rr < 64 && m0 + rr < N; rr += 8) {
        const int row = m0 + rr;
        const size_t o = static_cast<size_t>(row) * H + u;
        float2 pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = *reinterpret_cast<const float2*>(&tile[(rr * 4 + g) * S::TILE_LD + uu]);
        const float2 cc = *reinterpret_cast<const float2*>(&epi.c[o]);
        const CellOut out = cell_maths(pre, bias, fb, cc);
        epi.store(row, o, u, out.s, cc, out.nc, out.nh);
      }
    }
    return;
  }

  // gate maths in f32 from the accumulator registers
#pragma unroll
  for (int n = 0; n < U / 8; ++n) {
    const int u = uw + 8 * n + cq;
    if (u >= H) continue;             // pad units (H % 2U != 0)
    float2 bias[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bias[g] = __ldg(reinterpret_cast<const float2*>(&epi.b[g * H + u]));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r + 8 * i;
      if (row >= N) continue;
      const size_t o = static_cast<size_t>(row) * H + u;
      const float2 cc = *reinterpret_cast<const float2*>(&epi.c[o]);
      const int e = 4 * n + 2 * i;
      float2 pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] = make_float2(acc[g * ACC + e], acc[g * ACC + e + 1]);
      const CellOut out = cell_maths(pre, bias, fb, cc);
      epi.store(row, o, u, out.s, cc, out.nc, out.nh);
    }
  }
}

// the kernel's shared-memory attribute raised to `smem` once per device
// and size (cudaFuncSetAttribute costs microseconds a call); a host
// thread's calls are sequential, so one record per thread and instance
template <int U, class Epi>
int allow_cell_smem(size_t smem) {
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err) return err;
  thread_local size_t allowed[64] = {};
  if (device >= 64 || allowed[device] < smem) {
    err = static_cast<int>(cudaFuncSetAttribute(
        lstm_cell_kernel<U, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    if (device < 64) allowed[device] = smem;
  }
  return 0;
}

}  // namespace
