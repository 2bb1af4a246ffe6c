// Fused LSTM decode step for Hopper (sm_90a), exported with a plain C
// interface and loaded through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernel vae_captioning_tpu/ops/fused_lstm_step.py
// (_kernel, called through fused_lstm_step):
//
//     gates = [x, bf16(h)] @ W + b        bf16 operands, f32 accumulation
//     c'    = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//     h'    = sigmoid(o) * tanh(c')        gate order i, f, g, o
//
// x [N,E] bf16, c/h [N,H] f32, W [E+H,4H] bf16 (x rows first), b [4H] f32
// -> c', h' [N,H] f32.  The row gather x = embed_bf16[tokens] stays with
// the caller, as it does on the TPU.
//
// What bounds it on this card: at decode sizes (N = beam * batch of a few
// thousand lanes, E = 256, H = 512) the bytes: x, c, h, W and c', h' (16.5
// MB at N = 1536, 0.0049 ms at 3.35 TB/s) against 4.8 GFLOP.  In practice
// each block streams its slab of W and its rows of x and h from L2, so the
// design cuts what the blocks re-read and keeps the gates on chip:
//
// * lstm_step_kernel<U>, wgmma + TMA on the primitives of hopper.cuh.  A
//   block owns 64 lanes (rows) and 2U hidden units; each of its two
//   consumer warpgroups owns U of the units (U = 64 or 32) and multiplies
//   the same A rows by its four gate slabs i | f | g | o, two gates at a
//   time: at U = 64 one m64n128k16 product a k16 step (two slab boxes, 16
//   KB apart, are one MN-major operand), at U = 32 two m64n32k16
//   products.  With the m64nN layout
//   (column 8n + 2·(lane % 4) + j) the thread that holds unit u of the i
//   slab holds it in the f, g and o slabs too, so the gate maths, the c
//   read and the c' / h' stores run from registers: no staging tile.
// * A resident: x's boxes come in by TMA (zero past E and past N), and the
//   block converts its f32 h rows to bf16 once, into swizzled boxes beside
//   them (zero past H and past N).  K stages of 64: ceil(E / 64) over x,
//   then ceil(H / 64) over h; a stage's W rows start at 64c (x part) or E
//   + 64t (h part), so W rows that a padded x stage reads from the h part
//   meet zero A, and W rows past E + H read zeros.  Where E + H leaves no
//   room for two ring stages beside a resident A, A is taken in chunks.
// * B: W's slab boxes [64 K rows x 64 columns] (128-byte swizzle, read
//   MN-major) stream through a TMA ring behind full mbarriers, 4·(2U / 64)
//   boxes a stage; the later of the two leaders to release a stage
//   refills it.  A slab box's columns past the slab's H are the next
//   slab's (or zeros past 4H): pad units, computed and never stored.
// * ops/fused_lstm_step.py's lstm_step_plan picks U: 32 where the grid at
//   U = 64 would fill under half the SMs, else 64.  lstm_layout below keeps
//   A resident where two ring stages fit beside it (else takes it in
//   chunks) and gives the ring as many stages as then fit, at most four.
// * The products of a stage retire before its release, so that the stage
//   is refilled while the next one is multiplied.
// * Sums: a stage's 64-deep products accumulate in the tensor cores, and
//   the stages' sums are added in f32 registers.  Chained over the whole
//   contraction in the tensor cores instead, the gates drifted from an f32
//   dot product (the plain version's): at E + H = 1792, c' came 1.27e-5
//   from the plain version's, past its 1e-5 tolerance.
// * No float atomics: the step is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;    // two consumer warpgroups
constexpr int ROWS = 64;        // lanes (rows) of a block
constexpr int CONVERT = 8;      // h runs a thread has in flight

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// W boxes of a ring stage: four gate slabs of 2U units
__host__ __device__ constexpr int stage_bytes(int U) {
  return 4 * (2 * U / BOX) * BOX_BYTES;
}

// 1 KB to align to the swizzle's 1024-byte period; the A chunk, the ring,
// the full barriers, the release counters (padded to 8 bytes) and A's
// barrier
size_t lstm_smem(int U, int chunk_boxes, int stages) {
  return 1024 + static_cast<size_t>(chunk_boxes) * BOX_BYTES +
         static_cast<size_t>(stages) * stage_bytes(U) +
         stages * (sizeof(uint64_t) + sizeof(uint32_t)) + 2 * sizeof(uint64_t);
}

// The A chunk (K boxes resident at once) and the ring's stages at width
// U: A whole where two ring stages fit beside it, else in chunks of what
// fits; as many stages as then fit, at most four
struct Layout {
  int chunk_boxes, stages;
  size_t smem;
};

Layout lstm_layout(int E, int H, int U) {
  constexpr long ROOM = 232448;    // one block per SM: 227 KB
  const long boxes = (E + BOX - 1) / BOX + (H + BOX - 1) / BOX;
  const int chunk = static_cast<int>(
      std::min(boxes, (ROOM - static_cast<long>(lstm_smem(U, 0, 2))) / BOX_BYTES));
  const int stages = static_cast<int>(std::min(
      4L, (ROOM - static_cast<long>(lstm_smem(U, chunk, 0))) /
              static_cast<long>(stage_bytes(U) + sizeof(uint64_t) + sizeof(uint32_t))));
  return {chunk, stages, lstm_smem(U, chunk, stages)};
}

// Grid (ceil(N / 64), ceil(H / 2U)).  Block (x, y) computes rows [64x, 64x
// + 64) and units [2U·y, 2U·y + 2U), warpgroup w the U units from 2U·y +
// U·w.  A is taken in chunks of chunk_boxes K boxes (all of them where they
// fit); the ring holds `stages` stages.
template <int U>
__global__ void __launch_bounds__(THREADS, 1)
lstm_step_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const float* __restrict__ c, const float* __restrict__ h,
                 const float* __restrict__ b, float* __restrict__ c_out,
                 float* __restrict__ h_out, int N, int E, int H,
                 float forget_bias, int chunk_boxes, int stages) {
  constexpr int SB = 2 * U / BOX;         // boxes of a slab in a stage (1 or 2)
  constexpr int STAGE = stage_bytes(U);
  constexpr int ACC = U / 2;              // f32 registers of a [64 x U] tile
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
  const int m0 = blockIdx.x * ROWS;
  const int u0 = blockIdx.y * 2 * U;
  const int nx = (E + BOX - 1) / BOX;     // K boxes over x
  const int total = nx + (H + BOX - 1) / BOX;

  // K stage j's W rows into slot j % stages: slab g's 2U columns from
  // g·H + u0, in SB boxes
  auto load = [&](int j) {
    const int s = j % stages;
    unsigned char* dst = ring + s * STAGE;
    const int row = j < nx ? j * BOX : E + (j - nx) * BOX;
    mbar_expect_tx(&full[s], STAGE);
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int bb = 0; bb < SB; ++bb)
        tma_load(dst + (g * SB + bb) * BOX_BYTES, &w_map, &full[s],
                 g * H + u0 + bb * BOX, row);
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

  for (int q0 = 0; q0 < total; q0 += chunk_boxes) {
    const int q1 = min(total, q0 + chunk_boxes);
    // the chunk's x boxes by TMA
    const int x1 = min(q1, nx);
    if (tid == 0 && q0 < x1) {
      mbar_expect_tx(a_bar, (x1 - q0) * BOX_BYTES);
      for (int a = q0; a < x1; ++a)
        tma_load(a_s + (a - q0) * BOX_BYTES, &x_map, a_bar, a * BOX, m0);
    }
    // its h boxes: f32 rows rounded to bf16, each 16-byte run (8 columns)
    // at its swizzled place; zeros past H and past N.  A thread loads
    // CONVERT runs before it converts any, so their latencies overlap.
    const int h0 = max(q0, nx);
    const int runs = (q1 - h0) * ROWS * 8;
    for (int v0 = tid; v0 < runs; v0 += CONVERT * THREADS) {
      float4 f[CONVERT][2];
#pragma unroll
      for (int u = 0; u < CONVERT; ++u) {
        const int v = v0 + u * THREADS;
        const int row = m0 + (v / 8) % ROWS;
        const int col = (h0 - nx + v / (ROWS * 8)) * BOX + 8 * (v % 8);
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
        const int r = (v / 8) % ROWS;
        const int ec = v % 8;
        uint4 out;
        __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(&out);
        d2[0] = __floats2bfloat162_rn(f[u][0].x, f[u][0].y);
        d2[1] = __floats2bfloat162_rn(f[u][0].z, f[u][0].w);
        d2[2] = __floats2bfloat162_rn(f[u][1].x, f[u][1].y);
        d2[3] = __floats2bfloat162_rn(f[u][1].z, f[u][1].w);
        *reinterpret_cast<uint4*>(a_s + (h0 + v / (ROWS * 8) - q0) * BOX_BYTES +
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

    // the four gate tiles [64 x U] += A box @ slab boxes, stage by stage.
    // A stage's products go into part (the first k16 step overwrites it),
    // which f32 adds then sum into acc (the note on sums above)
    for (int a = q0; a < q1; ++a) {
      const int s = a % stages;
      mbar_wait(&full[s], (a / stages) & 1);
      const uint32_t stage = ring_addr + s * STAGE + b_cols;
      const uint32_t ab = a_addr + (a - q0) * BOX_BYTES;
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
    __syncthreads();    // every product has read this A chunk
  }

  // gate maths in f32 from registers.  This thread's fragment of each gate
  // tile: rows r + 8i (i = 0, 1) of the 64, units uw + 8n + cq + j (n < U /
  // 8, j < 2) at register 4n + 2i + j
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int uw = u0 + wg * U;
#pragma unroll
  for (int n = 0; n < U / 8; ++n) {
    const int u = uw + 8 * n + cq;
    if (u >= H) continue;             // pad units (H % 2U != 0)
    float2 bias[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      bias[g] = __ldg(reinterpret_cast<const float2*>(&b[g * H + u]));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r + 8 * i;
      if (row >= N) continue;
      const size_t o = static_cast<size_t>(row) * H + u;
      const float2 cc = *reinterpret_cast<const float2*>(&c[o]);
      const int e = 4 * n + 2 * i;
      const float gi0 = acc[e] + bias[0].x, gi1 = acc[e + 1] + bias[0].y;
      const float gf0 = acc[ACC + e] + bias[1].x, gf1 = acc[ACC + e + 1] + bias[1].y;
      const float gg0 = acc[2 * ACC + e] + bias[2].x, gg1 = acc[2 * ACC + e + 1] + bias[2].y;
      const float go0 = acc[3 * ACC + e] + bias[3].x, go1 = acc[3 * ACC + e + 1] + bias[3].y;
      const float nc0 = sigmoid_f32(gf0 + forget_bias) * cc.x + sigmoid_f32(gi0) * tanhf(gg0);
      const float nc1 = sigmoid_f32(gf1 + forget_bias) * cc.y + sigmoid_f32(gi1) * tanhf(gg1);
      *reinterpret_cast<float2*>(&c_out[o]) = make_float2(nc0, nc1);
      *reinterpret_cast<float2*>(&h_out[o]) =
          make_float2(sigmoid_f32(go0) * tanhf(nc0), sigmoid_f32(go1) * tanhf(nc1));
    }
  }
}

// The step runs once a decode step, so its host work counts (encoding a
// tensor map takes microseconds): each tensor map is kept while its
// matrix's address and shape stay (the decode passes the same weights every
// step, and the caching allocator hands x the same block), and the
// shared-memory attribute is raised once per device and size.  A host
// thread's calls are sequential, so one cache per thread.
struct MapCache {
  const void* ptr = nullptr;
  int rows = 0, cols = 0;
  CUtensorMap map;
};

// the [rows, cols] bf16 matrix at ptr in 64 x 64 boxes (row_tile_map),
// encoded again only where the cache held another
int cached_map(MapCache& cache, const void* ptr, int rows, int cols) {
  if (cache.ptr == ptr && cache.rows == rows && cache.cols == cols) return 0;
  cache.ptr = nullptr;
  const int err = row_tile_map(&cache.map, static_cast<const bf16*>(ptr), rows, cols);
  if (err) return err;
  cache.ptr = ptr;
  cache.rows = rows;
  cache.cols = cols;
  return 0;
}

template <int U>
int launch(const void* x, const void* c, const void* h, const void* w,
           const void* b, void* c_out, void* h_out, int N, int E, int H,
           float forget_bias, cudaStream_t st) {
  thread_local MapCache xc, wc;
  int err = cached_map(xc, x, N, E);
  if (err) return err;
  err = cached_map(wc, w, E + H, 4 * H);
  if (err) return err;
  const Layout lay = lstm_layout(E, H, U);
  const size_t smem = lay.smem;
  int device = 0;
  err = static_cast<int>(cudaGetDevice(&device));
  if (err) return err;
  thread_local size_t allowed[64] = {};
  if (device >= 64 || allowed[device] < smem) {
    err = static_cast<int>(cudaFuncSetAttribute(
        lstm_step_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    if (device < 64) allowed[device] = smem;
  }
  const CUtensorMap& x_map = xc.map;
  const CUtensorMap& w_map = wc.map;
  const dim3 grid((N + ROWS - 1) / ROWS, (H + 2 * U - 1) / (2 * U));
  lstm_step_kernel<U><<<grid, THREADS, smem, st>>>(
      x_map, w_map, static_cast<const float*>(c), static_cast<const float*>(h),
      static_cast<const float*>(b), static_cast<float*>(c_out),
      static_cast<float*>(h_out), N, E, H, forget_bias, lay.chunk_boxes, lay.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shape rule: E and H multiples of 32, N anything positive; `units` (U, 64
// or 32) from ops/fused_lstm_step.py's lstm_step_plan.  Returns a
// cudaError_t as int: 0 when the launch was accepted.
extern "C" int vct_fused_lstm_step(const void* x, const void* c,
                                   const void* h, const void* w,
                                   const void* b, void* c_out, void* h_out,
                                   int N, int E, int H, float forget_bias,
                                   int units, void* stream) {
  if (N <= 0) return 0;
  if (E <= 0 || H <= 0 || E % 32 != 0 || H % 32 != 0 || (units != 64 && units != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return units == 64
             ? launch<64>(x, c, h, w, b, c_out, h_out, N, E, H, forget_bias, st)
             : launch<32>(x, c, h, w, b, c_out, h_out, N, E, H, forget_bias, st);
}

// The launch's layout at (E, H, units): its dynamic shared memory (bytes;
// 0 for another `units`), and through the pointers the K boxes of A
// resident at once and the ring's stages.
extern "C" int vct_fused_lstm_step_layout(int E, int H, int units, int* chunk_boxes,
                                          int* stages) {
  if (E <= 0 || H <= 0 || (units != 64 && units != 32)) return 0;
  const Layout lay = lstm_layout(E, H, units);
  *chunk_boxes = lay.chunk_boxes;
  *stages = lay.stages;
  return static_cast<int>(lay.smem);
}
