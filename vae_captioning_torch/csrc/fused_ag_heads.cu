// AG-prior recognition heads + cluster-vector combine for Hopper (sm_90a):
// forward and backward, exported with a plain C interface and loaded
// through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_ag_heads.py:
// _fwd_kernel (:80) and _bwd_kernel (:116), called through fused_ag_heads.
//
//   q      = h @ W^T + b                         [N, 2*K*L]  (mu || log sigma)
//   mu_k   = q[:, k*L + l],   sigma_k = exp(q[:, K*L + k*L + l])
//   q_mean = sum_k cv[:, k] * mu_k,   q_std = sum_k cv[:, k] * sigma_k
//
// h [N, H] and W [2*K*L, H] (the nn.Linear weight of q_heads, read in that
// layout) in bf16, the products accumulated in f32; b f32; cv [N, K] f32,
// rounded through bf16 as the plain version rounds it; exp and the combine
// in f32.  The backward:
//
//   dq_m = g_mean[n, l] * cv[n, k],   dq_s = g_std[n, l] * cv[n, k] * sigma
//   dW = dq^T @ h,   db = sum_n dq,   dh = dq @ W,
//   dcv[n, k] = sum_l (mu * g_mean + sigma * g_std)
//
// What bounds it on this card: tensor-core operations.  At the train shapes
// (N = 1280, H = 512, K = 90, L = 150) the heads are one [1280, 512] x
// [512, 27000] product, 35.4 GFLOP forward and three of them (recompute,
// dW, dh) backward, against 28 MB of bf16 weights: about 0.036 ms and
// 0.107 ms at the dense bf16 rate.  The design:
//
// * Forward (ag_fwd_kernel<NC, RES>, wgmma + TMA on the primitives of
//   hopper.cuh): q never reaches memory.  A block keeps 128 rows of h
//   resident in shared memory (64 x 64 boxes, 128-byte swizzle; 128 KB at
//   H = 512) and walks the clusters of its group over NC latent columns (80
//   at L = 150, two latent tiles).  A stage holds the mu box and the
//   log-sigma box [NC x 64] of one cluster and 64 columns of H (20 KB; 4
//   stages at H = 512, 209 KB in all), behind a full mbarrier; each of the
//   two consumer warpgroups multiplies both boxes, as one B operand, with
//   its own 64 rows (m64n2NCk16, 2 x 80 columns at L = 150, into f32
//   registers; A is read once for mu and sigma), and the later of the two
//   leaders to release a stage refills it.  After a cluster's last stage
//   each warpgroup folds its tiles, bias added (and exp for sigma),
//   weighted by c_v, into 2 x NC / 2 running registers.  Each group writes a
//   [2, N, L] partial; a second launch sums the groups in a fixed order.
//   ops/fused_ag_heads.py's ag_fwd_plan picks NC and the clusters per
//   group.  Every W byte is read from L2 once per 128 rows: 295 MB at the
//   train shapes (a first version with 64 rows and one warpgroup per half
//   read 553 MB and took 0.20 ms).  Where 128 rows of h leave no room for
//   two stages (H > 704 at NC = 80, H > 768 at NC = 40), the RES = false
//   instance streams h's two 64-row boxes in each stage beside the W
//   boxes instead, so every H that is a multiple of 64 runs.
// * Backward: a first kernel recomputes the q tiles (WMMA, q_tiles) and
//   forms dq, db partials (per row tile) and dcv partials (per latent
//   tile); dq is written once in bf16 ([N, 2*K*L], 69 MB at the train
//   shapes) for the two products that follow, dW = dq^T @ h (each element
//   written once) and dh = dq @ W (split over q's columns, partials summed
//   in a fixed order).  Writing dq instead of recomputing it a second and
//   third time is the first version's choice; removing it is later work.
//   The backward kernels are still WMMA from plain 16-byte loads.
// * Determinism: no float atomics.  Every cross-block sum is a partial
//   buffer reduced by one thread per element, in index order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

// ---------------------------------------------------------------------
// the backward's q tiles of one cluster: 64 rows x 32 latent columns, mu
// and log sigma
// ---------------------------------------------------------------------
constexpr int BM = 64;           // rows
constexpr int BL = 32;           // latent columns
constexpr int BH = 64;           // H per stage
constexpr int A_LD = BH + 8;
constexpr int B_LD = BH + 8;     // B^T kept as [BL][BH]: column-major
constexpr int C_LD = BL + 4;
constexpr int PER_THREAD = BM * BL / THREADS;   // 8 elements of the tile

struct QTiles {
  bf16 a[BM * A_LD];
  bf16 bm[BL * B_LD];
  bf16 bs[BL * B_LD];
  float cm[BM * C_LD];
  float cs[BM * C_LD];
  float ct[BM * C_LD];          // backward: the dcv contributions
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// t.cm / t.cs <- h16[m0:m0+64] @ W16[k*L + l0 + j]^T and W16[KL + k*L + l0 + j]^T
// (j < 32; latent columns l >= L and rows n >= N read zeros)
__device__ void q_tiles(const bf16* __restrict__ h, const bf16* __restrict__ w,
                        int N, int H, int K, int L, int m0, int l0, int k,
                        QTiles& t) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;       // rows wm*16
  const int wn = warp % 2;       // latent columns wn*16
  const size_t KL = static_cast<size_t>(K) * L;
  AccFrag acc_m, acc_s;
  wmma::fill_fragment(acc_m, 0.0f);
  wmma::fill_fragment(acc_s, 0.0f);
  for (int h0 = 0; h0 < H; h0 += BH) {
#pragma unroll
    for (int i = 0; i < (BM * BH / 8) / THREADS; ++i) {   // A: h rows
      const int v = tid + i * THREADS;
      const int r = v / (BH / 8);
      const int cv = (v % (BH / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (m0 + r < N)
        x = *reinterpret_cast<const uint4*>(&h[static_cast<size_t>(m0 + r) * H + h0 + cv]);
      *reinterpret_cast<uint4*>(&t.a[r * A_LD + cv]) = x;
    }
    {   // B^T: W rows of the latent columns, mu half and log-sigma half
      const int r = tid / (BH / 8);
      const int cv = (tid % (BH / 8)) * 8;
      const int l = l0 + r;
      uint4 xm = make_uint4(0, 0, 0, 0), xs = make_uint4(0, 0, 0, 0);
      if (l < L) {
        const size_t row = static_cast<size_t>(k) * L + l;
        xm = *reinterpret_cast<const uint4*>(&w[row * H + h0 + cv]);
        xs = *reinterpret_cast<const uint4*>(&w[(KL + row) * H + h0 + cv]);
      }
      *reinterpret_cast<uint4*>(&t.bm[r * B_LD + cv]) = xm;
      *reinterpret_cast<uint4*>(&t.bs[r * B_LD + cv]) = xs;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfm, bfs;
      wmma::load_matrix_sync(af, &t.a[(wm * 16) * A_LD + kk], A_LD);
      wmma::load_matrix_sync(bfm, &t.bm[(wn * 16) * B_LD + kk], B_LD);
      wmma::load_matrix_sync(bfs, &t.bs[(wn * 16) * B_LD + kk], B_LD);
      wmma::mma_sync(acc_m, af, bfm, acc_m);
      wmma::mma_sync(acc_s, af, bfs, acc_s);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&t.cm[(wm * 16) * C_LD + wn * 16], acc_m, C_LD,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(&t.cs[(wm * 16) * C_LD + wn * 16], acc_s, C_LD,
                          wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------
// the forward: wgmma + TMA (hopper.cuh)
// ---------------------------------------------------------------------
constexpr int AG_THREADS = 256;   // two consumer warpgroups, 64 rows each
constexpr int AG_ROWS = 128;      // h rows of a block

// A stage holds the mu box and the log-sigma box of one (cluster, 64
// columns of H), 2 x NC rows x 128 bytes, and, where h is not resident,
// the block's two 64-row h boxes of those columns (16 KB).
size_t ag_fwd_stage(int NC, bool resident) {
  return 4 * static_cast<size_t>(NC) * BOX + (resident ? 0 : 2 * BOX_BYTES);
}

// The stage count that fits beside h [128, H] (resident) or alone (at most 8).
int ag_fwd_stages(int H, int NC, bool resident) {
  const long room = 232448L - 1024 - (resident ? 2L * AG_ROWS * H : 0L) - 17 * 8;
  return static_cast<int>(std::min(8L, room / static_cast<long>(ag_fwd_stage(NC, resident))));
}

// h stays resident where that leaves a ring of two stages (H <= 704 at NC =
// 80, H <= 768 at NC = 40); a wider h streams with the W boxes
bool ag_fwd_resident(int H, int NC) { return ag_fwd_stages(H, NC, true) >= 2; }

// 1 KB to align to the swizzle's 1024-byte period; h (resident), the ring,
// the full barriers, the release counters and h's barrier
size_t ag_fwd_smem(int H, int NC, bool resident, int stages) {
  return 1024 + (resident ? 2 * static_cast<size_t>(AG_ROWS) * H : 0) +
         stages * ag_fwd_stage(NC, resident) +
         stages * (sizeof(uint64_t) + sizeof(uint32_t)) + 2 * sizeof(uint64_t);
}

// Grid (row tiles of 128, latent tiles of NC, cluster groups of kb); part
// [G, 2, N, L].  Block (x, y, z) takes h rows [128x, 128x + 128) and, for
// each cluster k of group z and each 64 columns of H, streams one stage:
// the W rows k·L + l (mu) and KL + k·L + l (log sigma) of latent columns l
// in [NC·y, NC·y + NC).  RES: h is loaded once and stays resident; else
// each stage also carries h's 64 columns (read once per cluster).  Both
// warpgroups read both W boxes, each for its own 64 rows.  Box rows past
// the cluster's L belong to the next cluster (or half, or read zeros past
// 2KL); they land in columns >= L, which are never folded or stored.
template <int NC, bool RES>
__global__ void __launch_bounds__(AG_THREADS, 1)
ag_fwd_kernel(const __grid_constant__ CUtensorMap h_map,
              const __grid_constant__ CUtensorMap w_map,
              const float* __restrict__ b, const float* __restrict__ cv,
              float* __restrict__ part, int N, int H, int K, int L, int kb,
              int stages) {
  constexpr int HALF = NC * BOX * 2;      // bytes of one W box
  constexpr int HB = RES ? 0 : 2 * BOX_BYTES;   // a stage's h boxes
  constexpr int STAGE = HB + 2 * HALF;    // (h), the mu box, the log-sigma box
  constexpr int ACC = NC / 2;             // f32 registers of a [64 x NC] tile
  constexpr int SG = NC / 8;              // the log-sigma columns' first n
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = q_s + (RES ? 2 * AG_ROWS * H : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + stages);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(released + stages + (stages & 1));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int boxes = H / BOX;
  const int m0 = blockIdx.x * AG_ROWS;
  const int l0 = blockIdx.y * NC;
  const int g = blockIdx.z;
  const int k0 = g * kb;
  const int nk = min(K, k0 + kb) - k0;
  const int total = nk * boxes;           // stages this block streams
  const int KL = K * L;

  // stage j (cluster k0 + j / boxes, columns 64·(j % boxes)) into slot j % stages
  auto load = [&](int j) {
    const int s = j % stages;
    unsigned char* dst = ring + s * STAGE;
    const int col = (j % boxes) * BOX;
    const int row = (k0 + j / boxes) * L + l0;
    mbar_expect_tx(&full[s], STAGE);
    if constexpr (!RES) {
      tma_load(dst, &h_map, &full[s], col, m0);
      tma_load(dst + BOX_BYTES, &h_map, &full[s], col, m0 + BT);
    }
    tma_load(dst + HB, &w_map, &full[s], col, row);
    tma_load(dst + HB + HALF, &w_map, &full[s], col, KL + row);
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
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (RES) {
      // h rows [m0, m0 + 128): warpgroup w's 64 rows in boxes w·boxes..
      mbar_expect_tx(q_bar, 2 * AG_ROWS * H);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < boxes; ++c)
          tma_load(q_s + (w * boxes + c) * BOX_BYTES, &h_map, q_bar, c * BOX, m0 + w * BT);
    }
    for (int j = 0; j < min(stages, total); ++j) load(j);
  }

  // This thread's accumulator fragment of the [64 x 2NC] product with a
  // stage (both boxes are one B operand, mu rows then log-sigma rows): rows
  // r + 8i (i = 0, 1) of its warpgroup's 64; latent column l0 + cq + 8n + j
  // (n < NC / 8, j < 2) of mu at register 4n + 2i + j, of log sigma at
  // register 4(n + NC / 8) + 2i + j.
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  int row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) row[i] = m0 + wg * BT + r + 8 * i;
  float acc[2 * ACC], out_m[ACC], out_s[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) out_m[e] = out_s[e] = 0.0f;
  const uint32_t a_addr = smem_addr(q_s) + wg * boxes * BOX_BYTES;
  const uint32_t ring_addr = smem_addr(ring);
  if constexpr (RES) mbar_wait(q_bar, 0);

  for (int ci = 0; ci < nk; ++ci) {
    const int k = k0 + ci;
    // this cluster's biases and c_v weights (rounded through bf16; rows
    // past N weigh 0), requested before its products; columns >= L get 0
    float bias_m[NC / 4], bias_s[NC / 4], wgt[2];
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = l0 + 8 * n + cq + j;
        const bool in = l < L;
        bias_m[2 * n + j] = in ? __ldg(&b[k * L + l]) : 0.0f;
        bias_s[2 * n + j] = in ? __ldg(&b[KL + k * L + l]) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wgt[i] = row[i] < N ? bf16_round(cv[static_cast<size_t>(row[i]) * K + k]) : 0.0f;

    // the mu and log-sigma tiles [64 x 2NC] = h rows @ stage rows^T (one
    // m64n2NC product a k16 step, A read once for both), contracting H
    // stage by stage
    for (int c = 0; c < boxes; ++c) {
      const int j = ci * boxes + c;
      const int s = j % stages;
      mbar_wait(&full[s], (j / stages) & 1);
      const uint32_t stage = ring_addr + s * STAGE;
      const uint32_t a = RES ? a_addr + c * BOX_BYTES : stage + wg * BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma<2 * NC, 0>(acc, sw128_desc(a + kk * 32, 16),
                         sw128_desc(stage + HB + kk * 32, 16), (c | kk) != 0);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        release(j - 1);
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    release((ci + 1) * boxes - 1);

    // fold: mu + bias and exp(log sigma + bias), weighted by c_v; columns
    // >= L are never stored
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * i + j;
          out_m[e] += wgt[i] * (acc[e] + bias_m[2 * n + j]);
          out_s[e] += wgt[i] * expf(acc[4 * SG + e] + bias_s[2 * n + j]);
        }
  }

  // this group's [64, NC] blocks of q_mean and q_std
  const size_t NL = static_cast<size_t>(N) * L;
  float* om = part + 2 * static_cast<size_t>(g) * NL;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = l0 + 8 * n + cq + j;
        if (row[i] < N && l < L) {
          const size_t o = static_cast<size_t>(row[i]) * L + l;
          om[o] = out_m[4 * n + 2 * i + j];
          om[NL + o] = out_s[4 * n + 2 * i + j];
        }
      }
}

// out[i] = sum over s of part[s * len + i], s in order
__global__ void sum_partials_kernel(const float* __restrict__ part, int S,
                                    size_t len, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[static_cast<size_t>(s) * len + i];
  out[i] = acc;
}

// ---------------------------------------------------------------------
// backward 1: q recomputed, dq (bf16, [N, ldq]), db partials [row tiles,
// 2KL], dcv partials [latent tiles, N, K]
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ag_dq_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ cv,
             const float* __restrict__ gm, const float* __restrict__ gs,
             bf16* __restrict__ dq, int ldq, float* __restrict__ db_part,
             float* __restrict__ dcv_part, int N, int H, int K, int L, int kb) {
  __shared__ __align__(128) QTiles t;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int l0 = blockIdx.y * BL;
  const int g = blockIdx.z;
  const int KL = K * L;
  const int k_end = min(K, (g + 1) * kb);
  for (int k = g * kb; k < k_end; ++k) {
    q_tiles(h, w, N, H, K, L, m0, l0, k, t);
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BL;
      const int c = e % BL;
      const int n = m0 + r;
      const int l = l0 + c;
      float dqm = 0.0f, dqs = 0.0f, contrib = 0.0f;
      if (n < N && l < L) {
        const float wgt = bf16_round(cv[static_cast<size_t>(n) * K + k]);
        const int col = k * L + l;
        const float mu = t.cm[r * C_LD + c] + b[col];
        const float sg = expf(t.cs[r * C_LD + c] + b[KL + col]);
        const float g_m = gm[static_cast<size_t>(n) * L + l];
        const float g_s = gs[static_cast<size_t>(n) * L + l];
        dqm = g_m * wgt;
        dqs = g_s * wgt * sg;
        contrib = mu * g_m + sg * g_s;
        dq[static_cast<size_t>(n) * ldq + col] = __float2bfloat16(dqm);
        dq[static_cast<size_t>(n) * ldq + KL + col] = __float2bfloat16(dqs);
      }
      t.cm[r * C_LD + c] = dqm;       // each thread rewrites its own elements
      t.cs[r * C_LD + c] = dqs;
      t.ct[r * C_LD + c] = contrib;
    }
    __syncthreads();
    if (tid < 2 * BL) {               // db: column sums over the 64 rows
      const int c = tid % BL;
      const int l = l0 + c;
      const float* src = tid < BL ? t.cm : t.cs;
      if (l < L) {
        float s = 0.0f;
        for (int r = 0; r < BM; ++r) s += src[r * C_LD + c];
        const size_t col = static_cast<size_t>(tid < BL ? 0 : KL) + k * L + l;
        db_part[static_cast<size_t>(blockIdx.x) * 2 * KL + col] = s;
      }
    } else if (tid < 2 * BL + BM) {   // dcv: row sums over the 32 columns
      const int r = tid - 2 * BL;
      const int n = m0 + r;
      if (n < N) {
        float s = 0.0f;
        for (int c = 0; c < BL; ++c) s += t.ct[r * C_LD + c];
        dcv_part[(static_cast<size_t>(blockIdx.y) * N + n) * K + k] = s;
      }
    }
    __syncthreads();
  }
}

// 8 bf16 of row `row` from column c of a [rows, ld] matrix, zeros at and
// past column c_end
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ m, size_t row,
                                       int ld, int c, int c_end) {
  if (c + 8 <= c_end)
    return *reinterpret_cast<const uint4*>(&m[row * ld + c]);
  uint4 x = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&x);
  for (int j = 0; j < 8; ++j)
    if (c + j < c_end) e[j] = m[row * ld + c + j];
  return x;
}

// ---------------------------------------------------------------------
// backward 2: dW[c, e] = sum_n dq[n, c] * h[n, e], a 64 (c) x 64 (e) tile
// per block, over n in stages of 32; each element written once
// ---------------------------------------------------------------------
constexpr int WC = 64;
constexpr int WE = 64;
constexpr int WR = 32;
constexpr int WA_LD = WC + 8;    // A^T kept as [WR][WC]: column-major
constexpr int WB_LD = WE + 8;
constexpr int WC_LD = WE + 4;

__global__ void __launch_bounds__(THREADS)
ag_dw_kernel(const bf16* __restrict__ dq, int ldq, const bf16* __restrict__ h,
             float* __restrict__ dw, int N, int H, int C2) {
  __shared__ __align__(128) bf16 As[WR * WA_LD];
  __shared__ __align__(128) bf16 Bs[WR * WB_LD];
  __shared__ __align__(128) float Cs[WC * WC_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int e0 = blockIdx.x * WE;
  const int c0 = blockIdx.y * WC;
  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int n0 = 0; n0 < N; n0 += WR) {
    const int r = tid / (WC / 8);
    const int cv = (tid % (WC / 8)) * 8;
    const int n = n0 + r;
    uint4 xa = make_uint4(0, 0, 0, 0), xb = make_uint4(0, 0, 0, 0);
    if (n < N) {
      xa = load8(dq, n, ldq, c0 + cv, C2);
      xb = *reinterpret_cast<const uint4*>(&h[static_cast<size_t>(n) * H + e0 + cv]);
    }
    *reinterpret_cast<uint4*>(&As[r * WA_LD + cv]) = xa;
    *reinterpret_cast<uint4*>(&Bs[r * WB_LD + cv]) = xb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
      wmma::load_matrix_sync(af, &As[kk * WA_LD + wm * 16], WA_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * WB_LD + wn * 32 + f * 16], WB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * WC_LD + wn * 32 + f * 16], acc[f],
                            WC_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < WC * WE; e += THREADS) {
    const int r = e / WE;
    const int cc = e % WE;
    if (c0 + r < C2)
      dw[static_cast<size_t>(c0 + r) * H + e0 + cc] = Cs[r * WC_LD + cc];
  }
}

// ---------------------------------------------------------------------
// backward 3: dh_part[s][n, e] = sum over the split's columns c of
// dq[n, c] * W[c, e], a 64 (n) x 64 (e) tile per block, c in stages of 32
// ---------------------------------------------------------------------
constexpr int HM = 64;
constexpr int HN = 64;
constexpr int HK = 32;
constexpr int HA_LD = HK + 8;
constexpr int HB_LD = HN + 8;
constexpr int HC_LD = HN + 4;

__global__ void __launch_bounds__(THREADS)
ag_dh_kernel(const bf16* __restrict__ dq, int ldq, const bf16* __restrict__ w,
             float* __restrict__ dh_part, int N, int H, int C2, int chunk) {
  __shared__ __align__(128) bf16 As[HM * HA_LD];
  __shared__ __align__(128) bf16 Bs[HK * HB_LD];
  __shared__ __align__(128) float Cs[HM * HC_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int e0 = blockIdx.x * HN;
  const int m0 = blockIdx.y * HM;
  const int c_begin = blockIdx.z * chunk;
  const int c_end = min(C2, c_begin + chunk);
  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int c0 = c_begin; c0 < c_end; c0 += HK) {
    {   // A: dq rows [m0, m0+64), columns [c0, c0+32)
      const int r = tid / (HK / 8);
      const int cv = (tid % (HK / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (m0 + r < N) x = load8(dq, m0 + r, ldq, c0 + cv, c_end);
      *reinterpret_cast<uint4*>(&As[r * HA_LD + cv]) = x;
    }
    {   // B: W rows [c0, c0+32), columns [e0, e0+64)
      const int r = tid / (HN / 8);
      const int cv = (tid % (HN / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (c0 + r < c_end)
        x = *reinterpret_cast<const uint4*>(&w[static_cast<size_t>(c0 + r) * H + e0 + cv]);
      *reinterpret_cast<uint4*>(&Bs[r * HB_LD + cv]) = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wm * 16) * HA_LD + kk], HA_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * HB_LD + wn * 32 + f * 16], HB_LD);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&Cs[(wm * 16) * HC_LD + wn * 32 + f * 16], acc[f],
                            HC_LD, wmma::mem_row_major);
  __syncthreads();
  float* out = dh_part + static_cast<size_t>(blockIdx.z) * N * H;
  for (int e = tid; e < HM * HN; e += THREADS) {
    const int r = e / HN;
    const int cc = e % HN;
    if (m0 + r < N) out[static_cast<size_t>(m0 + r) * H + e0 + cc] = Cs[r * HC_LD + cc];
  }
}

int sum_partials(const float* part, int S, size_t len, float* out,
                 cudaStream_t st) {
  sum_partials_kernel<<<static_cast<int>((len + THREADS - 1) / THREADS), THREADS,
                        0, st>>>(part, S, len, out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int H, int K, int L, int kb) {
  return H <= 0 || H % 64 != 0 || K <= 0 || L <= 0 || kb <= 0 || kb > K;
}

// grid (ceil(N / 128), ceil(L / NC), ceil(K / kb)); h and W through tensor
// maps of 64-row and NC-row boxes
template <int NC, bool RES>
int launch_ag_fwd_kernel(const void* h, const void* w, const void* b, const void* cv,
                  void* part, int N, int H, int K, int L, int kb, cudaStream_t st) {
  const int stages = ag_fwd_stages(H, NC, RES);
  CUtensorMap h_map, w_map;
  int err = row_tile_map(&h_map, static_cast<const bf16*>(h), N, H);
  if (err) return err;
  err = row_tile_map(&w_map, static_cast<const bf16*>(w), 2 * K * L, H, NC);
  if (err) return err;
  const size_t smem = ag_fwd_smem(H, NC, RES, stages);
  err = static_cast<int>(cudaFuncSetAttribute(
      ag_fwd_kernel<NC, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const dim3 grid((N + AG_ROWS - 1) / AG_ROWS, (L + NC - 1) / NC, (K + kb - 1) / kb);
  ag_fwd_kernel<NC, RES><<<grid, AG_THREADS, smem, st>>>(
      h_map, w_map, static_cast<const float*>(b), static_cast<const float*>(cv),
      static_cast<float*>(part), N, H, K, L, kb, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_ag_fwd(const void* h, const void* w, const void* b, const void* cv,
                  void* part, int N, int H, int K, int L, int kb, cudaStream_t st) {
  return ag_fwd_resident(H, NC)
             ? launch_ag_fwd_kernel<NC, true>(h, w, b, cv, part, N, H, K, L, kb, st)
             : launch_ag_fwd_kernel<NC, false>(h, w, b, cv, part, N, H, K, L, kb, st);
}

}  // namespace

// Shape rule: H % 64 == 0.  Each returns a cudaError_t as int.

// h16 [N, H], w16 [2KL, H] bf16; b [2KL], cv [N, K] f32; part [G, 2, N, L]
// f32 workspace (G = ceil(K / kb)); out [2, N, L] f32 (q_mean, q_std).  The
// forward's blocks take kb clusters and `cols` latent columns (40 or 80):
// ops/fused_ag_heads.py's ag_fwd_plan picks both.
extern "C" int vct_fused_ag_heads_fwd(const void* h, const void* w, const void* b,
                                      const void* cv, void* part, void* out,
                                      int N, int H, int K, int L, int kb, int cols,
                                      void* stream) {
  if (N <= 0) return 0;
  if (bad_shape(H, K, L, kb) || (cols != 40 && cols != 80))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = cols == 40 ? launch_ag_fwd<40>(h, w, b, cv, part, N, H, K, L, kb, st)
                             : launch_ag_fwd<80>(h, w, b, cv, part, N, H, K, L, kb, st);
  if (err) return err;
  return sum_partials(static_cast<const float*>(part), (K + kb - 1) / kb,
                      2 * static_cast<size_t>(N) * L, static_cast<float*>(out), st);
}

// the forward's dynamic shared memory at width H with `cols` latent columns
// a block (bytes; 0 for another `cols`)
extern "C" int vct_fused_ag_heads_fwd_smem(int H, int cols) {
  if (cols != 40 && cols != 80) return 0;
  const bool res = ag_fwd_resident(H, cols);
  return static_cast<int>(ag_fwd_smem(H, cols, res, ag_fwd_stages(H, cols, res)));
}

// g_mean, g_std [N, L] f32 -> dw [2KL, H], db [2KL], dcv [N, K], dh [N, H]
// f32.  Workspaces: dq [N, ldq] bf16 (ldq >= 2KL, a multiple of 8);
// db_part [ceil(N/64), 2KL]; dcv_part [ceil(L/32), N, K]; dh_part
// [splits, N, H] f32.
extern "C" int vct_fused_ag_heads_bwd(const void* h, const void* w, const void* b,
                                      const void* cv, const void* g_mean,
                                      const void* g_std, void* dq, int ldq,
                                      void* db_part, void* dcv_part, void* dh_part,
                                      void* dw, void* db, void* dcv, void* dh,
                                      int N, int H, int K, int L, int kb,
                                      int splits, void* stream) {
  if (N <= 0) return 0;
  const int C2 = 2 * K * L;
  if (bad_shape(H, K, L, kb) || ldq < C2 || ldq % 8 != 0 || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (N + BM - 1) / BM;
  const int lat_tiles = (L + BL - 1) / BL;
  const dim3 g1(row_tiles, lat_tiles, (K + kb - 1) / kb);
  ag_dq_kernel<<<g1, THREADS, 0, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(cv),
      static_cast<const float*>(g_mean), static_cast<const float*>(g_std),
      static_cast<bf16*>(dq), ldq, static_cast<float*>(db_part),
      static_cast<float*>(dcv_part), N, H, K, L, kb);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = sum_partials(static_cast<const float*>(db_part), row_tiles, C2,
                     static_cast<float*>(db), st);
  if (err) return err;
  err = sum_partials(static_cast<const float*>(dcv_part), lat_tiles,
                     static_cast<size_t>(N) * K, static_cast<float*>(dcv), st);
  if (err) return err;
  const dim3 g2(H / WE, (C2 + WC - 1) / WC);
  ag_dw_kernel<<<g2, THREADS, 0, st>>>(
      static_cast<const bf16*>(dq), ldq, static_cast<const bf16*>(h),
      static_cast<float*>(dw), N, H, C2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // the splits' column ranges: whole stages of HK columns
  int chunk = (C2 + splits - 1) / splits;
  chunk = (chunk + HK - 1) / HK * HK;
  const int S = (C2 + chunk - 1) / chunk;
  const dim3 g3(H / HN, (N + HM - 1) / HM, S);
  ag_dh_kernel<<<g3, THREADS, 0, st>>>(
      static_cast<const bf16*>(dq), ldq, static_cast<const bf16*>(w),
      static_cast<float*>(dh_part), N, H, C2, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(static_cast<const float*>(dh_part), S,
                      static_cast<size_t>(N) * H, static_cast<float*>(dh), st);
}
