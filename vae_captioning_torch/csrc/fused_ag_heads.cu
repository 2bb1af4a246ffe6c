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
// * Forward (ag_fwd_kernel<NC, RES, false>, wgmma + TMA on the primitives of
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
// * Backward, three wgmma + TMA kernels and three ordered sums; dq is
//   written once in bf16 ([N, 2*K*L], 69 MB at the train shapes) and read
//   by the two products:
//   - the dq pass is the forward's template with BWD: the same blocks,
//     stages and products recompute the mu and log-sigma tiles, and after
//     a cluster's last stage each thread forms, from registers, dq_m =
//     g_mean·c̃ and dq_s = g_std·c̃·sigma (c̃ = bf16(cv), sigma = exp(log
//     sigma + b)) for its 2 rows x NC / 4 latent columns, stores them in
//     bf16 (4-byte pairs where the column is even, masked at l < L), sums
//     mu·g_mean + sigma·g_std over the quad's columns into per-latent-tile
//     dc_v partials [lat_tiles, N, K], and the f32 dq over the warp's 16
//     rows (shuffles) into per-warp db partials [8·ceil(N / 128), 2KL].
//     g_mean and g_std do not depend on k: each thread loads its NC values
//     once, in place of the forward's fold registers (NC = 40: at 80 the
//     forward alone holds 254 registers).
//   - dW = dq^T @ h and dh = dq @ W (ag_mat_kernel<CT, DW>): plain products
//     over the flat column index c < 2KL that dq and W share, on the
//     product loop of mat_ring.cuh that the written-logits backward
//     (fused_ce_mat.cu) shares, with no per-tile step (the CE's forms dl
//     there): a block owns 64 output rows (c rows of dW, h rows of dh) and
//     CT output columns (the largest of 512, 256, 128, 64 dividing H; a
//     grid dimension over H / CT), and streams K tiles [64 x CT] (h for
//     dW, W for dh) with the matching 64 x 64 dq box through a TMA ring;
//     two consumer warpgroups own CT / 2 columns each; dW reads the dq box
//     MN-major (transposed).  dW has 2KL / 64 row tiles and needs no
//     split; dh splits the 2KL / 64 contraction tiles into ranges of `per`
//     tiles, [S, N, H] partials.  dq's tensor map ends at column 2KL, so
//     the pitch's pad columns read zeros.
//   ops/fused_ag_heads.py's ag_bwd_plan picks NC, kb, CT and the split.
// * Determinism: no float atomics.  Every cross-block sum (db, dc_v, the
//   dh splits, the forward's groups) is a partial buffer reduced by one
//   thread per element, in index order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "mat_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // the partial sums

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

// The dq pass's operands (the forward passes none): g_mean, g_std [N, L]
// f32 in; dq [N, ldq] bf16, db_part [8·ceil(N / 128), 2KL] (one partial per
// 16 rows: a warp's) and dcv_part [ceil(L / NC), N, K] f32 out.
struct DqArgs {
  const float* gm;
  const float* gs;
  bf16* dq;
  int ldq;
  float* db_part;
  float* dcv_part;
};

// The dq pass after cluster k's products: this thread's 2 rows x NC / 4
// latent columns of the mu tile (registers 4n + 2i + j) and the log-sigma
// tile (4(n + NC / 8) + 2i + j), as in ag_fwd_kernel.
//   dq_m = g_mean·c̃,  dq_s = g_std·c̃·sigma,  sigma = exp(log sigma + b)
// stored in bf16 at rows < N, columns l < L; dc_v's term mu·g_mean +
// sigma·g_std summed over the quad's columns into dcv_part[latent tile];
// the f32 dq summed over the warp's 16 rows into db_part[row16].
template <int NC>
__device__ __forceinline__ void dq_epilogue(
    const float (&acc)[NC], const float (&bias_m)[NC / 4],
    const float (&bias_s)[NC / 4], const float (&wgt)[2],
    const float (&g_m)[NC / 2], const float (&g_s)[NC / 2], const DqArgs& da,
    const int (&row)[2], int N, int K, int L, int k, int l0, int cq, int row16) {
  constexpr int SG = NC / 8;
  const int KL = K * L;
  const int C2 = 2 * KL;
  const int lane = threadIdx.x % 32;
  float dcv[2] = {0.0f, 0.0f};
  float db_m[NC / 4], db_s[NC / 4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) db_m[2 * n + j] = db_s[2 * n + j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float dqm[2], dqs[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * n + 2 * i + j;
        const bool in = row[i] < N && l0 + 8 * n + cq + j < L;
        const float mu = acc[e] + bias_m[2 * n + j];
        const float sg = expf(acc[4 * SG + e] + bias_s[2 * n + j]);
        dqm[j] = g_m[e] * wgt[i];
        dqs[j] = in ? g_s[e] * wgt[i] * sg : 0.0f;
        dcv[i] += in ? mu * g_m[e] + sg * g_s[e] : 0.0f;
        db_m[2 * n + j] += dqm[j];
        db_s[2 * n + j] += dqs[j];
      }
      // bf16 stores: a 4-byte pair where both columns are in and the
      // column is even (odd L makes k·L + l odd for some pairs)
      const int l = l0 + 8 * n + cq;
      if (row[i] < N && l < L) {
        bf16* d = da.dq + static_cast<size_t>(row[i]) * da.ldq + k * L + l;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          bf16* p = d + half * KL;
          const float* v = half ? dqs : dqm;
          if (l + 1 < L && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
          } else {
            p[0] = __float2bfloat16(v[0]);
            if (l + 1 < L) p[1] = __float2bfloat16(v[1]);
          }
        }
      }
    }
  }
  // dc_v: the quad's columns, then one store per row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dcv[i] += __shfl_xor_sync(0xffffffffu, dcv[i], 1);
    dcv[i] += __shfl_xor_sync(0xffffffffu, dcv[i], 2);
    if (lane % 4 == 0 && row[i] < N)
      da.dcv_part[(static_cast<size_t>(blockIdx.y) * N + row[i]) * K + k] = dcv[i];
  }
  // db: the 8 lanes that share columns (lane / 4), then lanes 0-3 store
#pragma unroll
  for (int v = 0; v < NC / 4; ++v)
#pragma unroll
    for (int x = 4; x < 32; x *= 2) {
      db_m[v] += __shfl_xor_sync(0xffffffffu, db_m[v], x);
      db_s[v] += __shfl_xor_sync(0xffffffffu, db_s[v], x);
    }
  if (lane < 4) {
    float* out = da.db_part + static_cast<size_t>(row16) * C2 + k * L;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int l = l0 + 8 * n + cq + j;
        if (l < L) {
          out[l] = db_m[2 * n + j];
          out[KL + l] = db_s[2 * n + j];
        }
      }
  }
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
// BWD: the backward's dq pass on the same tiles; it writes no part (see
// DqArgs).
template <int NC, bool RES, bool BWD>
__global__ void __launch_bounds__(AG_THREADS, 1)
ag_fwd_kernel(const __grid_constant__ CUtensorMap h_map,
              const __grid_constant__ CUtensorMap w_map,
              const float* __restrict__ b, const float* __restrict__ cv,
              float* __restrict__ part, int N, int H, int K, int L, int kb,
              int stages, const DqArgs da) {
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
  // BWD: this thread's g_mean and g_std, at the fragment's registers (0 at
  // rows past N and columns past L); they do not depend on the cluster
  float g_m[BWD ? ACC : 1], g_s[BWD ? ACC : 1];
  if constexpr (BWD) {
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int l = l0 + 8 * n + cq + j;
          const bool in = row[i] < N && l < L;
          const size_t o = static_cast<size_t>(row[i]) * L + l;
          g_m[4 * n + 2 * i + j] = in ? __ldg(&da.gm[o]) : 0.0f;
          g_s[4 * n + 2 * i + j] = in ? __ldg(&da.gs[o]) : 0.0f;
        }
  }
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

    if constexpr (BWD) {
      dq_epilogue<NC>(acc, bias_m, bias_s, wgt, g_m, g_s, da, row, N, K, L, k,
                      l0, cq, blockIdx.x * 8 + wg * 4 + warp);
    } else {
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
  }
  if constexpr (BWD) return;

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

// ---------------------------------------------------------------------
// backward products: dW = dq^T @ h and dh = dq @ W (wgmma + TMA)
// ---------------------------------------------------------------------
// Grid (output row tiles, column tiles of CT, K ranges).  Block (x, y, z)
// owns output rows [64x, 64x + 64), columns [CT·y, CT·y + CT) and K tiles
// [z·per, min(k_tiles, (z + 1)·per)), at least one: mat_ring.cuh's product
// loop with no per-tile step.
//   DW = true:  K = h [N, H]; dq box (x: the out rows, y: the K rows), read
//               MN-major; out = dw [64·gridDim.x, H].
//   DW = false: K = W [2KL, H]; dq box (x: the K rows, y: the out rows),
//               K-major; out = dh_part [gridDim.z, 64·gridDim.x, H].
template <int CT, bool DW>
__global__ void __launch_bounds__(MAT_THREADS, 1)
ag_mat_kernel(const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap dq_map, float* __restrict__ out,
              int H, int k_tiles, int per) {
  static_assert(MatRing<CT>::smem(0) <= 232448, "one block per SM: 227 KB of shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  const int x0 = blockIdx.x * BT;
  const int e0 = blockIdx.y * CT;
  const int t0 = blockIdx.z * per;
  float acc[MatRing<CT>::ACC];
  mat_ring_product<CT, DW>(acc, ring, &k_map, &dq_map, x0, e0, t0,
                           min(k_tiles, t0 + per) - t0,
                           [](int, unsigned char*, auto&& wait) { wait(); });
  const size_t Xp = static_cast<size_t>(gridDim.x) * BT;
  mat_ring_store<CT>(acc, out + (DW ? 0 : blockIdx.z * Xp * H), H, x0, e0);
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
template <int NC, bool RES, bool BWD>
int launch_ag_fwd_kernel(const void* h, const void* w, const void* b, const void* cv,
                         void* part, const DqArgs& da, int N, int H, int K, int L,
                         int kb, cudaStream_t st) {
  const int stages = ag_fwd_stages(H, NC, RES);
  CUtensorMap h_map, w_map;
  int err = row_tile_map(&h_map, static_cast<const bf16*>(h), N, H);
  if (err) return err;
  err = row_tile_map(&w_map, static_cast<const bf16*>(w), 2 * K * L, H, NC);
  if (err) return err;
  const size_t smem = ag_fwd_smem(H, NC, RES, stages);
  err = static_cast<int>(cudaFuncSetAttribute(
      ag_fwd_kernel<NC, RES, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const dim3 grid((N + AG_ROWS - 1) / AG_ROWS, (L + NC - 1) / NC, (K + kb - 1) / kb);
  ag_fwd_kernel<NC, RES, BWD><<<grid, AG_THREADS, smem, st>>>(
      h_map, w_map, static_cast<const float*>(b), static_cast<const float*>(cv),
      static_cast<float*>(part), N, H, K, L, kb, stages, da);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool BWD>
int launch_ag_fwd(const void* h, const void* w, const void* b, const void* cv,
                  void* part, const DqArgs& da, int N, int H, int K, int L, int kb,
                  cudaStream_t st) {
  return ag_fwd_resident(H, NC)
             ? launch_ag_fwd_kernel<NC, true, BWD>(h, w, b, cv, part, da, N, H, K, L, kb, st)
             : launch_ag_fwd_kernel<NC, false, BWD>(h, w, b, cv, part, da, N, H, K, L, kb, st);
}

// out rows 64·ceil(rows / 64) x H from K [k_rows, H] against dq's tensor
// map; grid (ceil(rows / 64), H / CT, splits)
template <int CT, bool DW>
int launch_mat(const bf16* k, int k_rows, const CUtensorMap& dq_map, float* out,
               int rows, int H, int splits, int per, cudaStream_t st) {
  CUtensorMap k_map;
  int err = row_tile_map(&k_map, k, k_rows, H);
  if (err) return err;
  constexpr size_t smem = MatRing<CT>::smem(0);
  err = static_cast<int>(cudaFuncSetAttribute(
      ag_mat_kernel<CT, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const dim3 grid((rows + BT - 1) / BT, H / CT, splits);
  ag_mat_kernel<CT, DW><<<grid, MAT_THREADS, smem, st>>>(
      k_map, dq_map, out, H, (k_rows + BT - 1) / BT, per);
  return static_cast<int>(cudaGetLastError());
}

// dW (no split) and the dh partials at column tile CT
template <int CT>
int launch_products(const bf16* h, const bf16* w, const CUtensorMap& dq_map,
                    float* dw, float* dh_part, int N, int H, int C2, int splits,
                    int per, cudaStream_t st) {
  const int n_tiles = (N + BT - 1) / BT;
  const int err = launch_mat<CT, true>(h, N, dq_map, dw, C2, H, 1, n_tiles, st);
  if (err) return err;
  return launch_mat<CT, false>(w, C2, dq_map, dh_part, N, H, splits, per, st);
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
  const DqArgs none{};
  const int err =
      cols == 40 ? launch_ag_fwd<40, false>(h, w, b, cv, part, none, N, H, K, L, kb, st)
                 : launch_ag_fwd<80, false>(h, w, b, cv, part, none, N, H, K, L, kb, st);
  if (err) return err;
  return sum_partials(static_cast<const float*>(part), (K + kb - 1) / kb,
                      2 * static_cast<size_t>(N) * L, static_cast<float*>(out), st);
}

// the forward's dynamic shared memory at width H with `cols` latent columns
// a block (bytes; 0 for another `cols`); the dq pass's likewise at 40
extern "C" int vct_fused_ag_heads_fwd_smem(int H, int cols) {
  if (cols != 40 && cols != 80) return 0;
  const bool res = ag_fwd_resident(H, cols);
  return static_cast<int>(ag_fwd_smem(H, cols, res, ag_fwd_stages(H, cols, res)));
}

// the products' dynamic shared memory at column tile ct (bytes; 0 for
// another ct)
extern "C" int vct_fused_ag_heads_mat_smem(int ct) {
  switch (ct) {
    case 64: return static_cast<int>(MatRing<64>::smem(0));
    case 128: return static_cast<int>(MatRing<128>::smem(0));
    case 256: return static_cast<int>(MatRing<256>::smem(0));
    case 512: return static_cast<int>(MatRing<512>::smem(0));
    default: return 0;
  }
}

// g_mean, g_std [N, L] f32 -> dw, db [2KL], dcv [N, K], dh f32 (dw and dh
// padded, see below).  The dq pass's blocks take kb clusters and 40 latent columns
// (`cols`); the products take `ct` output columns (64, 128, 256 or 512,
// dividing H), and dh's split s the contraction tiles [s·per, (s + 1)·per)
// of 64 columns.  Workspaces: dq [N, ldq] bf16 (ldq >= 2KL, a multiple of
// 8); db_part [8·ceil(N / 128), 2KL]; dcv_part [ceil(L / cols), N, K];
// dh_part [ceil(ceil(2KL / 64) / per), Np, H] f32.  dw and dh are padded to
// 64-row tiles: dw [64·ceil(2KL / 64), H], dh [Np, H], Np = 64·ceil(N / 64);
// the pad rows hold zeros (dq's pad rows and columns read zeros).
extern "C" int vct_fused_ag_heads_bwd(const void* h, const void* w, const void* b,
                                      const void* cv, const void* g_mean,
                                      const void* g_std, void* dq, int ldq,
                                      void* db_part, void* dcv_part, void* dh_part,
                                      void* dw, void* db, void* dcv, void* dh,
                                      int N, int H, int K, int L, int kb, int cols,
                                      int ct, int per, void* stream) {
  if (N <= 0) return 0;
  const int C2 = 2 * K * L;
  if (bad_shape(H, K, L, kb) || ldq < C2 || ldq % 8 != 0 || cols != 40 || per <= 0 ||
      (ct != 64 && ct != 128 && ct != 256 && ct != 512) || H % ct != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DqArgs da{static_cast<const float*>(g_mean), static_cast<const float*>(g_std),
                  static_cast<bf16*>(dq), ldq, static_cast<float*>(db_part),
                  static_cast<float*>(dcv_part)};
  // the dq pass at 40 latent columns: at 80 it spills (255 registers and 72
  // bytes, even with its biases read after the products)
  int err = launch_ag_fwd<40, true>(h, w, b, cv, nullptr, da, N, H, K, L, kb, st);
  if (err) return err;
  err = sum_partials(static_cast<const float*>(db_part), 8 * ((N + AG_ROWS - 1) / AG_ROWS),
                     C2, static_cast<float*>(db), st);
  if (err) return err;
  err = sum_partials(static_cast<const float*>(dcv_part), (L + cols - 1) / cols,
                     static_cast<size_t>(N) * K, static_cast<float*>(dcv), st);
  if (err) return err;
  // dq [N, C2] at pitch ldq: columns past C2 read zeros
  CUtensorMap dq_map;
  err = row_tile_map(&dq_map, static_cast<const bf16*>(dq), N, C2, BT, ldq);
  if (err) return err;
  const int c_tiles = (C2 + BT - 1) / BT;
  const int splits = (c_tiles + per - 1) / per;
  const bf16* h16 = static_cast<const bf16*>(h);
  const bf16* w16 = static_cast<const bf16*>(w);
  float* dwf = static_cast<float*>(dw);
  float* part = static_cast<float*>(dh_part);
  switch (ct) {
    case 64: err = launch_products<64>(h16, w16, dq_map, dwf, part, N, H, C2, splits, per, st); break;
    case 128: err = launch_products<128>(h16, w16, dq_map, dwf, part, N, H, C2, splits, per, st); break;
    case 256: err = launch_products<256>(h16, w16, dq_map, dwf, part, N, H, C2, splits, per, st); break;
    default: err = launch_products<512>(h16, w16, dq_map, dwf, part, N, H, C2, splits, per, st); break;
  }
  if (err) return err;
  const size_t Np = static_cast<size_t>(BT) * ((N + BT - 1) / BT);
  return sum_partials(part, splits, Np * H, static_cast<float*>(dh), st);
}
