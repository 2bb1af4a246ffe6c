// Fused logits product + exact top-k + logsumexp, its int8 variant, and
// fused Gumbel-max sampling, for Hopper (sm_90a), exported with a plain C
// interface and loaded through ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernels of vae_captioning_tpu/ops/fused_logits_topk.py:
//
//   _kernel (+ _fold_tile), through fused_logits_top_k:
//     logits = h @ W + b            bf16 operands, f32 accumulation
//     vals, idx = top_k(logits, k)  ties go to the lowest vocab index
//     lse = logsumexp(logits)
//   _kernel_int8 (+ _fold_tile), through fused_logits_top_k_int8:
//     logits = f32(hq @ wq) * hs * ws + b   int8 operands, int32 accumulation
//     then the same top-k and logsumexp
//   _sample_kernel, through fused_logits_sample:
//     token = argmax_v(logits_v * inv_temp + G_v),  G = -log(-log(u))
//
// and, for lists longer than 16 (beams of 17 and more), the same product
// with the logits stored, bf16 or int8, for the top-k + logsumexp kernel
// over written logits (topk_lse.cu) to take (vct_fused_logits_write*).
//
// h [M,H] bf16 and the head transposed, w_t [V,H] bf16 (W^T, contiguous:
// the decode stores the head so), b [V] f32; hq [M,H] int8 with per-row
// scales hs [M] f32, wq_t [V,H] int8 with per-column scales ws [V] f32 ->
// vals [M,k] f32 (raw logits, bias included), idx [M,k] int32, lse [M]
// f32, for 1 <= k <= 16; the sampler -> tokens [M] int32; the writer ->
// logits [M, V] f32.
//
// What bounds it on this card: tensor-core operations, 2·M·H·V (18 GFLOP at
// M = 1536, H = 512, V = 11500: 0.018 ms at the dense bf16 rate, 0.009 in
// int8) over an 11.8 MB bf16 (5.9 MB int8) head, which is read from device
// memory once and from L2 once per block of rows.  The logits are never
// stored.  In practice the fold binds it: its products alone run at about
// half the bf16 peak, as the CE forward's do, and at k = 10 the lists'
// updates take as long again (PERF.md, the logits top-k's design table).
//
// The design is the CE forward's (fused_ce.cuh), on the same product loop
// (row_ring.cuh's RowRing):
// * A block keeps 128 rows of h resident in shared memory (TMA, 64-row
//   boxes of 128 bytes, 128-byte swizzle) and streams the head's 128-row
//   vocab tiles of W^T through an mbarrier ring; two consumer warpgroups,
//   each on its 64 rows (m64n128: wgmma bf16 k16, or s8 k32 with int32
//   accumulators).  H is a runtime value: a tile's product runs over its
//   ceil(H·bytes / 128) boxes, TMA reading zeros past H.  The decode's own
//   width (H = 512: 8 bf16 boxes, 4 int8) is also built with the count at
//   compile time, as the CE forward has it, which the compiler schedules
//   far better (0.26 against 0.32 ms at M = 5120, k = 10, and 0.11
//   against 0.18 for the product alone; PERF.md).  Where 128 rows
//   of h do not fit beside a ring of four boxes (bf16 H > 640; and for
//   lists of 16, whose registers do not fit beside 64 accumulators), a
//   block takes 64 rows and its warpgroups split each tile's columns
//   (m64n64); past bf16 H = 1280 (int8 2560) those 64 rows are streamed
//   beside each W box.  The sampler takes 64-row blocks: at 128 its
//   Philox words beside 64 accumulators spilled.
// * The fold, from the accumulators: each thread owns 2 rows x 32 (or 16)
//   columns of a tile, visited in ascending column order, and keeps for
//   each row a register top-k list (topk_list.cuh: value descending, index
//   ascending; each column goes in by push_ascending, branch-free: a
//   branching insertion was taken by some lane of nearly every warp at
//   every column, at 1.5x the time at k = 10) beside the row's online
//   (max, sum-exp); the 4 lanes of a row share the tile's row max by two
//   shuffles (a lane whose columns are all past V would otherwise hold max
//   -1e30), each exp is one FFMA and one ex2.approx.  Columns past V take
//   bias -1e30 (exp 0) and never enter a list.  The int8 logit is dequantised exactly as the plain version
//   does it, (f32(acc) · hs) · ws + b, each step rounded on its own, so
//   values and indices equal int8_top_k_plain's bit for bit.
// * Vocab chunks: grid (row blocks, vocab chunks), chunk y taking the
//   tiles [y·chunk_tiles, (y + 1)·chunk_tiles); each block writes one
//   partial list and (max, sum-exp) per row and warpgroup, the 4 lanes of
//   a row merged by shuffles first (writing each lane's list cost the
//   merge launch more than the shuffles save; PERF.md).  A merge
//   launch, eight threads per row, folds the partials in a fixed order,
//   so results repeat bit for bit (no atomics).  The block shape comes
//   from block_shape (vct_fused_logits_top_k_block), the chunks from
//   ops/fused_logits_topk.py:chunk_plan.
// * Lists hold K = 1, 3, 10 or 16 entries, k rounded up: the first k of a
//   list of K are the top k.
// * The sampler is the same kernel with K = 1 over the scored values
//   logit * inv_temp + G and no logsumexp.
// * The logits writer is the same kernel again, its fold replaced by a
//   store of each accumulator pair's two logits (8 bytes; a row's 4 lanes
//   write 32 contiguous bytes) into [M, V] f32, and no merge launch.  It
//   writes what the fold would have seen: bf16 acc + b, and the int8
//   logit bit for bit as int8_logits computes it.
//
// The sampler's noise: Philox-4x32-10 keyed on (seed, step), element
// (row m, column v) is word v % 4 of the block with counter
// (v / 4, row0 + m, 0, SAMPLE_TAG); fused_z's counters have 0 in the last
// word, so the two streams never meet.  A thread's columns come in even
// pairs, so one block gives a pair its two words (two lanes compute each
// block).  The stream does not depend on the tiling, so
// ops/fused_logits_topk.py:fused_logits_sample_plain reproduces its bits
// exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "row_ring.cuh"
#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;    // two consumer warpgroups
constexpr int TV = RING_TV;     // vocab columns of a tile
constexpr int MERGE_THREADS = 128;
constexpr int MERGE_LANES = 8;  // merge threads a row (a divisor of 32)
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t SAMPLE_TAG = 0x53414D50u;  // "SAMP"

// ---------------------------------------------------------------------
// the logit of an accumulator: bf16 (S + b) or int8 (dequantised)
// ---------------------------------------------------------------------

struct Bf16Logit {
  using Op = Bf16Op;
  static constexpr int BOXES = 8;   // the decode's width, H = 512
  struct Col { float b; };
  const float* b;

  __device__ __forceinline__ float row_scale(int) const { return 1.0f; }
  __device__ __forceinline__ Col col(int c, int V) const {
    return Col{c < V ? __ldg(&b[c]) : NEG};
  }
  __device__ __forceinline__ static float value(float acc, float, Col c) {
    return acc + c.b;
  }
};

// (f32(acc) * hs) * ws + b, each step rounded on its own (no FMA), in the
// order of the TPU kernel and of the plain version
struct S8Logit {
  using Op = S8Op;
  static constexpr int BOXES = 4;   // the decode's width, H = 512
  struct Col { float ws, b; };
  const float* hs;
  const float* ws;
  const float* b;

  __device__ __forceinline__ float row_scale(int row) const { return __ldg(&hs[row]); }
  __device__ __forceinline__ Col col(int c, int V) const {
    return c < V ? Col{__ldg(&ws[c]), __ldg(&b[c])} : Col{0.0f, NEG};
  }
  __device__ __forceinline__ static float value(int acc, float rs, Col c) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), c.ws), c.b);
  }
};

// the fold works on the logits in place of the accumulators: an int8
// kernel's int registers hold them as float bits
__device__ __forceinline__ float as_f(float x) { return x; }
__device__ __forceinline__ float as_f(int x) { return __int_as_float(x); }
__device__ __forceinline__ void put(float& d, float x) { d = x; }
__device__ __forceinline__ void put(int& d, float x) { d = __float_as_int(x); }

// ---------------------------------------------------------------------
// what is folded: the raw logit (top-k + logsumexp), or the Gumbel-scored
// logit (sampling: top-1 only)
// ---------------------------------------------------------------------

struct RawLogit {
  static constexpr bool kLse = true;
  static constexpr bool kWrite = false;
  __device__ __forceinline__ void pair(float&, float&, int, int) const {}
};

struct GumbelScore {
  static constexpr bool kLse = false;
  static constexpr bool kWrite = false;
  uint32_t seed, step;
  float inv_temp;
  int row0;

  // columns col, col + 1 (col even) of global row `row`: words col % 4 and
  // col % 4 + 1 of one Philox block
  __device__ __forceinline__ void pair(float& x0, float& x1, int row, int col) const {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(col) >> 2,
                   static_cast<uint32_t>(row0 + row), 0u, SAMPLE_TAG),
        seed, step);
    const bool hi = col & 2;
    const float g0 = -logf(-logf(bits_to_uniform(hi ? r.z : r.x)));
    const float g1 = -logf(-logf(bits_to_uniform(hi ? r.w : r.y)));
    x0 = __fadd_rn(__fmul_rn(x0, inv_temp), g0);
    x1 = __fadd_rn(__fmul_rn(x1, inv_temp), g1);
  }
};

// the logits stored, [M, V] f32 (row stride V), in place of the fold
struct WriteLogits {
  static constexpr bool kLse = false;
  static constexpr bool kWrite = true;
  float* out;
  __device__ __forceinline__ void pair(float&, float&, int, int) const {}
};

struct Parts {
  float* vals;   // [P, M, K]
  int* idx;      // [P, M, K]
  float* max;    // [P, M]
  float* sum;    // [P, M]
};

// Grid (row blocks of 64·RG, vocab chunks).  Partial p = chunk ·
// (warpgroups that split a tile: 2 at RG = 1) + that warpgroup.  BOXES:
// the boxes of a row of h at compile time, or 0 for the runtime count
// `boxes`.
template <class Logit, int RG, bool RES, int BOXES, class Score, int K>
__global__ void __launch_bounds__(THREADS, 1)
logits_topk_kernel(const __grid_constant__ CUtensorMap h_map,
                   const __grid_constant__ CUtensorMap w_map, const Logit logit,
                   const Score score, const Parts part, int M, int V, int boxes,
                   int chunk_tiles) {
  using Ring = RowRing<typename Logit::Op, RG, RES, BOXES>;
  constexpr int NW = Ring::N;              // a warpgroup's columns of a tile
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * RG * BT;
  const int tiles = (V + TV - 1) / TV;
  const int t0 = blockIdx.y * chunk_tiles;
  const int n_tiles = max(0, min(tiles, t0 + chunk_tiles) - t0);
  const Ring ring(smem, boxes, &h_map, &w_map, m0, t0, n_tiles);
  ring.start();

  // this thread's rows r + 8·ii of its warpgroup's 64, columns 8n + cq + j
  // of its warpgroup's NW (row_ring.cuh's accumulator layout)
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  int row[2];
  float rs[2], m_run[2], s_run[2];
  TopK<K> top[2];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    row[ii] = m0 + (RG == 2 ? wg * BT : 0) + r + 8 * ii;
    rs[ii] = logit.row_scale(min(row[ii], M - 1));
    m_run[ii] = -INFINITY;
    s_run[ii] = 0.0f;
    top[ii].init();
  }
  typename Ring::Acc acc[NW / 2];
  ring.wait_rows();

  for (int i = 0; i < n_tiles; ++i) {
    const int v0 = (t0 + i) * TV + (RG == 1 ? wg * NW : 0);  // the warpgroup's first column
    const int cb = v0 + cq;                                   // this thread's
    // the tile's column parameters (bias; int8: and scale), requested
    // before its products so that the loads land while they run
    typename Logit::Col col[NW / 4];
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) col[2 * n + j] = logit.col(cb + 8 * n + j, V);
    ring.product(i, acc);
    // RG = 1: this warpgroup's half of the last tile may lie past V
    if (v0 >= V) continue;

    if constexpr (Score::kWrite) {
#pragma unroll
      for (int n = 0; n < NW / 8; ++n)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int c = cb + 8 * n;
          if (row[ii] >= M || c >= V) continue;
          const float x0 = Logit::value(acc[4 * n + 2 * ii], rs[ii], col[2 * n]);
          const float x1 = Logit::value(acc[4 * n + 2 * ii + 1], rs[ii], col[2 * n + 1]);
          float* o = score.out + static_cast<size_t>(row[ii]) * V + c;
          if (c + 1 < V && V % 2 == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
          } else {
            o[0] = x0;
            if (c + 1 < V) o[1] = x1;
          }
        }
      continue;
    }

    // logits (and the sampler's scores) in place
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float x0 = Logit::value(acc[4 * n + 2 * ii], rs[ii], col[2 * n]);
        float x1 = Logit::value(acc[4 * n + 2 * ii + 1], rs[ii], col[2 * n + 1]);
        score.pair(x0, x1, row[ii], cb + 8 * n);
        put(acc[4 * n + 2 * ii], x0);
        put(acc[4 * n + 2 * ii + 1], x1);
      }
    const int lim = V - cb;    // offsets 8n + j < lim lie inside the vocabulary
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      if constexpr (Score::kLse) {
        float tmax = as_f(acc[2 * ii]);
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
          tmax = fmaxf(tmax, fmaxf(as_f(acc[4 * n + 2 * ii]), as_f(acc[4 * n + 2 * ii + 1])));
        // the row's tile max over its 4 lanes: finite, since the
        // warpgroup's first column is < V
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 2));
        const float m_new = fmaxf(m_run[ii], tmax);
        const float ms = m_new * LOG2E;
        float se = 0.0f;
#pragma unroll
        for (int n = 0; n < NW / 8; ++n)
          se += ex2(fmaf(as_f(acc[4 * n + 2 * ii]), LOG2E, -ms)) +
                ex2(fmaf(as_f(acc[4 * n + 2 * ii + 1]), LOG2E, -ms));
        s_run[ii] = s_run[ii] * ex2((m_run[ii] - m_new) * LOG2E) + se;
        m_run[ii] = m_new;
      }
    }
    // both rows' lists side by side, columns ascending; a column past V
    // offers -inf, which enters no list
#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          top[ii].push_ascending(8 * n + j < lim ? as_f(acc[4 * n + 2 * ii + j]) : -INFINITY,
                                 cb + 8 * n + j);
  }

  if constexpr (Score::kWrite) return;

  // the row's 4 lanes share its running max: their sum-exp is summed and
  // their lists merged by shuffles, and one lane writes
  const int wgp = RG == 1 ? 2 : 1;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    float s = s_run[ii];
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      const TopK<K> mine = top[ii];
#pragma unroll
      for (int j = 0; j < K; ++j)
        top[ii].push(__shfl_xor_sync(FULL, mine.v[j], off),
                     __shfl_xor_sync(FULL, mine.i[j], off));
    }
    if (row[ii] < M && cq == 0) {
      const size_t p = static_cast<size_t>(blockIdx.y) * wgp + (RG == 1 ? wg : 0);
      const size_t slot = p * M + row[ii];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        part.vals[slot * K + j] = top[ii].v[j];
        part.idx[slot * K + j] = top[ii].i[j];
      }
      if constexpr (Score::kLse) {
        part.max[slot] = m_run[ii];
        part.sum[slot] = s;
      }
    }
  }
}

// MERGE_LANES threads per row merge its P partial lists and (max,
// sum-exp) pairs: thread q folds the parts q, q + MERGE_LANES, .. in order,
// then the row's threads combine by shuffles in a fixed tree (the sums of a
// pair are commutative, so every thread holds the same result), and the
// first k entries of the merged list go out.  Results repeat bit for bit.
template <int K, bool kLse>
__global__ void __launch_bounds__(MERGE_THREADS)
logits_topk_merge_kernel(const Parts part, float* __restrict__ vals,
                         int* __restrict__ idx, float* __restrict__ lse,
                         int M, int P, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = t / MERGE_LANES;
  const int q = t % MERGE_LANES;
  const bool live = row < M;      // a row past M reads nothing but shuffles
  float m = -INFINITY;
  float s = 0.0f;
  TopK<K> top;
  top.init();
  if (live) {
    if (kLse)
      for (int p = q; p < P; p += MERGE_LANES)
        m = fmaxf(m, part.max[static_cast<size_t>(p) * M + row]);
    for (int p = q; p < P; p += MERGE_LANES) {
      const size_t slot = static_cast<size_t>(p) * M + row;
      if (kLse) {
        const float mp = part.max[slot];
        if (mp > -INFINITY) s += part.sum[slot] * expf(mp - m);
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        top.push(part.vals[slot * K + j], part.idx[slot * K + j]);
    }
  }
#pragma unroll
  for (int off = 1; off < MERGE_LANES; off *= 2) {
    if (kLse) {
      const float om = __shfl_xor_sync(FULL, m, off);
      const float os = __shfl_xor_sync(FULL, s, off);
      const float nm = fmaxf(m, om);
      s = (m > -INFINITY ? s * expf(m - nm) : 0.0f) +
          (om > -INFINITY ? os * expf(om - nm) : 0.0f);
      m = nm;
    }
    const TopK<K> mine = top;
#pragma unroll
    for (int j = 0; j < K; ++j)
      top.push(__shfl_xor_sync(FULL, mine.v[j], off), __shfl_xor_sync(FULL, mine.i[j], off));
  }
  if (!live || q != 0) return;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < k) {
      vals[static_cast<size_t>(row) * k + j] = top.v[j];
      idx[static_cast<size_t>(row) * k + j] = top.i[j];
    }
  if (kLse) lse[row] = m + logf(s);
}

struct Launch {
  CUtensorMap h_map, w_map;
  Parts part;
  void* vals;
  void* idx;
  void* lse;
  int M, V, boxes, rows, resident, chunk_tiles, chunks, k;
  cudaStream_t st;
};

template <class Logit, int RG, bool RES, int BOXES, class Score, int K>
int launch(const Launch& a, const Logit& logit, const Score& score) {
  const RingLayout L = ring_layout(a.boxes, RG, RES, 0);
  if (L.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  // dynamic shared memory above 48 KB for this instance, once per device
  static uint32_t smem_set = 0;   // a bit per device
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 32 || !(smem_set >> dev & 1u)) {
    err = allow_smem(logits_topk_kernel<Logit, RG, RES, BOXES, Score, K>, SMEM_MAX);
    if (err) return err;
    if (dev < 32) smem_set |= 1u << dev;
  }
  const dim3 grid((a.M + RG * BT - 1) / (RG * BT), a.chunks);
  logits_topk_kernel<Logit, RG, RES, BOXES, Score, K><<<grid, THREADS, L.smem, a.st>>>(
      a.h_map, a.w_map, logit, score, a.part, a.M, a.V, a.boxes, a.chunk_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err || Score::kWrite) return err;
  const int P = a.chunks * (RG == 1 ? 2 : 1);
  logits_topk_merge_kernel<K, Score::kLse>
      <<<(a.M * MERGE_LANES + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0, a.st>>>(
          a.part, static_cast<float*>(a.vals), static_cast<int*>(a.idx),
          static_cast<float*>(a.lse), a.M, P, a.k);
  return static_cast<int>(cudaGetLastError());
}

// the block shape: 128 rows resident (top-k lists of up to 10, and the
// logits writer), 64 rows resident, or 64 rows streamed (128-row sampler
// blocks spilled: its Philox words beside 64 accumulators); the decode's
// own blocks (128 rows of top-k and of the writer, 64 of the sampler) at
// the decode's width with the box count at compile time
template <class Logit, class Score, int K>
int launch_rows(const Launch& a, const Logit& logit, const Score& score) {
  constexpr int B = Logit::BOXES;
  if (a.rows == 128 && a.resident) {
    if constexpr (K <= 10 && (Score::kLse || Score::kWrite))
      return a.boxes == B ? launch<Logit, 2, true, B, Score, K>(a, logit, score)
                          : launch<Logit, 2, true, 0, Score, K>(a, logit, score);
  } else if (a.rows == 64) {
    if (!a.resident) return launch<Logit, 1, false, 0, Score, K>(a, logit, score);
    if constexpr (!Score::kLse && !Score::kWrite) {
      if (a.boxes == B) return launch<Logit, 1, true, B, Score, K>(a, logit, score);
    }
    return launch<Logit, 1, true, 0, Score, K>(a, logit, score);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the list length: k rounded up to 1, 3, 10 or 16
template <class Logit>
int launch_top_k(const Launch& a, const Logit& logit) {
  const RawLogit raw{};
  if (a.k <= 1) return launch_rows<Logit, RawLogit, 1>(a, logit, raw);
  if (a.k <= 3) return launch_rows<Logit, RawLogit, 3>(a, logit, raw);
  if (a.k <= 10) return launch_rows<Logit, RawLogit, 10>(a, logit, raw);
  return launch_rows<Logit, RawLogit, 16>(a, logit, raw);
}

// The block shape at `boxes` boxes a row of h and lists of K (rows 0: the
// kernels' choice, else 128 or 64 forced) as rows · 2 + resident, or -1
// where forced rows do not fit: 128 rows resident where they fit beside a
// ring of four boxes and the lists hold at most 10 (lists of 16 do not
// fit the registers beside 64 accumulators); else 64 rows, resident where
// they fit beside four boxes, else streamed beside each W box.
int block_shape(int boxes, int K, int rows) {
  const bool wide = K <= 10 && ring_layout(boxes, 2, true, 0).stages >= 4;
  if (rows == 128 || (rows == 0 && wide)) return wide ? 2 * 128 + 1 : -1;
  if (rows != 0 && rows != 64) return -1;
  return 2 * 64 + (ring_layout(boxes, 1, true, 0).stages >= 4 ? 1 : 0);
}

// the plan's shape: rows 128 (resident) or 64, chunks that cover the
// vocabulary's tiles with none empty
bool bad_plan(int M, int V, int rows, int resident, int chunk_tiles, int chunks) {
  const int tiles = (V + TV - 1) / TV;
  return M <= 0 || V <= 0 || !(rows == 128 || rows == 64) || (rows == 128 && !resident) ||
         chunk_tiles <= 0 || chunks != (tiles + chunk_tiles - 1) / chunk_tiles;
}

Launch plan_args(void* part_vals, void* part_idx, void* part_max, void* part_sum,
                 void* vals, void* idx, void* lse, int M, int V, int boxes, int rows,
                 int resident, int chunk_tiles, int chunks, int k, void* stream) {
  Launch a{};
  a.part = Parts{static_cast<float*>(part_vals), static_cast<int*>(part_idx),
                 static_cast<float*>(part_max), static_cast<float*>(part_sum)};
  a.vals = vals;
  a.idx = idx;
  a.lse = lse;
  a.M = M;
  a.V = V;
  a.boxes = boxes;
  a.rows = rows;
  a.resident = resident;
  a.chunk_tiles = chunk_tiles;
  a.chunks = chunks;
  a.k = k;
  a.st = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Partial workspace sizes the caller allocates, with K the list length
// (k rounded up to 1, 3, 10 or 16) and P = chunks · (2 if rows == 64)
// partials per row: part_vals [P, M, K] f32, part_idx [P, M, K]
// int32, part_max and part_sum [P, M] f32.  chunks = ceil(ceil(V / 128) /
// chunk_tiles); H a multiple of 32; every pointer 16-byte aligned.
// Returns a cudaError_t as int.
extern "C" int vct_fused_logits_top_k(const void* h, const void* w_t,
                                      const void* b, void* part_vals,
                                      void* part_idx, void* part_max,
                                      void* part_sum, void* vals, void* idx,
                                      void* lse, int M, int H, int V, int k,
                                      int rows, int resident, int chunk_tiles,
                                      int chunks, void* stream) {
  if (M <= 0) return 0;
  if (H <= 0 || H % 32 != 0 || k < 1 || k > 16 || k > V ||
      bad_plan(M, V, rows, resident, chunk_tiles, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = plan_args(part_vals, part_idx, part_max, part_sum, vals, idx, lse, M, V,
                       (H * 2 + 127) / 128, rows, resident, chunk_tiles, chunks, k, stream);
  int err = row_tile_map(&a.h_map, static_cast<const bf16*>(h), M, H);
  if (err) return err;
  err = row_tile_map(&a.w_map, static_cast<const bf16*>(w_t), V, H, TV);
  if (err) return err;
  return launch_top_k(a, Bf16Logit{static_cast<const float*>(b)});
}

// The int8 variant: hq [M,H] int8, hs [M] f32, wq_t [V,H] int8 (the
// head transposed), ws and b [V] f32; H a multiple of 64.  Workspace and
// outputs as vct_fused_logits_top_k.
extern "C" int vct_fused_logits_top_k_int8(
    const void* hq, const void* hs, const void* wq_t, const void* ws,
    const void* b, void* part_vals, void* part_idx, void* part_max,
    void* part_sum, void* vals, void* idx, void* lse, int M, int H, int V,
    int k, int rows, int resident, int chunk_tiles, int chunks, void* stream) {
  if (M <= 0) return 0;
  if (H <= 0 || H % 64 != 0 || k < 1 || k > 16 || k > V ||
      bad_plan(M, V, rows, resident, chunk_tiles, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = plan_args(part_vals, part_idx, part_max, part_sum, vals, idx, lse, M, V,
                       (H + 127) / 128, rows, resident, chunk_tiles, chunks, k, stream);
  int err = s8_tile_map(&a.h_map, static_cast<const signed char*>(hq), M, H);
  if (err) return err;
  err = s8_tile_map(&a.w_map, static_cast<const signed char*>(wq_t), V, H, TV);
  if (err) return err;
  return launch_top_k(a, S8Logit{static_cast<const float*>(hs), static_cast<const float*>(ws),
                                 static_cast<const float*>(b)});
}

// The logits written for lists past 16: logits [M, V] f32 = h W + b, as
// the bf16 top-k's fold sees them; the block shape and chunks of lists of
// one (k = 1 in vct_fused_logits_top_k_block and chunk_plan).
extern "C" int vct_fused_logits_write(const void* h, const void* w_t, const void* b,
                                      void* logits, int M, int H, int V, int rows,
                                      int resident, int chunk_tiles, int chunks,
                                      void* stream) {
  if (M <= 0) return 0;
  if (H <= 0 || H % 32 != 0 || bad_plan(M, V, rows, resident, chunk_tiles, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = plan_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M, V,
                       (H * 2 + 127) / 128, rows, resident, chunk_tiles, chunks, 1, stream);
  int err = row_tile_map(&a.h_map, static_cast<const bf16*>(h), M, H);
  if (err) return err;
  err = row_tile_map(&a.w_map, static_cast<const bf16*>(w_t), V, H, TV);
  if (err) return err;
  return launch_rows<Bf16Logit, WriteLogits, 1>(a, Bf16Logit{static_cast<const float*>(b)},
                                                WriteLogits{static_cast<float*>(logits)});
}

// The int8 logits written: logits [M, V] f32 = (f32(hq wq) hs) ws + b, bit
// for bit; operands as vct_fused_logits_top_k_int8, plan as
// vct_fused_logits_write.
extern "C" int vct_fused_logits_write_int8(const void* hq, const void* hs, const void* wq_t,
                                           const void* ws, const void* b, void* logits,
                                           int M, int H, int V, int rows, int resident,
                                           int chunk_tiles, int chunks, void* stream) {
  if (M <= 0) return 0;
  if (H <= 0 || H % 64 != 0 || bad_plan(M, V, rows, resident, chunk_tiles, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = plan_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M, V,
                       (H + 127) / 128, rows, resident, chunk_tiles, chunks, 1, stream);
  int err = s8_tile_map(&a.h_map, static_cast<const signed char*>(hq), M, H);
  if (err) return err;
  err = s8_tile_map(&a.w_map, static_cast<const signed char*>(wq_t), V, H, TV);
  if (err) return err;
  return launch_rows<S8Logit, WriteLogits, 1>(
      a, S8Logit{static_cast<const float*>(hs), static_cast<const float*>(ws),
                 static_cast<const float*>(b)},
      WriteLogits{static_cast<float*>(logits)});
}

// One Gumbel-max draw per row: tokens [M] int32.  Workspace part_vals and
// part_idx [P, M] (lists of 1), vals [M] f32 (the winning scored values).
extern "C" int vct_fused_logits_sample(const void* h, const void* w_t,
                                       const void* b, void* part_vals,
                                       void* part_idx, void* vals,
                                       void* tokens, int M, int H, int V,
                                       unsigned seed, unsigned step,
                                       float inv_temp, int row0, int rows,
                                       int resident, int chunk_tiles,
                                       int chunks, void* stream) {
  if (M <= 0) return 0;
  if (H <= 0 || H % 32 != 0 || bad_plan(M, V, rows, resident, chunk_tiles, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = plan_args(part_vals, part_idx, nullptr, nullptr, vals, tokens, nullptr, M, V,
                       (H * 2 + 127) / 128, rows, resident, chunk_tiles, chunks, 1, stream);
  int err = row_tile_map(&a.h_map, static_cast<const bf16*>(h), M, H);
  if (err) return err;
  err = row_tile_map(&a.w_map, static_cast<const bf16*>(w_t), V, H, TV);
  if (err) return err;
  return launch_rows<Bf16Logit, GumbelScore, 1>(
      a, Bf16Logit{static_cast<const float*>(b)}, GumbelScore{seed, step, inv_temp, row0});
}

// The block shape of the top-k kernels (and, with k = 1 and rows = 64,
// the sampler's) at width H (int8: bytes per element 1) for lists of k:
// rows · 2 + resident; `rows` 0 lets the kernels choose, 128 or 64 forces
// it; -1 where forced rows do not fit.
extern "C" int vct_fused_logits_top_k_block(int H, int int8, int k, int rows) {
  if (H <= 0 || k < 1 || k > 16) return -1;
  const int K = k <= 1 ? 1 : k <= 3 ? 3 : k <= 10 ? 10 : 16;
  return block_shape((H * (int8 ? 1 : 2) + 127) / 128, K, rows);
}

// The kernels' dynamic shared memory at width H (int8: bytes per element
// 1), for a block of `rows` rows, h resident or streamed; -1 where the
// ring would hold fewer than two stages.
extern "C" int vct_fused_logits_top_k_smem(int H, int int8, int rows, int resident) {
  const RingLayout L =
      ring_layout((H * (int8 ? 1 : 2) + 127) / 128, rows == 128 ? 2 : 1, resident != 0, 0);
  return L.stages < 2 ? -1 : L.smem;
}
