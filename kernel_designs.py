"""Device time of design variants of seven kernels, built from edited copies
of their sources, in turns.

The top-k + logsumexp over written logits (``csrc/topk_lse.cu``) at beam
3 and beam 10 (N = 1536, k = 3; 5120, 10), on ``chip_smoke.py``'s
unfused-decode logits, the fused z eps stream (``csrc/fused_z.cu``,
normals and raw words) at the train shapes (1280 x 100 x 150), and the
CE forward (``csrc/fused_ce.cuh``, the flash forward built through
``fused_ce.cu`` and the written-logits one through ``fused_ce_mat.cu``)
at the wide cell's H = 1024 (M = 30,720, V = 11,500): clusters of 2
64-row blocks along M sharing each W box by TMA multicast (as built),
the 64-row blocks alone, clusters of 4, the two warpgroups of a block on
column halves of every tile (the flash forward; as built it takes alternate
tiles), the box count at run time, the fold
left out (the product stream alone; not exact) in clusters and alone,
each release a cluster-scope fence, and the fold without its exps or its
biases (not exact), each checked against the plain version (lse and ll within
chip_smoke.py's tolerance) and against the built kernel (bit for bit,
the written logits too).  Each variant is one or more text edits of the
source (or of a header it includes) as it stands; an edit that no longer
applies fails the run.  Variants are built side by side
(one nvcc each, all started together) into ``_build/designs/`` and
loaded with ctypes; each is timed by device time (``torch.profiler``)
in the order listed, then in reverse, and checked against the plain
version (``exact``: values and indices, or words and normals, bit for
bit).  Variants that drop work on purpose are marked as not exact.

The flash CE backward (``csrc/fused_ce.cu``) at the wide cell's H =
1024: its clusters of two column halves as built, clusters of 2 Q tiles
x 2 column halves sharing each K part by TMA multicast, the column
tiles of ``ce_bwd_wide_kernel``, a cluster barrier every tile, and the exchange left out (not
exact), each checked against the plain version (within chip_smoke.py's
tolerances) and against the built kernel (bit for bit).

The decode's logits writer for beams past 16 (``csrc/fused_logits_topk.cu``,
``logits_write_kernel``) at the wide beams' rows, H = 512, V = 11,500:
bf16 at M = 10,240 and 20,480 (beam 20 and 40 of 512 images), int8 at
10,240.  Variants: as built (the grid's vocab chunks first, two 8 KB box
slots a warpgroup, a TMA store and a group a box), the row blocks first
(the first staged design), W loads evict-last, three and four box slots, a
64-column piece a group, 64-row blocks, clusters of 2 sharing each W box
by multicast, a chunk's tiles strided, evict-first stores, the exit
waiting for the stores' completion, plain float4 stores from each warp's
staged rows in place of TMA (streaming or not; or in one warpgroup of
the two), the first writer's design (direct stores from the registers); and, not
exact, the products alone, the stores alone (TMA or plain, no ring) and
every store into the same 64 rows (L2 only).  Each exact variant is
checked bit for bit against the built kernel at every
``chip_smoke.WRITE_SHAPES`` entry and at the wide shapes, and the built
kernel against the plain version (int8 bit for bit ``int8_logits``; bf16
within the f32 sum-order bound); the same buffer written by ``fill_`` is
timed beside them as a write stream's yardstick.

Row 5 past k = 32 (``csrc/topk_lse.cu``, ``topk_select_kernel``) at the
wide beams' rows (``WIDE_SELECT_SHAPES``): beam 40 of 512 images on the
writer's pitched rows, beam 64 of 512, (300, 11519, 65 / 256) and beam
100 of 128 images, on the unfused decode's logits.  Variants: as built
(the threads' maxima bound the k-th value, the candidates binned), the
parent's designs (warp lists of two entries a lane to 64, past 64 a
1024-thread bitonic sort of the row: the source's own text, put back by
the edits), the parent's warp lists bounded by each lane's two largest
values, the candidates placed by count without bins, the radix select on
every row (no bound) with an 11- or 8-bit first digit, warp-aggregated
counting or two sub-histograms, 256 threads a block, two rows staged a
block (two blocks an SM), one row and two blocks an SM, no staging, and,
not exact, the stream and logsumexp alone.  Each
exact variant's values and indices are checked bit for bit against the
built kernel's (its lse bit for bit, or to the largest relative
difference where its sum runs in another order), and the built kernel
against the plain version.

The written logits' dW/db (``csrc/fused_ce_mat.cu``, row 18 of the CE) at
the wide cell's H = 1024, M = 30,720, V = 11,500 on the train batch's
labels: the 64 x 512 blocks with dW and db in place at one split (as
built), with the split partial summed (the design before), with a vocab
tile's two column tiles side by side in the grid, with no product, no dl
step or neither (not exact), and blocks of 128 vocab rows and 256 columns
(the dl step on both of their lg boxes) whole, with no product, no dl
step or neither.  Each exact variant is checked bit for bit (sign bits
too) against the built kernel and every variant against the plain
version (dW and db within chip_smoke.py's tolerances).

    python3 kernel_designs.py            # from the repository's root, on a CUDA card
    python3 kernel_designs.py ce_fwd       # the named groups only (topk, eps, ce_fwd,
                                           # ce_bwd_wide, writer, topk_wide, ce_mat_bwd)
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from vae_captioning_torch import _ext

# (label, edits) on csrc/topk_lse.cu
TOPK_VARIANTS = (
    ("as built", ()),
    ("chunks of 4 float4 a lane", (("constexpr int U = 8;", "constexpr int U = 4;"),)),
    ("chunks of 4 float4, three blocks an SM",
     (("constexpr int U = 8;", "constexpr int U = 4;"),
      ("constexpr int BLOCKS_PER_SM = 2;", "constexpr int BLOCKS_PER_SM = 3;"))),
    ("the stream and logsumexp alone (no top-k; not exact)",
     (("    if (!__any_sync(FULL, mc > tv && mc >= low)) return;", "    return;"),)),
)
# the parent's lists past 32 (csrc/topk_lse.cu as it stood before the radix
# select): warp lists of two entries a lane to k = 64, and past 64 one
# 1024-thread block a row bitonic-sorting the row's keys in shared memory
_PARENT_SORT = r"""// ---------------------------------------------------------------------
// lists past 64: a bitonic sort of the row
// ---------------------------------------------------------------------

constexpr int SORT_THREADS = 1024;
constexpr int SORT_SMEM_COLS = 16384;   // 128 KB of keys in shared memory

// ascending keys in (value descending, index ascending) order: the value's
// bits made monotone and inverted above the index; -0 keys as +0 (a tie,
// as in the sort) and every NaN as the largest value (torch.sort's order)
__device__ __forceinline__ unsigned long long sort_key(float v, int i) {
  unsigned u = v != v ? 0x7fffffffu : __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(~u) << 32) | static_cast<unsigned>(i);
}

// the block's reduction of v by op, in every thread, in a fixed order
template <class Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(FULL, v, d));
  __syncthreads();    // red is free (an earlier reduction has been read)
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < SORT_THREADS / 32; ++w) v = op(v, red[w]);
  return v;
}

// rows r, r + gridDim.x, ..; keys in shared memory, or in work [gridDim.x,
// n_pad] where given; n_pad the power of two at or above V
__global__ void __launch_bounds__(SORT_THREADS)
topk_sort_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
                 float* __restrict__ lse, unsigned long long* __restrict__ work, int N, int V,
                 int pitch, int k, int n_pad) {
  extern __shared__ unsigned long long skey[];
  __shared__ float red[SORT_THREADS / 32];
  unsigned long long* key = work ? work + static_cast<size_t>(blockIdx.x) * n_pad : skey;
  const int tid = threadIdx.x;
  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const float* xr = x + static_cast<size_t>(row) * pitch;
    float m = -INFINITY;
    for (int c = tid; c < n_pad; c += SORT_THREADS) {
      const float v = c < V ? xr[c] : -INFINITY;
      key[c] = c < V ? sort_key(v, c) : ~0ull;
      m = fmaxf(m, v);
    }
    m = block_reduce(m, red, [](float a, float b) { return fmaxf(a, b); });
    float s = 0.0f;
    if (m > -INFINITY)
      for (int c = tid; c < V; c += SORT_THREADS) s += expf(xr[c] - m);
    s = block_reduce(s, red, [](float a, float b) { return a + b; });
    for (int size = 2; size <= n_pad; size <<= 1)
      for (int stride = size / 2; stride > 0; stride /= 2) {
        for (int t = tid; t < n_pad / 2; t += SORT_THREADS) {
          const int lo = 2 * t - (t & (stride - 1));   // bit `stride` clear
          const unsigned long long a = key[lo], b = key[lo + stride];
          if ((a > b) == ((lo & size) == 0)) {
            key[lo] = b;
            key[lo + stride] = a;
          }
        }
        __syncthreads();
      }
    for (int j = tid; j < k; j += SORT_THREADS) {
      const int c = static_cast<int>(key[j] & 0xffffffffu);
      vals[static_cast<size_t>(row) * k + j] = xr[c];
      idx[static_cast<size_t>(row) * k + j] = c;
    }
    if (tid == 0) lse[row] = m + logf(s);
    __syncthreads();    // the keys are read before the next row's land
  }
}

int sort_pad(int V) {
  int n = 2;
  while (n < V) n *= 2;
  return n;
}


"""
_SELECT_LAUNCH = """  const int grid = sel_grid(N, V, sms);
  if (grid < 0) return -grid;
"""
_WARP_LISTS = """  if (k <= 64) {
    topk_lse_kernel<0, 2><<<min((N + WARPS - 1) / WARPS, sms * BLOCKS_PER_SM), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx),
        static_cast<float*>(lse), N, V, pitch, k);
    return static_cast<int>(cudaGetLastError());
  }
"""
_SORT_LAUNCH = """  {
    const int n_pad = sort_pad(V), bytes = 8 * n_pad;
    if (bytes > 48 * 1024) {
      const int err = static_cast<int>(cudaFuncSetAttribute(
          topk_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
      if (err) return err;
    }
    topk_sort_kernel<<<min(N, sms), SORT_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx),
        static_cast<float*>(lse), nullptr, N, V, pitch, k, n_pad);
    return static_cast<int>(cudaGetLastError());
  }
"""
_BEFORE_SEL = "bool sel_staged(int V) { return V <= SEL_STAGE_COLS; }"
_LANES_BOUND = ("    const float low = tv == -INFINITY && len() <= 32 ? kth_of_lanes(mc, lane) : -INFINITY;",
                "    const float low = tv != -INFINITY ? -INFINITY\n"
                "                      : len() <= 32 ? kth_of_lanes(mc, lane) : kth_of_pairs(v, mc, lane);")
_PAIRS = ("  // the k-th largest of the lanes' m (k <= 32), in every lane (a bitonic",
          r"""  // the k-th largest (k <= 64) of the lanes' two largest values of a chunk,
  // in every lane (a bitonic sort, descending, of 64 values, element 2 lane + i
  // in p[i])
  template <int NV>
  __device__ __forceinline__ float kth_of_pairs(const float (&v)[NV], float mc, int lane) const {
    float p[2] = {mc, -INFINITY};
    bool seen = false;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (v[j] == mc && !seen) seen = true;
      else p[1] = fmaxf(p[1], v[j]);
    }
#pragma unroll
    for (int size = 2; size <= 64; size <<= 1)
#pragma unroll
      for (int d = size / 2; d > 0; d >>= 1) {
        if (d == 1) {
          const bool desc = ((2 * lane) & size) == 0;
          const float hi = fmaxf(p[0], p[1]), lo = fminf(p[0], p[1]);
          p[0] = desc ? hi : lo;
          p[1] = desc ? lo : hi;
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * lane + i;
            const float o = __shfl_xor_sync(FULL, p[i], d / 2);
            p[i] = ((e & size) == 0) == ((e & d) == 0) ? fmaxf(p[i], o) : fminf(p[i], o);
          }
        }
      }
    const int kk = len() - 1;
    return __shfl_sync(FULL, (kk & 1) ? p[1] : p[0], kk / 2);
  }

  // the k-th largest of the lanes' m (k <= 32), in every lane (a bitonic""")
_NO_BOUND = ("    const bool bounded = k <= 8 * SEL_WARPS;", "    const bool bounded = false;")
_PLACE = """    const bool binned = bounded && C <= SEL_CAND;
    if (binned)
      bin_place(sh, C, k, lo, m, row, vr, ir);
    else
      radix_select(sh, row, h, nv, V, k, win, hc, vr, ir);
"""
# the select's histogram counts: a warp's lanes with equal bins by one
# atomic, or two histograms (warps alternate), summed where read
_MATCH_COUNT = """  const unsigned peers = __match_any_sync(FULL, ok ? bin : ~0u);
  if (ok && static_cast<int>(threadIdx.x % 32) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));"""
_TWO_HISTS = (("  uint32_t hist[SEL_BINS];\n", "  uint32_t hist[SEL_BINS], hist2[SEL_BINS];\n"),
              ("own += sh.hist[b];", "own += sh.hist[b] + sh.hist2[b];"),
              ("      const int c = sh.hist[b];", "      const int c = sh.hist[b] + sh.hist2[b];"),
              ("i += SEL_THREADS) sh.hist[i] = 0;", "i += SEL_THREADS) sh.hist[i] = sh.hist2[i] = 0;"),
              ("  uint32_t* hc = sh.hist;\n", "  uint32_t* hc = warp % 2 ? sh.hist2 : sh.hist;\n"))
# (label, edits) on csrc/topk_lse.cu: the lists past 32
TOPK_WIDE_VARIANTS = (
    ("as built: the threads' maxima bound the k-th value, the candidates binned", ()),
    ("the parent's designs: warp lists of two entries a lane to 64, past 64 a "
     "1024-thread bitonic sort of the row",
     ((_BEFORE_SEL, _PARENT_SORT + _BEFORE_SEL),
      (_SELECT_LAUNCH, _WARP_LISTS + _SORT_LAUNCH + _SELECT_LAUNCH))),
    ("the parent's warp lists to 64 bounded by the lanes' two largest values; past 64 "
     "as built", (_LANES_BOUND, _PAIRS, (_SELECT_LAUNCH, _WARP_LISTS + _SELECT_LAUNCH))),
    ("the candidates placed by count, no bins (C^2 / 512 compares a thread)",
     ((_PLACE, "    const bool binned = false;\n    if (bounded && C <= SEL_RANK)\n"
                "      place(sh.cand[0], C, k, row, vr, ir);\n    else\n"
                "      radix_select(sh, row, h, nv, V, k, win, hc, vr, ir);\n"),)),
    ("no bound: the radix select on every row (11-bit first digit, shared atomics)",
     (_NO_BOUND,)),
    ("no bound, an 8-bit first digit", (_NO_BOUND, ("constexpr int SEL_DIGIT = 11;",
                                                    "constexpr int SEL_DIGIT = 8;"))),
    ("no bound, a warp's equal bins counted by one atomic (__match_any_sync)",
     (_NO_BOUND, ("  if (ok) atomicAdd(&hist[bin], 1u);", _MATCH_COUNT))),
    ("no bound, two sub-histograms (warps alternate)", (_NO_BOUND, *_TWO_HISTS)),
    ("256 threads a block (three an SM)",
     (("constexpr int SEL_THREADS = 512;", "constexpr int SEL_THREADS = 256;"),)),
    ("two rows staged a block, the next row's copy in flight, two blocks an SM (64 registers)",
     (("constexpr int SEL_STAGES = 1;", "constexpr int SEL_STAGES = 2;"),
      ("constexpr int SEL_MIN_BLOCKS = 3;", "constexpr int SEL_MIN_BLOCKS = 2;"))),
    ("one row staged a block, two blocks an SM",
     (("constexpr int SEL_MIN_BLOCKS = 3;", "constexpr int SEL_MIN_BLOCKS = 2;"),)),
    ("no staging: every pass reads x", ((_BEFORE_SEL, "bool sel_staged(int V) { return false; }"),)),
    ("the stream and logsumexp alone (no bound, no select; not exact)",
     (_NO_BOUND, (_PLACE, "    const bool binned = false;\n"))),
)
# (label, edits) on csrc/fused_z.cu
EPS_VARIANTS = (
    ("as built", ()),
    ("no tail formula (draw4's central path only; not exact)",
     (("  if (__any_sync(__activemask(), tail)) {", "  if (false) {"),)),
    ("spans of 64 rows", (("constexpr int EPS_SPAN = 4800;", "constexpr int EPS_SPAN = 9600;"),)),
)
# the CE forward's shape rule past 512 with the launches of the resident
# 64-row blocks alone, and its fold of a tile (and, with the
# written logits, the tile's store), as csrc/fused_ce.cuh states them; the
# cluster ring's release of a stage (csrc/row_ring.cuh)
_FWD_ALONE = (("  return !fixed_width(H) && fwd_block(H, write_lg) % 2 != 0 ? FWD_CLUSTER : 0;",
               "  return 0;"),
              ("  return VCT_FWD(0, 1, false, 1);\n",
               "  if (H == 1024) return VCT_FWD(16, 1, true, 1);\n"
               "  return fwd_block(H, WRITE_LG) % 2 ? VCT_FWD(0, 1, true, 1) : VCT_FWD(0, 1, false, 1);\n"))
_NO_FOLD = ("    if (RG == 1 && v0 >= V) continue;", "    continue;")
_FENCED_RELEASE = ("row_ring.cuh", "mbar_arrive_cluster(empty_at[r] + off)",
                   "mbar_arrive_remote(empty_at[r] + off)")
# The flash forward's clusters on the column split of a tile: both warpgroups
# of a 64-row block on every tile, each 64 of its columns (m64n64), as the
# written-logits forward runs (which builds as it is)
_HALVES_LABEL = "clusters of 2, warpgroups on column halves of every tile (flash only)"
_HALVES = (("  static constexpr bool ALTERNATE = RG == 1 && CLUSTER > 1 && !WRITE_LG;",
            "  static constexpr bool ALTERNATE = false;"),)
# (label, edits) on csrc/fused_ce.cuh (or the header an edit names), built
# through csrc/fused_ce.cu and csrc/fused_ce_mat.cu
CE_FWD_VARIANTS = (
    ("as built: clusters of 2 along M, W boxes multicast (flash: warpgroups on "
     "alternate tiles)", ()),
    ("64-row blocks alone, no cluster", _FWD_ALONE),
    ("clusters of 4 along M", (("constexpr int FWD_CLUSTER = 2;", "constexpr int FWD_CLUSTER = 4;"),
                               ("row_ring.cuh", "(RES && CLUSTER == 2)", "(RES && CLUSTER == 4)"))),
    ("clusters of 2, the box count at run time",
     (("    return H == 1024 ? VCT_FWD(16, 1, true, FWD_CLUSTER) : VCT_FWD(0, 1, true, FWD_CLUSTER);",
       "    return VCT_FWD(0, 1, true, FWD_CLUSTER);"),)),
    (_HALVES_LABEL, _HALVES),
    ("clusters of 2, no fold: the product stream alone (not exact)", (_NO_FOLD,)),
    ("blocks alone, no fold: the product stream alone (not exact)", (_NO_FOLD, *_FWD_ALONE)),
    ("clusters of 2, each release at cluster scope (mbarrier.arrive.release.cluster)",
     (_FENCED_RELEASE,)),
    ("clusters of 2, the fold's exps left out (not exact)",
     (("        se += ex2(fmaf(acc[4 * n + 2 * ii], LOG2E, -ms)) +\n"
       "              ex2(fmaf(acc[4 * n + 2 * ii + 1], LOG2E, -ms));",
       "        se += fmaf(acc[4 * n + 2 * ii], LOG2E, -ms) +\n"
       "              fmaf(acc[4 * n + 2 * ii + 1], LOG2E, -ms);"),)),
    ("clusters of 2, the biases not loaded (not exact)",
     (("        bias[2 * n + j] = col < V ? __ldg(&b[col]) : NEG;",
       "        bias[2 * n + j] = col < V ? 0.0f : NEG;"),)),
)
# the flash CE backward's exchange of partial logits (ce_bwd_cluster_kernel)
_EXCHANGE = """    if (i > 0) mbar_wait<true>(xch_free, (i - 1) & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st_async(peer_xch + (c * BWD_THREADS + tid) * 16,
               make_float4(sacc[4 * c], sacc[4 * c + 1], sacc[4 * c + 2], sacc[4 * c + 3]),
               peer_full);
    mbar_wait<true>(xch_full, i & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(xch)[c * BWD_THREADS + tid];
      sacc[4 * c] += v.x;
      sacc[4 * c + 1] += v.y;
      sacc[4 * c + 2] += v.z;
      sacc[4 * c + 3] += v.w;
    }
"""
_RELEASE = """    if (tid == 0 && i + 1 < n_tiles) {
      mbar_expect_tx(xch_full, P::XCH);
      mbar_arrive_remote(peer_free);
    }
"""
# Clusters of 2 Q tiles x 2 column halves (rank x + 2z): the two CTAs of a
# column half share each K part, each warpgroup leader loading a quarter of
# it into both by TMA multicast (hopper.cuh's tma_load_multicast), and
# refill a stage only once the other Q tile's warpgroup has released it
# too; the grid's Q tiles rounded up to 2
_MULTICAST = (
    ("(STAGES + 3) * sizeof(uint64_t);", "(STAGES + 3 + 2 * STAGES) * sizeof(uint64_t);"),
    ("  uint64_t* xch_free = xch_full + 1;  // the peer has read this CTA's last partial\n",
     "  uint64_t* xch_free = xch_full + 1;  // the peer has read this CTA's last partial\n"
     "  uint64_t* partner_free = xch_free + 1;\n"),
    ("  const int e0 = rank * CLUSTER_CT;", "  const int e0 = (rank / 2) * CLUSTER_CT;"),
    ("  const uint32_t peer = rank ^ 1;\n",
     "  const uint32_t peer = rank ^ 2;\n"
     "  const uint32_t partner_free_at = cluster_map(smem_addr(partner_free), rank ^ 1);\n"),
    ("""    if (wg == 0) load_boxes<0, P::BOXES / 2>(dst, &k_map, &full[s], row, e0);
    else load_boxes<P::BOXES / 2, P::BOXES>(dst, &k_map, &full[s], row, e0);
""", """    const int c0 = (P::BOXES / 2) * wg + 2 * (rank & 1);
    const uint16_t pair = static_cast<uint16_t>(3u << (rank & ~1u));
    mbar_expect_tx(&full[s], (P::BOXES / 2) * BOX_BYTES);
    tma_load_multicast(dst + c0 * BOX_BYTES, &k_map, &full[s], e0 + c0 * BOX, row, pair);
    tma_load_multicast(dst + (c0 + 1) * BOX_BYTES, &k_map, &full[s], e0 + (c0 + 1) * BOX,
                       row, pair);
"""),
    ("    mbar_init(xch_free, 1);\n",
     "    mbar_init(xch_free, 1);\n"
     "    for (int k = 0; k < 2 * P::STAGES; ++k) mbar_init(&partner_free[k], 1);\n"),
    ("      if (leader && i - 1 + P::STAGES < n_tiles) load_tile(i - 1 + P::STAGES);\n",
     """      if (leader && i - 1 + P::STAGES < n_tiles) {
        const int k = ((i - 1) % P::STAGES) * 2 + wg;
        mbar_arrive_remote(partner_free_at + k * sizeof(uint64_t));
        mbar_wait<true>(&partner_free[k], ((i - 1) / P::STAGES) & 1);
        load_tile(i - 1 + P::STAGES);
      }
"""),
    ("  // the [64, 512] f32 block of dh, or of this split's dW partial\n",
     "  if (blockIdx.x >= q_tiles) return;\n"
     "  // the [64, 512] f32 block of dh, or of this split's dW partial\n"),
    ("  attr[0].val.clusterDim.x = 1;", "  attr[0].val.clusterDim.x = 2;"),
    ("  cfg.gridDim = dim3(q_tiles, splits, CLUSTER);",
     "  cfg.gridDim = dim3((q_tiles + 1) / 2 * 2, splits, CLUSTER);"),
)
# (label, edits) on csrc/fused_ce.cu: the flash CE's dh and dW/db at H = 1024
CE_BWD_WIDE_VARIANTS = (
    ("as built: clusters of 2 column halves", ()),
    ("clusters of 2 Q tiles x 2 column halves, K parts multicast", _MULTICAST),
    ("column tiles, ce_bwd_wide_kernel",
     (("constexpr bool cluster_width(int H) { return H == CLUSTER_H; }",
       "constexpr bool cluster_width(int H) { return false; }"),)),
    ("a cluster barrier every tile after the exchange",
     ((_EXCHANGE, _EXCHANGE + "    cluster_arrive();\n    cluster_wait();\n"),)),
    ("no exchange: each CTA its own half of the logits (not exact)",
     ((_EXCHANGE, ""), (_RELEASE, ""))),
)
# the written logits' dW/db (csrc/fused_ce_mat.cu, ce_mat_bwd_kernel<CT,
# true>): a vocab tile's two column tiles side by side in the grid, (column
# tiles, splits, vocab tiles), so that lg's second read finds L2
_ADJACENT = (
    ("  const int e0 = e_base + blockIdx.z * CT;",
     "  const int e0 = e_base + (DW ? blockIdx.x : blockIdx.z) * CT;"),
    ("  const int x0 = blockIdx.x * BT;", "  const int x0 = (DW ? blockIdx.z : blockIdx.x) * BT;"),
    ("  const int Xp = gridDim.x * BT;", "  const int Xp = (DW ? gridDim.z : gridDim.x) * BT;"),
    ("if (db_part == nullptr || blockIdx.z != 0) return;",
     "if (db_part == nullptr || blockIdx.x != 0) return;"),
    ("<<<dim3(out_tiles, splits, tiles), MAT_THREADS",
     "<<<DW ? dim3(tiles, splits, out_tiles) : dim3(out_tiles, splits, tiles), MAT_THREADS"),
)
# the product left out (mat_ring.cuh's k16 steps), or the dl step
_NO_PRODUCT = ("mat_ring.cuh",
               "#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) {\n      const uint64_t b_desc",
               "#pragma unroll\n    for (int kk = 0; kk < 0; ++kk) {\n      const uint64_t b_desc")
_NO_DL = ("    for (int j = 0; j < 2; ++j) {\n      uint4* slot",
          "    for (int j = 0; j < 0; ++j) {\n      uint4* slot")
# Blocks of 128 vocab rows and 256 columns from H = 512 on: mat_ring.cuh's
# ring with two lg boxes a stage (RB = 2), warpgroup g the 64 rows of box g
# against all 256 columns (m64n256), the later leader refilling the whole
# stage; every thread runs the dl step on both boxes (so each lg box's dl
# is formed once per 256-column tile, twice as often as by 64 x 512
# blocks); the 128 and 64 columns left past a multiple of 256 on 64-row
# blocks of the same rows; partials of V rounded up to 128 rows.
_R = "mat_ring.cuh"
_ROWS128 = (
    (_R, """template <int CT>
struct MatRing {
  static constexpr int BOXES = CT / BOX;              // boxes per K tile
  static constexpr int TILE = BT * CT * 2;            // bytes of a K tile
  static constexpr int STAGE = TILE + BOX_BYTES;      // + its A box
  static constexpr int STAGES = CT == 512 ? 3 : CT == 256 ? 5 : 8;
  static constexpr int HN = CT / 2;                   // output columns per warpgroup
  static constexpr int ACC = HN / 2;                  // their f32 registers per thread
  // at CT >= 128 a K tile is loaded by two threads, one box half each
  static constexpr bool SPLIT = BOXES >= 2;""", """template <int CT, int RB = 1>
struct MatRing {
  static constexpr int BOXES = CT / BOX;
  static constexpr int TILE = BT * CT * 2;
  static constexpr int STAGE = TILE + RB * BOX_BYTES;
  static constexpr int STAGES = RB > 1 ? 4 : CT == 512 ? 3 : CT == 256 ? 5 : 8;
  static constexpr int HN = RB > 1 ? CT : CT / 2;
  static constexpr int ACC = HN / 2;
  static constexpr bool SPLIT = RB == 1 && BOXES >= 2;"""),
    (_R, """template <int CT>
__device__ __forceinline__ unsigned char* mat_ring_extra(unsigned char* ring) {
  using P = MatRing<CT>;""", """template <int CT, int RB = 1>
__device__ __forceinline__ unsigned char* mat_ring_extra(unsigned char* ring) {
  using P = MatRing<CT, RB>;"""),
    (_R, "template <int NB>\n__device__", "template <int NB, int RB = 1>\n__device__"),
    (_R, """  mbar_expect_tx(bar, (NB + (a ? 1 : 0)) * BOX_BYTES);""",
     """  mbar_expect_tx(bar, (NB + (a ? RB : 0)) * BOX_BYTES);"""),
    (_R, """  if (a) tma_load(a_dst, a_map, bar, a_x, a_y);""", """  if (a) {
#pragma unroll
    for (int b = 0; b < RB; ++b) tma_load(a_dst + b * BOX_BYTES, a_map, bar, a_x + b * BOX, a_y);
  }"""),
    (_R, """template <int CT, bool DW, typename Step>
__device__ __forceinline__ void mat_ring_product(float (&acc)[MatRing<CT>::ACC],""",
     """template <int CT, bool DW, int RB = 1, typename Step>
__device__ __forceinline__ void mat_ring_product(float (&acc)[MatRing<CT, RB>::ACC],"""),
    (_R, """  using P = MatRing<CT>;
  uint64_t* full""", """  using P = MatRing<CT, RB>;
  uint64_t* full"""),
    (_R, """  constexpr int NB = P::SPLIT ? P::BOXES / 2 : 1;""",
     """  constexpr int NB = P::SPLIT ? P::BOXES / 2 : P::BOXES;"""),
    (_R, "    mat_ring_load<NB>(dst,", "    mat_ring_load<NB, RB>(dst,"),
    (_R, """  const uint32_t out_cols = (wg * P::HN / BOX) * BOX_BYTES + (wg * P::HN % BOX) * 2;""",
     """  const uint32_t out_cols =
      RB > 1 ? 0 : (wg * P::HN / BOX) * BOX_BYTES + (wg * P::HN % BOX) * 2;"""),
    (_R, """    const uint32_t a_addr = stage + P::TILE;""",
     """    const uint32_t a_addr = stage + P::TILE + (RB > 1 ? wg * BOX_BYTES : 0);"""),
    (_R, """template <int CT>
__device__ __forceinline__ void mat_ring_store(float (&acc)[MatRing<CT>::ACC], float* out,
                                               int ld, int row0, int col0) {
  using P = MatRing<CT>;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = (tid % 128) / 32 * 16 + lane / 4;
  const int col = col0 + tid / 128 * P::HN + 2 * (lane % 4);""", """template <int CT, int RB = 1>
__device__ __forceinline__ void mat_ring_store(float (&acc)[MatRing<CT, RB>::ACC], float* out,
                                               int ld, int row0, int col0) {
  using P = MatRing<CT, RB>;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r = (tid % 128) / 32 * 16 + lane / 4 + (RB > 1 ? tid / 128 * BT : 0);
  const int col = col0 + (RB > 1 ? 0 : tid / 128 * P::HN) + 2 * (lane % 4);"""),
    ("""template <int H>
__host__ __device__ constexpr size_t mat_bwd_smem() {
  return MatRing<H>::smem(MAT_WARPS * BT * sizeof(float));
}""", """__host__ __device__ constexpr int mat_row_blocks(int H) { return H >= 512 ? 2 : 1; }

template <int H, int RB = 1>
__host__ __device__ constexpr size_t mat_bwd_smem() {
  return MatRing<H, RB>::smem(MAT_WARPS * RB * BT * sizeof(float));
}"""),
    ("""template <int CT, bool DW>
__global__ void __launch_bounds__(MAT_THREADS, 1)""", """template <int CT, bool DW, int RB = 1>
__global__ void __launch_bounds__(MAT_THREADS, 1)"""),
    ("""  using P = MatRing<CT>;
  static_assert(mat_bwd_smem<CT>() <= 232448, "one block per SM: 227 KB of shared memory");""",
     """  using P = MatRing<CT, RB>;
  static_assert(mat_bwd_smem<CT, RB>() <= 232448, "one block per SM: 227 KB of shared memory");"""),
    ("mat_ring_extra<CT>(ring)", "mat_ring_extra<CT, RB>(ring)"),
    ("  const int x0 = blockIdx.x * BT;", "  const int x0 = blockIdx.x * RB * BT;"),
    ("  float db_run[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};",
     "  float db_run[RB][8] = {};"),
    ("""#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4* slot = reinterpret_cast<uint4*>(lg_box + run + j * 32 * 128);""", """#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint4* slot = reinterpret_cast<uint4*>(lg_box + b * BOX_BYTES + run + j * 32 * 128);"""),
    ("        d[e] = (p - (e == rel[j] ? 1.0f : 0.0f)) * t_gw[j];",
     "        d[e] = (p - (e == rel[j] - b * BT ? 1.0f : 0.0f)) * t_gw[j];"),
    ("        for (int e = 0; e < 8; ++e) db_run[e] += d[e];",
     "        for (int e = 0; e < 8; ++e) db_run[b][e] += d[e];"),
    ("""  mat_ring_product<CT, DW>(acc,""", """  mat_ring_product<CT, DW, RB>(acc,"""),
    ("""  const int Xp = gridDim.x * BT;
  mat_ring_store<CT>(""", """  const int Xp = gridDim.x * RB * BT;
  mat_ring_store<CT, RB>("""),
    ("""#pragma unroll
    for (int e = 0; e < 8; ++e) {
      db_run[e] += __shfl_xor_sync(0xffffffffu, db_run[e], 8);
      db_run[e] += __shfl_xor_sync(0xffffffffu, db_run[e], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) db_s[(tid / 32) * BT + 8 * lane + e] = db_run[e];
    }""", """#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      db_run[b][e] += __shfl_xor_sync(0xffffffffu, db_run[b][e], 8);
      db_run[b][e] += __shfl_xor_sync(0xffffffffu, db_run[b][e], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) db_s[(tid / 32) * RB * BT + b * BT + 8 * lane + e] = db_run[b][e];
    }"""),
    ("""    if (tid < BT) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < MAT_WARPS; ++w) sum += db_s[w * BT + tid];""", """    if (tid < RB * BT) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < MAT_WARPS; ++w) sum += db_s[w * RB * BT + tid];"""),
    ("""template <int CT, bool DW>
int launch_mat_ct(""", """template <int CT, bool DW, int RB = 1>
int launch_mat_ct("""),
    ("""  constexpr size_t smem = mat_bwd_smem<CT>();
  int err = allow_smem(ce_mat_bwd_kernel<CT, DW>, smem);
  if (err) return err;
  ce_mat_bwd_kernel<CT, DW><<<dim3(out_tiles, splits, tiles), MAT_THREADS, smem, st>>>(""",
     """  constexpr size_t smem = mat_bwd_smem<CT, RB>();
  int err = allow_smem(ce_mat_bwd_kernel<CT, DW, RB>, smem);
  if (err) return err;
  ce_mat_bwd_kernel<CT, DW, RB><<<dim3(out_tiles / RB, splits, tiles), MAT_THREADS, smem, st>>>("""),
    ("""  if constexpr (HH > 0) {
    return VCT_MAT(HH, 1, 0);""", """  if constexpr (DW && (HH == 0 || mat_row_blocks(HH) > 1)) {
    if (mat_row_blocks(H) > 1) {
      int e = H / 256 * 256;
      err = launch_mat_ct<256, true, 2>(k_map, lg_map, k_rows, labels, lse, gw, out, db_part,
                                        M, H, out_tiles, splits, per, H / 256, 0, st);
      if (!err && H - e >= 128) { err = VCT_MAT(128, 1, e); e += 128; }
      if (!err && H - e >= 64) err = VCT_MAT(64, 1, e);
      return err;
    }
  }
  if constexpr (HH > 0) {
    return VCT_MAT(HH, 1, 0);"""),
    ("""  const int v_tiles = (V + BT - 1) / BT;
  int err = launch_mat_bwd<HH, true>(h, M, lg, labels, lse, gw, dw_part, db_part,
                                     M, H, V, v_tiles, splits, per, st);
  if (err || dw == nullptr) return err;
  const int Vp = v_tiles * BT;""", """  const int rb = mat_row_blocks(H);
  const int v_tiles = ((V + BT - 1) / BT + rb - 1) / rb * rb;
  int err = launch_mat_bwd<HH, true>(h, M, lg, labels, lse, gw, dw_part, db_part,
                                     M, H, V, v_tiles, splits, per, st);
  if (err || dw == nullptr) return err;
  const int Vp = v_tiles * BT;"""),
)
_MAT_SUMMED = "the split partial summed at one split too (the design before)"
# (label, edits, the 64-row vocab tiles of a block, whether the split
# partials are summed at one split) on csrc/fused_ce_mat.cu (or the header
# an edit names)
CE_MAT_BWD_VARIANTS = (
    ("as built: 64 x 512 blocks, at one split dW and db in place", (), 1, False),
    (_MAT_SUMMED, (), 1, True),
    ("a vocab tile's two column tiles side by side in the grid", _ADJACENT, 1, False),
    ("no product: the streams and the dl step (not exact)", (_NO_PRODUCT,), 1, False),
    ("no dl step: lg taken as dl (not exact)", (_NO_DL,), 1, False),
    ("the streams alone: no product, no dl step (not exact)", (_NO_PRODUCT, _NO_DL), 1, False),
    ("128 vocab rows x 256 columns a block, the dl step on both lg boxes", _ROWS128, 2, False),
    ("128 x 256, no product (not exact)", _ROWS128 + (_NO_PRODUCT,), 2, False),
    ("128 x 256, no dl step (not exact)", _ROWS128 + (_NO_DL,), 2, False),
    ("128 x 256, the streams alone (not exact)", _ROWS128 + (_NO_PRODUCT, _NO_DL), 2, False),
)
# the writer's staged store of a tile, as csrc/fused_logits_topk.cu has it
_STAGED = r"""    // box q: columns 32q.. of the warpgroup's, n = 4q..4q + 3, into slot
    // `staged` % SLOTS, a group of its own: column 8n + cq of row rw in
    // 16-byte chunk (2·(n % 4) + cq / 4) ^ rw % 8, at byte 4·(cq % 4)
#pragma unroll
    for (int q = 0; q < BOXES_W; ++q, ++staged) {
      if (v0 + q * OUT_BOX >= V) break;
      unsigned char* buf = stage + (staged % SLOTS) * OUT_BOX_BYTES;
      if (staged >= SLOTS) {   // the slot's last store has read it
        if (leader) tma_store_wait_read<SLOTS - 1>();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int rw = r + 8 * ii;
#pragma unroll
        for (int n = 4 * q; n < 4 * q + 4; ++n)
          *reinterpret_cast<float2*>(buf + rw * 128 + (((2 * (n % 4) + cq / 4) ^ (rw & 7)) << 4) +
                                     (cq % 4) * 4) =
              make_float2(Logit::value(acc[4 * n + 2 * ii], rs[ii], col[2 * n]),
                          Logit::value(acc[4 * n + 2 * ii + 1], rs[ii], col[2 * n + 1]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      if (leader && row0 < M) {
        tma_store(&out_map, buf, v0 + q * OUT_BOX, row0);
        tma_store_commit();
      }
    }
"""
_SLOTS = "constexpr int WRITE_SLOTS = 2;            // boxes a warpgroup stages at once"
# the grid as logits_topk_kernel's: the row blocks first
_ROWS_FIRST = (("""  const int m0 = blockIdx.y * RG * BT;
  const int tiles = (V + TV - 1) / TV;
  const int t0 = blockIdx.x * chunk_tiles;""", """  const int m0 = blockIdx.x * RG * BT;
  const int tiles = (V + TV - 1) / TV;
  const int t0 = blockIdx.y * chunk_tiles;"""),
               ("  const dim3 grid(a.chunks, (a.M + RG * BT - 1) / (RG * BT));",
                "  const dim3 grid((a.M + RG * BT - 1) / (RG * BT), a.chunks);"))
# the head's boxes loaded with the L2 evict-last policy (row_ring.cuh's
# loads, through a hinted load added to hopper.cuh)
_LOAD_HINT = r"""__device__ __forceinline__ void tma_load_last(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int x, int y) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y), "l"(policy)
      : "memory");
}

"""
_B_LOAD = "      tma_load(st, b_map, &full[s], x, (t0 + j / boxes()) * RING_TV);"
_EVICT_LAST = (("hopper.cuh", "// one box of shared memory into a 2-D tensor (x: column, y: row), clipped",
                _LOAD_HINT + "// one box of shared memory into a 2-D tensor (x: column, y: row), clipped"),
               ("row_ring.cuh", _B_LOAD, _B_LOAD.replace("tma_load(", "tma_load_last(")))
# the first staged design: a 64-column piece (two boxes) a group, in one
# 16 KB slot a warpgroup, read before the next piece is staged
_PIECES = r"""    // piece p: columns 64p.. of the warpgroup's, n = 8p..8p + 7
#pragma unroll
    for (int p = 0; p < NW / 64; ++p, ++staged) {
      if (v0 + p * 64 >= V) break;
      unsigned char* buf = stage;
      if (staged > 0) {
        if (leader) tma_store_wait_read<0>();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int rw = r + 8 * ii;
#pragma unroll
        for (int n = 8 * p; n < 8 * p + 8; ++n)
          *reinterpret_cast<float2*>(buf + ((n / 4) % 2) * OUT_BOX_BYTES + rw * 128 +
                                     (((2 * (n % 4) + cq / 4) ^ (rw & 7)) << 4) + (cq % 4) * 4) =
              make_float2(Logit::value(acc[4 * n + 2 * ii], rs[ii], col[2 * n]),
                          Logit::value(acc[4 * n + 2 * ii + 1], rs[ii], col[2 * n + 1]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      if (leader && row0 < M) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
          if (v0 + p * 64 + x * OUT_BOX < V)
            tma_store(&out_map, buf + x * OUT_BOX_BYTES, v0 + p * 64 + x * OUT_BOX, row0);
        tma_store_commit();
      }
    }
"""
# each warp stages its 16 rows x 64 columns of the tile at a time in 4 KB
# of the warpgroup's slots (16-byte chunk c of row R at c ^ R % 8) and
# stores them from there with plain stores, a float4 a lane, two rows of
# 256 contiguous bytes a warp instruction (ST: the store)
_SIMT = r"""    {
      unsigned char* wbuf = stage + warp * 4096;
#pragma unroll
      for (int hf = 0; hf < NW / 64; ++hf) {
        __syncwarp();
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int rl = lane / 4 + 8 * ii;
#pragma unroll
          for (int n = 8 * hf; n < 8 * hf + 8; ++n)
            *reinterpret_cast<float2*>(wbuf + rl * 256 + (((2 * (n % 8) + cq / 4) ^ (rl & 7)) << 4) +
                                       (cq % 4) * 4) =
                make_float2(Logit::value(acc[4 * n + 2 * ii], rs[ii], col[2 * n]),
                            Logit::value(acc[4 * n + 2 * ii + 1], rs[ii], col[2 * n + 1]));
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int rl = 2 * k + lane / 16;
          const int c = lane % 16;
          const float4 v = *reinterpret_cast<const float4*>(wbuf + rl * 256 + ((c ^ (rl & 7)) << 4));
          const int row = row0 + warp * 16 + rl;
          const int cc = v0 + 64 * hf + 4 * c;
          if (row < M && cc < V) ST(reinterpret_cast<float4*>(out.ptr + static_cast<size_t>(row) * out.pitch + cc), v);
        }
      }
    }
"""
# warpgroup 0 stores its tiles by TMA, warpgroup 1 by plain streaming float4
# stores: two store paths of the SM at once
_MIXED = ("    if (wg == 0) {\n" + _STAGED + "    } else {\n" + _SIMT.replace("ST(", "__stcs(")
          + "    }\n")
# the logits' pointer and pitch as a kernel parameter, for the variants that
# store without TMA
_OUT = (("// Grid (vocab chunks, row blocks of 64·RG): logits_topk_kernel's blocks,",
         "struct Out {\n  float* ptr;\n  int pitch;\n};\n\n"
         "// Grid (vocab chunks, row blocks of 64·RG): logits_topk_kernel's blocks,"),
        ("""                    const __grid_constant__ CUtensorMap out_map, const Logit logit, int M,
                    int V, int boxes, int chunk_tiles) {""",
         """                    const __grid_constant__ CUtensorMap out_map, const Logit logit,
                    const Out out, int M, int V, int boxes, int chunk_tiles) {"""),
        ("      a.h_map, a.w_map, out_map, logit, a.M, a.V, a.boxes, a.chunk_tiles);",
         "      a.h_map, a.w_map, out_map, logit, Out{logits, pitch}, a.M, a.V, a.boxes,\n"
         "      a.chunk_tiles);"))
# clusters of 2 along M (y) at the decode's width, 128-row blocks sharing
# each W box by TMA multicast (row_ring.cuh's cluster mode, a producer warp
# beside the consumers; the W map's boxes of 64 rows, each CTA's part)
_CLUSTER = (
    ("""template <class Logit, int RG, bool RES, int BOXES>
__global__ void __launch_bounds__(THREADS, 1)
logits_write_kernel(""", """template <class Logit, int RG, bool RES, int BOXES, int CLUSTER = 1>
__global__ void __launch_bounds__(THREADS + (CLUSTER > 1 ? 32 : 0), 1)
logits_write_kernel("""),
    ("  using Ring = RowRing<typename Logit::Op, RG, RES, BOXES, write_extra(RG)>;",
     "  using Ring = RowRing<typename Logit::Op, RG, RES, BOXES, write_extra(RG), CLUSTER>;"),
    ("""  ring.start();

  // this thread's rows r + 8·ii of its warpgroup's 64 (from row0)""", """  ring.start();
  if constexpr (CLUSTER > 1) {
    if (tid >= THREADS) {
      if (tid == THREADS) ring.produce();
      __syncwarp();
      cluster_arrive();
      cluster_wait();
      return;
    }
  }

  // this thread's rows r + 8·ii of its warpgroup's 64 (from row0)"""),
    ("  if (leader) tma_store_wait_read<0>();\n}", """  if (leader) tma_store_wait_read<0>();
  if constexpr (CLUSTER > 1) {
    cluster_arrive();
    cluster_wait();
  }
}"""),
    ("""template <class Logit, int RG, bool RES, int BOXES>
int launch_write(const Launch& a, const Logit& logit, float* logits, int pitch) {
  const RingLayout L = ring_layout(a.boxes, RG, RES, write_extra(RG));""",
     """template <class Logit, int RG, bool RES, int BOXES, int CLUSTER = 1>
int launch_write(const Launch& a, const Logit& logit, float* logits, int pitch,
                 const CUtensorMap* part_map = nullptr) {
  const RingLayout L = ring_layout(a.boxes, RG, RES, write_extra(RG), CLUSTER);"""),
    ("""    err = allow_smem(logits_write_kernel<Logit, RG, RES, BOXES>, SMEM_MAX);""",
     """    err = allow_smem(logits_write_kernel<Logit, RG, RES, BOXES, CLUSTER>, SMEM_MAX);"""),
    ("""  const dim3 grid(a.chunks, (a.M + RG * BT - 1) / (RG * BT));
  logits_write_kernel<Logit, RG, RES, BOXES><<<grid, THREADS, L.smem, a.st>>>(
      a.h_map, a.w_map, out_map, logit, a.M, a.V, a.boxes, a.chunk_tiles);
  return static_cast<int>(cudaGetLastError());""",
     """  const dim3 grid(a.chunks, ((a.M + RG * BT - 1) / (RG * BT) + CLUSTER - 1) / CLUSTER * CLUSTER);
  if constexpr (CLUSTER > 1) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = CLUSTER;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS + 32);
    cfg.dynamicSmemBytes = L.smem;
    cfg.stream = a.st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = static_cast<int>(cudaLaunchKernelEx(
        &cfg, logits_write_kernel<Logit, RG, RES, BOXES, CLUSTER>, a.h_map, *part_map, out_map,
        logit, a.M, a.V, a.boxes, a.chunk_tiles));
    if (err) return err;
  } else {
    logits_write_kernel<Logit, RG, RES, BOXES><<<grid, THREADS, L.smem, a.st>>>(
        a.h_map, a.w_map, out_map, logit, a.M, a.V, a.boxes, a.chunk_tiles);
  }
  return static_cast<int>(cudaGetLastError());"""),
    ("""int launch_write_rows(const Launch& a, const Logit& logit, float* logits, int pitch) {
  constexpr int B = Logit::BOXES;
  if (a.rows == 128 && a.resident)""",
     """int launch_write_rows(const Launch& a, const Logit& logit, const void* w_t, int H,
                      float* logits, int pitch) {
  constexpr int B = Logit::BOXES;
  if (a.rows == 128 && a.resident && a.boxes == B) {
    CUtensorMap part_map;
    int err;
    if constexpr (Logit::Op::BOX_X == 128)
      err = s8_tile_map(&part_map, static_cast<const signed char*>(w_t), a.V, H, TV / 2);
    else
      err = row_tile_map(&part_map, static_cast<const bf16*>(w_t), a.V, H, TV / 2);
    if (err) return err;
    return launch_write<Logit, 2, true, B, 2>(a, logit, logits, pitch, &part_map);
  }
  if (a.rows == 128 && a.resident)"""),
    ("""  return launch_write_rows(a, Bf16Logit{static_cast<const float*>(b)},
                           static_cast<float*>(logits), pitch);""",
     """  return launch_write_rows(a, Bf16Logit{static_cast<const float*>(b)}, w_t, H,
                           static_cast<float*>(logits), pitch);"""),
    ("""                                      static_cast<const float*>(b)},
                           static_cast<float*>(logits), pitch);""",
     """                                      static_cast<const float*>(b)},
                           wq_t, H, static_cast<float*>(logits), pitch);"""))
# the first writer: each lane stores its accumulator pairs from the registers
# (8 bytes a pair, a warp instruction 8 rows of 32 bytes), between the
# products, with no staging slots (its ring's stages as that writer had them)
_DIRECT = """#pragma unroll
    for (int n = 0; n < NW / 8; ++n)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = row0 + r + 8 * ii;
        const int c = cb + 8 * n;
        if (row >= M || c >= V) continue;
        const float x0 = Logit::value(acc[4 * n + 2 * ii], rs[ii], col[2 * n]);
        const float x1 = Logit::value(acc[4 * n + 2 * ii + 1], rs[ii], col[2 * n + 1]);
        float* o = out.ptr + static_cast<size_t>(row) * out.pitch + c;
        if (c + 1 < V) *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
        else o[0] = x0;
      }
"""
# the stores with an L2 evict-first policy (a hinted store added beside Out)
_STORE = "        tma_store(&out_map, buf, v0 + q * OUT_BOX, row0);"
_EVICT_FIRST = (("// Grid (vocab chunks, row blocks of 64·RG): logits_topk_kernel's blocks,", r"""__device__ __forceinline__ void tma_store_first(const CUtensorMap* map, const void* src, int x,
                                                int y) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(x), "r"(y), "l"(policy)
      : "memory");
}

// Grid (vocab chunks, row blocks of 64·RG): logits_topk_kernel's blocks,"""),
                (_STORE, _STORE.replace("tma_store(", "tma_store_first(")))
# chunk c takes the tiles c, c + chunks, .. (the W boxes' rows in
# row_ring.cuh strided alike), so that the blocks resident at once write
# neighbouring tiles of the same rows
_STRIDED = (("""  const int t0 = blockIdx.x * chunk_tiles;
  const int n_tiles = max(0, min(tiles, t0 + chunk_tiles) - t0);""", """  const int t0 = blockIdx.x;
  const int n_tiles = (tiles - t0 + gridDim.x - 1) / gridDim.x;"""),
            ("""    const int v0 = (t0 + i) * TV + (RG == 1 ? wg * NW : 0);  // the warpgroup's first column
    const int cb = v0 + cq;                                   // this thread's
    // the tile's column parameters, requested before its products""",
             """    const int v0 = (t0 + i * gridDim.x) * TV + (RG == 1 ? wg * NW : 0);
    const int cb = v0 + cq;                                   // this thread's
    // the tile's column parameters, requested before its products"""),
            ("row_ring.cuh", _B_LOAD,
             _B_LOAD.replace("(t0 + j / boxes())", "(t0 + (j / boxes()) * gridDim.x)")))
# no ring at all: neither the products nor the loads, each tile's
# accumulators zero, only the staging and the stores
_STORES_ALONE = (("""  ring.start();

  // this thread's rows r + 8·ii of its warpgroup's 64 (from row0)""", """
  // this thread's rows r + 8·ii of its warpgroup's 64 (from row0)"""),
                 ("""  int staged = 0;                          // boxes this warpgroup has staged
  typename Ring::Acc acc[NW / 2];
  ring.wait_rows();
""", """  int staged = 0;                          // boxes this warpgroup has staged
  typename Ring::Acc acc[NW / 2];
"""),
                 ("""    ring.product(i, acc);
    // RG = 1: this warpgroup's half of the last tile may lie past V
    if (v0 >= V) continue;

    // box q""", """#pragma unroll
    for (int q = 0; q < NW / 2; ++q) acc[q] = 0;
    // RG = 1: this warpgroup's half of the last tile may lie past V
    if (v0 >= V) continue;

    // box q"""))
_SIMT_CS = (_STAGED, _SIMT.replace("ST(", "__stcs("))
# (label, edits, the plan's rows: 0 the kernels' choice) on
# csrc/fused_logits_topk.cu
WRITER_VARIANTS = (
    ("as built: the vocab chunks first, two TMA box slots a warpgroup", (), 0),
    ("the row blocks first, logits_topk_kernel's grid (the first staged design)",
     _ROWS_FIRST, 0),
    ("W loads with the L2 evict-last policy", _EVICT_LAST, 0),
    ("three box slots a warpgroup (24 KB)", ((_SLOTS, _SLOTS.replace("= 2;", "= 3;")),), 0),
    ("four box slots a warpgroup: the whole m64n128 tile (32 KB)",
     ((_SLOTS, _SLOTS.replace("= 2;", "= 4;")),), 0),
    ("a 64-column piece a group in one 16 KB slot, read before the next", ((_STAGED, _PIECES),), 0),
    ("64-row blocks (m64n64 tiles)", (), 64),
    ("clusters of 2 along M sharing each W box by TMA multicast (a producer warp)",
     _CLUSTER, 0),
    ("a chunk's tiles strided by the chunk count", _STRIDED, 0),
    ("the stores with an L2 evict-first policy", _EVICT_FIRST, 0),
    ("the block's exit waits for the stores' completion (wait_group 0)",
     (("  if (leader) tma_store_wait_read<0>();\n}", "  if (leader) tma_store_wait<0>();\n}"),), 0),
    ("each warp staged, then plain float4 streaming stores (st.global.cs), no TMA",
     (*_OUT, _SIMT_CS), 0),
    ("each warp staged, then plain float4 stores, no TMA",
     (*_OUT, (_STAGED, _SIMT.replace("ST(", "__stwb("))), 0),
    ("warpgroup 0 stores by TMA, warpgroup 1 by plain float4 streaming stores",
     (*_OUT, (_STAGED, _MIXED)), 0),
    ("the first writer: the row blocks first, direct stores from the registers",
     (*_ROWS_FIRST, *_OUT, (_STAGED, _DIRECT), (_SLOTS, _SLOTS.replace("= 2;", "= 0;"))), 0),
    ("no stores: the products alone (not exact)", ((_STAGED, ""),), 0),
    ("no ring: the stores alone, neither loads nor products (not exact)", _STORES_ALONE, 0),
    ("no ring, plain float4 streaming stores alone (not exact)",
     (*_STORES_ALONE, *_OUT, _SIMT_CS), 0),
    ("every store into the first 64 rows, which stay in L2 (not exact)",
     ((_STORE, _STORE.replace("row0);", "0);")),), 0),
)
GROUPS = ("topk", "eps", "ce_fwd", "ce_bwd_wide", "writer", "topk_wide", "ce_mat_bwd")
# each group's builds: (library kind, source, header edited or None, variants)
BUILDS = {
    "topk": (("topk", "topk_lse.cu", None, TOPK_VARIANTS),),
    "eps": (("eps", "fused_z.cu", None, EPS_VARIANTS),),
    "ce_fwd": (("ce_fwd", "fused_ce.cu", "fused_ce.cuh", CE_FWD_VARIANTS),
               ("ce_mat_fwd", "fused_ce_mat.cu", "fused_ce.cuh", CE_FWD_VARIANTS)),
    "ce_bwd_wide": (("ce_bwd_wide", "fused_ce.cu", None, CE_BWD_WIDE_VARIANTS),),
    "writer": (("writer", "fused_logits_topk.cu", None, WRITER_VARIANTS),),
    "topk_wide": (("topk_wide", "topk_lse.cu", None, TOPK_WIDE_VARIANTS),),
    "ce_mat_bwd": (("ce_mat_bwd", "fused_ce_mat.cu", None, CE_MAT_BWD_VARIANTS),),
}


def edit_files(csrc, edits, edited) -> dict:
    """{file: its text with ``edits`` applied}: an edit (old, new) to
    ``edited``, an edit (file, old, new) to that file of ``csrc``; an edit
    whose text is not there stops the run."""
    texts = {}
    for edit in edits:
        file, old, new = edit if len(edit) == 3 else (edited, *edit)
        text = texts.get(file) or (csrc / file).read_text()
        if old not in text:
            raise SystemExit(f"kernel_designs: edit no longer applies to {file}: {old!r}")
        texts[file] = text.replace(old, new)
    return texts


def build(csrc, out_dir, name, source, edits, edited=None):
    """Start nvcc on ``source`` with ``edits`` applied to it (or to the
    header ``edited``, or to the file an edit names: ``edit_files``),
    beside copies of the shared headers; returns (library path,
    process)."""
    d = out_dir / name
    d.mkdir(parents=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, d)
    shutil.copy(csrc / source, d)
    for file, text in edit_files(csrc, edits, edited or source).items():
        (d / file).write_text(text)
    lib = d / "lib.so"
    cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def in_turns(calls: dict, device_ms) -> dict:
    """Device ms of each call, in the order given and then in reverse:
    {name: (first, second)}."""
    first = {name: sum(device_ms(fn).values()) for name, fn in calls.items()}
    second = {name: sum(device_ms(fn).values()) for name, fn in reversed(calls.items())}
    return {name: (first[name], second[name]) for name in calls}


def main() -> None:
    groups = sys.argv[1:] or GROUPS
    if set(groups) - set(GROUPS):
        sys.exit(f"kernel_designs: groups are {GROUPS}, not {groups}")
    if not torch.cuda.is_available():
        sys.exit("kernel_designs: no CUDA device")
    import chip_smoke as cs

    out_dir = _ext.BUILD_DIR / "designs"
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = {}
    for kind, source, edited, variants in (b for g in groups for b in BUILDS[g]):
        for i, (name, edits, *_) in enumerate(variants):
            jobs[(kind, name)] = build(_ext.CSRC_DIR, out_dir, f"{kind}{i}", source, edits,
                                       edited)
    libs = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"kernel_designs: nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for lib in libs.values():
        if hasattr(lib, "vct_top_k_logsumexp"):
            lib.vct_top_k_logsumexp.argtypes = [P] * 4 + [I] * 5 + [P]
            lib.vct_top_k_logsumexp_select.argtypes = [P] * 5 + [I] * 5 + [P]
            lib.vct_top_k_logsumexp_select_smem.argtypes = [I]
        if hasattr(lib, "vct_fused_z_eps"):
            lib.vct_fused_z_eps.argtypes = [P] + [I] * 3 + [U, U, I, I, P]
        if hasattr(lib, "vct_fused_ce_fwd"):
            lib.vct_fused_ce_fwd.argtypes = [P] * 7 + [I] * 4 + [P]
            lib.vct_fused_ce_dh.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.vct_fused_ce_dwdb.argtypes = [P] * 10 + [I] * 5 + [P]
            lib.vct_fused_ce_fwd_cluster.argtypes = [I, I]
        if hasattr(lib, "vct_fused_ce_mat_fwd"):
            lib.vct_fused_ce_mat_fwd.argtypes = [P] * 8 + [I] * 4 + [P]
            lib.vct_fused_ce_mat_dwdb.argtypes = [P] * 9 + [I] * 5 + [P]
        if hasattr(lib, "vct_fused_logits_write"):
            lib.vct_fused_logits_write.argtypes = [P] * 4 + [I] * 8 + [P]
            lib.vct_fused_logits_write_int8.argtypes = [P] * 6 + [I] * 8 + [P]
            lib.vct_fused_logits_write_smem.argtypes = [I] * 4
    dev, label = cs.DEV, cs.card()
    sms = _ext.sm_count(dev.index)

    def top_k(lib, x, k):
        N, V = x.shape
        vals = torch.empty((N, k), device=dev)
        idx = torch.empty((N, k), dtype=torch.int32, device=dev)
        lse = torch.empty((N,), device=dev)
        _ext.check_launch(lib.vct_top_k_logsumexp(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), N, V, V, k, sms,
            _ext.stream_ptr(dev)), "top_k_logsumexp variant")
        return vals, idx, lse

    def eps(lib, shape, raw):
        N, K, L = shape
        out = torch.empty(shape, dtype=torch.int32 if raw else torch.float32, device=dev)
        _ext.check_launch(lib.vct_fused_z_eps(out.data_ptr(), N, L, K, 5, 6, int(raw), sms,
                                              _ext.stream_ptr(dev)), "fused_z_eps variant")
        return out

    if "topk" in groups:
        time_topk(libs, label, top_k)
    if "eps" in groups:
        time_eps(libs, dev, label, eps)
    if "ce_fwd" in groups:
        time_ce_fwd(libs, dev, label, sms)
    if "ce_bwd_wide" in groups:
        time_ce_bwd_wide(libs, dev, label)
    if "writer" in groups:
        time_writer(libs, dev, label, sms)
    if "topk_wide" in groups:
        time_topk_wide(libs, dev, label, sms)
    if "ce_mat_bwd" in groups:
        time_ce_mat_bwd(libs, dev, label, sms)


def time_topk(libs, label, top_k) -> None:
    """The top-k + logsumexp variants at beam 3 and beam 10."""
    import chip_smoke as cs
    from vae_captioning_torch.ops.topk_lse import top_k_logsumexp_plain

    for N, k in ((1536, 3), (5120, 10)):
        x = cs.unfused_logits(N, 11500, seed=N)
        want = top_k_logsumexp_plain(x, k)
        calls = {name: (lambda lib=lib: top_k(lib, x, k))
                 for (kind, name), lib in libs.items() if kind == "topk"}
        for name, (a, b) in in_turns(calls, cs.device_ms).items():
            vals, idx, _ = calls[name]()
            exact = torch.equal(vals, want[0]) and torch.equal(idx, want[1])
            print(f"top_k_logsumexp N={N} V=11500 k={k}, {name}: device {a:.4f} / {b:.4f} ms; "
                  f"exact {exact} [{label}]")


def time_eps(libs, dev, label, eps) -> None:
    """The eps stream's variants, normals and raw words."""
    import chip_smoke as cs
    from vae_captioning_torch.ops.fused_z import philox_bits, philox_normals

    shape = (cs.TRAIN_ROWS, cs.KZ, cs.LATENT)
    words, normals = philox_bits(5, 6, *shape, device=dev), philox_normals(5, 6, *shape, device=dev)
    for raw in (False, True):
        calls = {name: (lambda lib=lib: eps(lib, shape, raw))
                 for (kind, name), lib in libs.items() if kind == "eps"}
        for name, (a, b) in in_turns(calls, cs.device_ms).items():
            got = calls[name]()
            exact = (torch.equal(got.long() & 0xFFFFFFFF, words) if raw
                     else torch.equal(got, normals))
            print(f"fused_z_eps {'x'.join(map(str, shape))} {'words' if raw else 'normals'}, "
                  f"{name}: device {a:.4f} / {b:.4f} ms; exact {exact} [{label}]")


# the widths past 512 other than 1024 at which the shape rule's choice
# (clusters or blocks alone, both with the box count at run time) is
# timed: the narrowest and widest resident widths of each forward
RULE_WIDTHS = ((576, False), (1280, False), (576, True), (1152, True))


def time_ce_fwd(libs, dev, label, sms) -> None:
    """Both CE forwards' variants at the wide cell's H = 1024 (the train
    batch's labels), by device time in turns, against the plain version
    and the built kernel; then, at ``RULE_WIDTHS``, the built kernel
    against the blocks alone (and, in the flash forward, the warpgroups
    on column halves).  Each variant's plan takes its own shape
    rule's cluster (asked from its flash library), and its line the L2
    bytes reckoned for it (chip_smoke.fwd_l2_bytes)."""
    names = [name for name, _ in CE_FWD_VARIANTS]
    for wl in (False, True):
        time_ce_fwd_at(libs, dev, label, sms, 1024, wl, names)
    for H, wl in RULE_WIDTHS:
        halves = [] if wl else [_HALVES_LABEL]
        time_ce_fwd_at(libs, dev, label, sms, H, wl, names[:2] + halves)


def time_ce_fwd_at(libs, dev, label, sms, H: int, wl: bool, names) -> None:
    """The variants ``names`` of one forward (flash, or written logits
    where ``wl``) at M = 30,720, V = 11,500 and width H."""
    import chip_smoke as cs
    from vae_captioning_torch.ops import fused_ce

    M, V = cs.TRAIN_T * cs.TRAIN_ROWS, cs.VOCAB
    ops = fused_ce.prepare(*cs.ce_inputs(M, V, seed=13, labels=cs.train_ce_labels(), H=H)[:4])
    want = fused_ce.ce_fwd_plain(*ops)
    rows = fused_ce.fwd_block(H, wl)[0]
    kind, tag = ("ce_mat_fwd", "fused_linear_ce_mat_fwd") if wl else ("ce_fwd", "fused_linear_ce_fwd")

    def forward(name):
        # the plan takes the shipped clusters; clusters of 4 run on their
        # chunks (the launch rounds its row blocks to whole clusters)
        cluster = libs["ce_fwd", name].vct_fused_ce_fwd_cluster(H, int(wl))
        plan = fused_ce.ce_fwd_plan(M, V, sms, rows, min(cluster, fused_ce.FWD_CLUSTER))
        part = torch.empty(plan.part, device=dev)
        out = torch.empty((2, M), device=dev)
        ptrs = [t.data_ptr() for t in ops] + [part.data_ptr()]
        if wl:
            lg = torch.empty((M, fused_ce.logits_pitch(V)), dtype=torch.bfloat16, device=dev)
            err = libs[kind, name].vct_fused_ce_mat_fwd(
                *ptrs, lg.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), M, H, V,
                plan.chunk_tiles, _ext.stream_ptr(dev))
        else:
            err = libs[kind, name].vct_fused_ce_fwd(
                *ptrs, out[0].data_ptr(), out[1].data_ptr(), M, H, V, plan.chunk_tiles,
                _ext.stream_ptr(dev))
        _ext.check_launch(err, f"{tag} variant")
        return (out[0], out[1], lg) if wl else (out[0], out[1])

    calls = {name: (lambda name=name: forward(name)) for name in names}
    built = calls[names[0]]()
    for name, (a, b) in in_turns(calls, cs.device_ms).items():
        got = calls[name]()
        rel = [cs.rel_err(g, r)[1] for g, r in zip(got, want)]
        ok = all(x <= cs.CE_FWD_RTOL for x in rel)
        same = all(torch.equal(g, r) for g, r in zip(got, built))
        cluster = libs["ce_fwd", name].vct_fused_ce_fwd_cluster(H, int(wl))
        print(f"{tag} M={M} H={H} V={V}, {name}: device {a:.4f} / {b:.4f} ms; "
              f"max |kernel - plain| / max lse, ll {rel[0]:.2e}, {rel[1]:.2e}: exact "
              f"(within {cs.CE_FWD_RTOL}) {ok}; bit for bit with the built kernel "
              f"{same}; L2 bytes reckoned "
              f"{cs.fwd_l2_bytes(M, H, V, wl, cluster) / 1e9:.3f} GB [{label}]")
        del got


def time_ce_bwd_wide(libs, dev, label) -> None:
    """dh and dW/db of each variant at M = 30,720, H = 1024, V = 11,500
    (the train batch's labels), by device time in turns, against the
    plain version and the built kernel."""
    import chip_smoke as cs
    from vae_captioning_torch.ops import fused_ce

    M, H, V = cs.TRAIN_T * cs.TRAIN_ROWS, cs.WIDE_HIDDEN, cs.VOCAB
    h, w, b, labels, weights = cs.ce_inputs(M, V, seed=13, labels=cs.train_ce_labels(), H=H)
    ops = fused_ce.prepare(h, w, b, labels)
    lse, _ = fused_ce.ce_fwd_plain(h, w, b, labels)
    plan = fused_ce.ce_bwd_plan(M, H, V)
    want = (fused_ce.ce_dh_plain(h, w, b, labels, lse, weights),
            *fused_ce.ce_dwdb_plain(h, w, b, labels, lse, weights))
    ptrs = [t.data_ptr() for t in (*ops, lse, weights)]

    def dh(lib):
        out = torch.empty((plan.dh_rows, H), device=dev)
        _ext.check_launch(lib.vct_fused_ce_dh(*ptrs, out.data_ptr(), M, H, V,
                                              _ext.stream_ptr(dev)), "fused_ce_dh variant")
        return (out[:M],)

    def dwdb(lib):
        parts = [torch.empty(plan.dw_part, device=dev), torch.empty(plan.db_part, device=dev)]
        dw, db = torch.empty((V, H), device=dev), torch.empty((V,), device=dev)
        _ext.check_launch(lib.vct_fused_ce_dwdb(
            *ptrs, *(t.data_ptr() for t in (*parts, dw, db)), M, H, V, plan.splits,
            plan.dwdb_per, _ext.stream_ptr(dev)), "fused_ce_dwdb variant")
        return dw, db

    variants = {name: lib for (kind, name), lib in libs.items() if kind == "ce_bwd_wide"}
    built = {fn: fn(variants[CE_BWD_WIDE_VARIANTS[0][0]]) for fn in (dh, dwdb)}
    for fn, tols, refs in ((dh, (cs.CE_GRAD_RTOL,), want[:1]),
                           (dwdb, (cs.CE_GRAD_RTOL, cs.CE_DB_RTOL), want[1:])):
        calls = {name: (lambda lib=lib: fn(lib)) for name, lib in variants.items()}
        for name, (a, b_) in in_turns(calls, cs.device_ms).items():
            got = calls[name]()
            rel = [cs.rel_err(g, r)[1] for g, r in zip(got, refs)]
            ok = all(x <= t for x, t in zip(rel, tols))
            same = all(torch.equal(g, r) for g, r in zip(got, built[fn]))
            print(f"fused_linear_ce_{fn.__name__} M={M} H={H} V={V}, {name}: device "
                  f"{a:.4f} / {b_:.4f} ms; max |kernel - plain| / max "
                  f"{', '.join(f'{x:.2e}' for x in rel)}: exact (within "
                  f"{', '.join(map(str, tols))}) {ok}; bit for bit with the built "
                  f"kernel {same} [{label}]")


def time_writer(libs, dev, label, sms) -> None:
    """The writer's variants: each exact one bit for bit against the built
    kernel at every WRITE_SHAPES entry; then, at the wide beams' shapes,
    all of them by device time in turns, the built kernel against the
    plain version and each exact variant against the built kernel."""
    import chip_smoke as cs
    from vae_captioning_torch.ops.fused_logits_topk import (
        int8_logits, logits_pitch, logits_plan, pitched_logits, quantize_rows)

    variants = {name: (libs["writer", name], rows) for name, _, rows in WRITER_VARIANTS}
    exact = [name for name in variants if "not exact" not in name]

    def operands(M, V, H, int8, seed):
        if int8:
            h, wq, ws, b = cs.int8_inputs(M, V, seed, H)
            hq, hs = quantize_rows(h)
            return (hq, hs, wq.t().contiguous(), ws, b), (hq, hs, wq, ws, b)
        h, w, b = cs.logits_inputs(M, V, H, seed=seed)
        return (h, w.t().contiguous(), b), (h, w, b)

    def writer(name, M, V, H, int8, ops, out):
        lib, rows = variants[name]
        plan = logits_plan(M, H, V, 1, 1 if int8 else 2, sms, rows=rows)
        fn = lib.vct_fused_logits_write_int8 if int8 else lib.vct_fused_logits_write
        _ext.check_launch(fn(*(t.data_ptr() for t in ops), out.data_ptr(), M, H, V,
                             logits_pitch(V), plan.rows, int(plan.resident), plan.chunk_tiles,
                             plan.chunks, _ext.stream_ptr(dev)), "logits writer variant")
        return out

    for M, V, H, int8 in cs.WRITE_SHAPES:
        ops, _ = operands(M, V, H, int8, M + V + H)
        outs = {name: writer(name, M, V, H, int8, ops, pitched_logits(M, V, dev))
                for name in exact}
        same = {name: torch.equal(outs[name], outs[exact[0]]) for name in exact[1:]}
        print(f"logits writer {'int8' if int8 else 'bf16'} M={M} H={H} V={V}: bit for bit "
              f"with the built kernel: " + "; ".join(f"{k} {v}" for k, v in same.items()))
        del outs
    H, V = 512, cs.VOCAB
    for M, int8 in ((10240, False), (20480, False), (10240, True)):
        ops, plain_ops = operands(M, V, H, int8, M)
        out = pitched_logits(M, V, dev)
        calls = {name: (lambda name=name: writer(name, M, V, H, int8, ops, out))
                 for name in variants}
        built = calls[exact[0]]().clone()
        if int8:
            plain_ok = torch.equal(built, int8_logits(*plain_ops))
        else:
            plain_ok = cs.logits_error_ratio(built, *plain_ops) <= 1.0
        moved = cs.nbytes(*ops) + 4 * M * V
        bnd = cs.bound(2.0 * M * H * V, moved, cs.PEAK_INT8 if int8 else cs.PEAK_BF16)
        tag = f"logits writer {'int8' if int8 else 'bf16'} M={M} H={H} V={V}"
        print(f"{tag}: built kernel against the plain version: "
              f"{'bit for bit' if int8 else 'within the f32 sum-order bound'} {plain_ok}; "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}) [{label}]")
        for name, (a, b_) in in_turns(calls, cs.device_ms).items():
            lib, rows = variants[name]
            plan = logits_plan(M, H, V, 1, 1 if int8 else 2, sms, rows=rows)
            smem = lib.vct_fused_logits_write_smem(H, int(int8), plan.rows, int(plan.resident))
            same = torch.equal(calls[name](), built) if name in exact else None
            print(f"{tag}, {name}: device {a:.4f} / {b_:.4f} ms (share "
                  f"{bnd[0] / min(a, b_):.3f}); {plan.rows}-row blocks, {plan.chunks} chunks "
                  f"of {plan.chunk_tiles} tiles, {smem} B shared memory"
                  + ("" if same is None else f"; bit for bit with the built kernel {same}")
                  + f" [{label}]")
        fill = [sum(cs.device_ms(lambda: out.fill_(1.0)).values()) for _ in range(2)]
        print(f"{tag}: the same [M, V] buffer written by fill_ (a write stream, not the "
              f"function): device {fill[0]:.4f} / {fill[1]:.4f} ms [{label}]")
        del out, calls, built


# row 5 past k = 32 at the wide beams' rows (N, V, k, pitched): beam 40 of
# 512 images on the writer's pitched rows, beam 64 of 512, the sort's old
# (300, 11519, 65 / 256), beam 100 of 128 images
WIDE_SELECT_SHAPES = ((20480, 11500, 40, True), (32768, 11500, 64, False),
                      (300, 11519, 65, False), (300, 11519, 256, False),
                      (12800, 11500, 100, False))


def time_topk_wide(libs, dev, label, sms) -> None:
    """Row 5's variants past k = 32 at WIDE_SELECT_SHAPES on the unfused
    decode's logits (bf16-rounded, ties abound), by device time in turns:
    each exact variant's values and indices bit for bit against the built
    kernel's (and its lse bit for bit, or the largest relative difference
    where its sum runs in another order), the built kernel against the
    plain version (values and indices bit for bit, lse to LSE_RTOL), and
    the bound: x read once and the outputs written once at the card's
    memory rate."""
    import chip_smoke as cs
    from vae_captioning_torch.ops.fused_logits_topk import pitched_logits
    from vae_captioning_torch.ops.topk_lse import row_pitch, top_k_logsumexp_plain

    variants = {name: libs["topk_wide", name] for name, _ in TOPK_WIDE_VARIANTS}
    exact = [name for name in variants if "not exact" not in name]

    def select(lib, x, k, out):
        N, V = x.shape
        _ext.check_launch(lib.vct_top_k_logsumexp_select(
            x.data_ptr(), *(t.data_ptr() for t in out), None, N, V, row_pitch(x), k, sms,
            _ext.stream_ptr(dev)), "top_k_logsumexp select variant")
        return out

    for N, V, k, pitched in WIDE_SELECT_SHAPES:
        x = cs.unfused_logits(N, V, seed=N + k)
        if pitched:
            x = pitched_logits(N, V, dev).copy_(x)
        out = (torch.empty((N, k), device=dev), torch.empty((N, k), dtype=torch.int32, device=dev),
               torch.empty((N,), device=dev))
        calls = {name: (lambda lib=lib: select(lib, x, k, out)) for name, lib in variants.items()}
        built = [t.clone() for t in calls[exact[0]]()]
        want = top_k_logsumexp_plain(x, k)
        plain_ok = (torch.equal(built[0], want[0]) and torch.equal(built[1], want[1])
                    and cs.rel_err(built[2], want[2])[1] <= cs.LSE_RTOL)
        bnd = cs.bound(0.0, cs.nbytes(x, *built))
        tag = f"top_k_logsumexp N={N} V={V} k={k}{' (pitched rows)' if pitched else ''}"
        print(f"{tag}: built kernel against the plain version: values and indices bit for "
              f"bit, lse within {cs.LSE_RTOL}: {plain_ok}; bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"{sms} SMs, {libs['topk_wide', exact[0]].vct_top_k_logsumexp_select_smem(V)} B "
              f"shared memory a block [{label}]")
        for name, (a, b) in in_turns(calls, cs.device_ms).items():
            note = ""
            if name in exact:
                got = calls[name]()
                same = torch.equal(got[0], built[0]) and torch.equal(got[1], built[1])
                lse = ("bit for bit" if torch.equal(got[2], built[2])
                       else f"to {cs.rel_err(got[2], built[2])[1]:.2e}")
                note = f"; values and indices bit for bit with the built kernel {same}, lse {lse}"
            print(f"{tag}, {name}: device {a:.4f} / {b:.4f} ms (share "
                  f"{bnd[0] / min(a, b):.3f}){note} [{label}]")
        del x, out, calls, built, want


def time_ce_mat_bwd(libs, dev, label, sms) -> None:
    """The written logits' dW/db variants at M = 30,720, H = 1024, V =
    11,500 (the train batch's labels), by device time in turns, on the
    shipped plan's row splits (one), each against the plain version and the
    exact ones against the built kernel (int32 views: sign bits too); the
    bound: 2·M·H·V operations at the bf16 peak, or the bytes read and
    written once."""
    import chip_smoke as cs
    from vae_captioning_torch.ops import fused_ce

    M, H, V = cs.TRAIN_T * cs.TRAIN_ROWS, 1024, cs.VOCAB
    h, w, b, labels, weights = cs.ce_inputs(M, V, seed=13, labels=cs.train_ce_labels(), H=H)
    h16, _, _, lab = fused_ce.prepare(h, w, b, labels)
    lg, lse, _ = fused_ce.ce_mat_fwd_plain(h, w, b, labels)
    del w, b
    want = fused_ce.ce_mat_dwdb_plain(h, lg, labels, lse, weights, V)
    plan = fused_ce.ce_bwd_plan(M, H, V, sms)
    variants = {name: (libs["ce_mat_bwd", name], rb, summed)
                for name, _, rb, summed in CE_MAT_BWD_VARIANTS}

    def dwdb(name):
        lib, rb, summed = variants[name]
        rows = -(-V // (64 * rb)) * 64 * rb
        parts = (torch.empty((plan.splits, rows, H), device=dev),
                 torch.empty((plan.splits, rows), device=dev))
        in_place = plan.splits == 1 and not summed
        out = ((parts[0][0, :V], parts[1][0, :V]) if in_place
               else (torch.empty((V, H), device=dev), torch.empty((V,), device=dev)))
        _ext.check_launch(lib.vct_fused_ce_mat_dwdb(
            *(t.data_ptr() for t in (h16, lg, lab, lse, weights, *parts)),
            *((None, None) if in_place else (t.data_ptr() for t in out)), M, H, V,
            plan.splits, plan.dwdb_per, _ext.stream_ptr(dev)), "fused_ce_mat_dwdb variant")
        return out

    calls = {name: (lambda name=name: dwdb(name)) for name in variants}
    built = calls[CE_MAT_BWD_VARIANTS[0][0]]()
    bnd = cs.bound(2.0 * M * H * V, cs.nbytes(h16, lg, lab, lse, weights, *built))
    tag = f"fused_linear_ce_mat_dwdb M={M} H={H} V={V}"
    print(f"{tag}: {plan.splits} split(s), bound {bnd[0]:.4f} ms ({bnd[1]}) [{label}]")
    for name, (a, b_) in in_turns(calls, cs.device_ms).items():
        got = calls[name]()
        rel = [cs.rel_err(g, r)[1] for g, r in zip(got, want)]
        ok = rel[0] <= cs.CE_GRAD_RTOL and rel[1] <= cs.CE_MAT_DB_RTOL
        same = all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                   for g, r in zip(got, built))
        print(f"{tag}, {name}: device {a:.4f} / {b_:.4f} ms (share {bnd[0] / min(a, b_):.3f}); "
              f"max |kernel - plain| / max dW, db {rel[0]:.2e}, {rel[1]:.2e}: exact (within "
              f"{cs.CE_GRAD_RTOL}, {cs.CE_MAT_DB_RTOL}) {ok}; bit for bit with the built "
              f"kernel {same} [{label}]")
        del got
    del calls, built, want, lg


if __name__ == "__main__":
    main()
