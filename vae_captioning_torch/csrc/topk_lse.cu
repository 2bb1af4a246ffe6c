// Row-wise exact top-k + logsumexp over materialised f32 logits, for
// Hopper (sm_90a), exported with a plain C interface and loaded through
// ctypes (vae_captioning_torch/_ext.py).
//
// Replaces the TPU kernel vae_captioning_tpu/ops/topk_pallas.py (_kernel,
// called through top_k_logsumexp_pallas), the beam search's top-k when the
// decode step writes its logits (Config.fused_decode = False):
//
//     vals, idx = top_k(x, k)     ties go to the lowest index
//     lse = logsumexp(x)
//
// x [N,V] f32 (rows `pitch` floats apart, pitch >= V: the fused decodes'
// writer pads its rows to 16 bytes) -> vals [N,k] f32, idx [N,k] int32,
// lse [N] f32, for 1 <= k <= V.  Values are copied, never computed, so
// vals and idx equal a stable sort's prefix bit for bit; only lse differs
// from the plain version, by sum order (which follows where each row meets
// a 16-byte boundary).  Up to k = 32 (the warp lists) a row needs at least
// k values above -inf; past 32 (the radix select) any row is taken.
//
// What bounds it on this card: reading x once (70.7 MB at N = 1536, V =
// 11500: 21 us at 3.35 TB/s; 235 MB, 70 us, at N = 5120).  The TPU kernel
// makes k extraction passes over 8 rows held in VMEM; here a warp streams
// a row once.  The design, against what held the first port (one 256-thread
// block a row, scalar loads, an expf a value, one thread merging):
//
// * Bytes in flight: 16-byte loads (ld.global.cs), with a scalar head of
//   0-3 values up to the first 16-byte boundary (a row of 11519 floats
//   starts at any 4-byte offset; a pitched row may too) and a scalar
//   tail.  A lane loads U = 8 float4 a chunk (4 KB a warp) into one of two
//   register buffers while it folds the other, so its loads stay
//   outstanding through the arithmetic.
// * Whole waves: a persistent grid, two 8-warp blocks an SM (launch
//   bounds), each warp striding over rows; row r goes to block r mod G,
//   so consecutive rows land on different SMs and each SM holds N / 132
//   rows to within one.
// * Cheap exp: one FFMA and one ex2.approx on log2(e)-scaled values, the
//   running max moved once a chunk (the chunk's max taken first).
// * Lists: one list a warp, entry j in lane j, ordered by (value desc,
//   index asc).  Chunks arrive in ascending columns, so only a value above
//   the list's k-th can enter from a chunk (an equal one has a larger
//   index): one vote on the lanes' maxima skips a chunk without one.  In a
//   chunk with some, each lane marks its candidates in a bit mask (while
//   the list is not full, only values at or above the k-th largest of the
//   lanes' maxima qualify), the chunk goes to shared memory, and the warp
//   takes the candidates one at a time from there, each checked against
//   the k-th entry as it stands and placed by one vote and one shuffle.
//   No per-value vote, and no merge: the warp's list is the row's.
// * Lists past 16 (beams of 17 to 32): k is a run-time value, entry j in
//   lane j (the template's S slots a lane, entry j in slot j / 32 of lane
//   j % 32, ran lists to 64 with S = 2; kernel_designs.py keeps that
//   design as a variant).  Lists of 16 or fewer keep their compile-time
//   instances.
// * Lists past 32 (beams of 33 and more: 40 on the wide-beam path, 100 on
//   128 images): one 512-thread block a row, three blocks an SM,
//   persistent, and no list at all.  Past 32 entries the lanes' maxima bound nothing,
//   so a warp's list took nearly every value of its first chunk through
//   its serial insert (2.0 ms at 20,480 x 11,500, k = 40).  Here the row's
//   16-byte body lands in shared memory by one bulk copy (cp.async.bulk
//   on an mbarrier; rows to 16,384 columns; a block's copy runs under the
//   other two blocks' selects; the 0-3 head and tail values loaded by
//   their threads a row ahead), and the block reads it twice:
//   one pass for each thread's max, then, with a bound lo from those
//   maxima (each warp's j-th largest, j = ceil(k / 16), by j rounds of
//   redux.sync, and the least over the warps: k columns reach it), one
//   pass summing exp(x - max) (ex2) and appending the columns at or above
//   lo (two to three times k) to a candidate list.  The candidates are
//   counting-sorted by 512 bins of their value over [lo, max], monotone
//   in it, and each is placed by the candidates in the bins above its own
//   and those above it in its bin: the first k are the row's top k, in
//   order, their values copied from the staged row, so bit for bit a
//   stable sort's prefix (ties by column, -0 = +0, NaN the largest).
//   Where the bound fails (k past 128) or the candidates overflow (ties, a
//   narrow row), an exact radix select on the row's order keys instead
//   (11-bit digits, shared-atomic histograms, the tie's lowest columns by
//   a block-wide count; past 512 winners a global workspace).  What bounds
//   it: the bytes of x once (0.283 ms at 20,480 x 11,500), and the
//   issue slots of the two passes and the per-row barriers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int U = 8;                 // float4 a lane loads a chunk
constexpr int CHUNK = U * 32;        // float4 a warp loads a chunk
constexpr unsigned FULL = 0xffffffffu;
using Order = TopK<1>;               // the lists' order: value desc, index asc

// 2^x through ex2.approx (2 ulp); 2^-inf = 0
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a warp's row state: the list (K > 0: K entries, entry `lane` in lv[0],
// li[0] for lanes < K; K = 0: n entries set at run time, entry 32 s + lane
// in lv[s], li[s]), its last entry (tv, ti) in every lane, and the lane's
// (max, sum of exp(x - max)) over the values it has seen
template <int K, int S>
struct RowState {
  static_assert(K > 0 ? S == 1 : S >= 1, "a compile-time list takes one slot");
  float lv[S], tv;
  int li[S], ti;
  float m, s;
  int n;

  __device__ __forceinline__ int len() const { return K > 0 ? K : n; }

  __device__ __forceinline__ void init(int k) {
    n = K > 0 ? K : k;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      lv[j] = -INFINITY;
      li[j] = EMPTY_IDX;
    }
    tv = -INFINITY;
    ti = EMPTY_IDX;
    m = -INFINITY;
    s = 0.0f;
  }

  // fold n values of this lane, whose largest is mc, into (m, s): the
  // rescale once, then one FFMA and one ex2 a value
  template <int NV>
  __device__ __forceinline__ void fold(const float (&v)[NV], float mc) {
    const float mn = fmaxf(m, mc);
    if (mn != m) s *= ex2((m - mn) * LOG2E);   // m = -inf: s is 0
    const float mo = mn == -INFINITY ? 0.0f : mn * LOG2E;
#pragma unroll
    for (int j = 0; j < NV; ++j) s += ex2(fmaf(v[j], LOG2E, -mo));
    m = mn;
  }

  // (cv, ci), the same in every lane and better than the last entry, into
  // the list: its position by a vote, the entries below it down one (a
  // slot's lane 0 takes lane 31 of the slot above, read before it moves)
  __device__ __forceinline__ void insert(float cv, int ci, int lane) {
    int pos = 0;
#pragma unroll
    for (int j = 0; j < S; ++j)
      pos += __popc(__ballot_sync(
          FULL, 32 * j + lane < len() && Order::better(lv[j], li[j], cv, ci)));
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      float uv = __shfl_up_sync(FULL, lv[j], 1);
      int ui = __shfl_up_sync(FULL, li[j], 1);
      if (j > 0) {
        const float av = __shfl_sync(FULL, lv[j > 0 ? j - 1 : 0], 31);
        const int ai = __shfl_sync(FULL, li[j > 0 ? j - 1 : 0], 31);
        if (lane == 0) {
          uv = av;
          ui = ai;
        }
      }
      const int g = 32 * j + lane;
      if (g == pos) {
        lv[j] = cv;
        li[j] = ci;
      } else if (g > pos) {
        lv[j] = uv;
        li[j] = ui;
      }
    }
    const int last = len() - 1;
    float v = lv[0];
    int i = li[0];
#pragma unroll
    for (int j = 1; j < S; ++j)
      if (last / 32 == j) {
        v = lv[j];
        i = li[j];
      }
    tv = __shfl_sync(FULL, v, last % 32);
    ti = __shfl_sync(FULL, i, last % 32);
  }

  // one value a lane outside the 16-byte body (head or tail; -inf and
  // EMPTY_IDX where a lane has none): the lanes that beat the k-th entry,
  // lowest first
  __device__ __forceinline__ void scalar(float v, int col, int lane) {
    const float one[1] = {v};
    fold(one, v);
    for (unsigned mask = __ballot_sync(FULL, Order::better(v, col, tv, ti)); mask;
         mask &= mask - 1) {
      const int src = __ffs(mask) - 1;
      const float cv = __shfl_sync(FULL, v, src);
      const int ci = __shfl_sync(FULL, col, src);
      if (Order::better(cv, ci, tv, ti)) insert(cv, ci, lane);
    }
  }

  // a chunk of U float4 a lane (-inf past the row); float4 number f0 + 32
  // u + lane holds columns c0 + 4 (f0 + 32 u + lane) ..  Every entry's
  // column lies below the chunk's, so only a value above the k-th can
  // enter; while the list is not full, only one at or above the k-th
  // largest of the lanes' maxima (k values of the row are).  A lane marks
  // its candidates in a bit mask; the chunk goes to the warp's `stage` and
  // the candidates are read back from there, one lane's at a time.
  __device__ __forceinline__ void chunk(const float4 (&b)[U], int f0, int c0, int lane,
                                        float4* stage) {
    float v[4 * U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[4 * u] = b[u].x;
      v[4 * u + 1] = b[u].y;
      v[4 * u + 2] = b[u].z;
      v[4 * u + 3] = b[u].w;
    }
    float mc = v[0];
#pragma unroll
    for (int j = 1; j < 4 * U; ++j) mc = fmaxf(mc, v[j]);
    fold(v, mc);
    const float low = tv == -INFINITY && len() <= 32 ? kth_of_lanes(mc, lane) : -INFINITY;
    if (!__any_sync(FULL, mc > tv && mc >= low)) return;
    unsigned cm = 0;
#pragma unroll
    for (int j = 0; j < 4 * U; ++j) cm |= (v[j] > tv && v[j] >= low ? 1u : 0u) << j;
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u) stage[32 * u + lane] = b[u];
    __syncwarp();
    const float* st = reinterpret_cast<const float*>(stage);
    for (unsigned lanes = __ballot_sync(FULL, cm != 0); lanes; lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (unsigned bits = __shfl_sync(FULL, cm, src); bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        const int f = 32 * (j / 4) + src;
        const float cv = st[4 * f + j % 4];
        const int ci = c0 + 4 * (f0 + f) + j % 4;
        if (Order::better(cv, ci, tv, ti)) insert(cv, ci, lane);
      }
    }
  }

  // the k-th largest of the lanes' m (k <= 32), in every lane (a bitonic
  // sort, descending, across the warp)
  __device__ __forceinline__ float kth_of_lanes(float m, int lane) const {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int d = size / 2; d > 0; d >>= 1) {
        const float o = __shfl_xor_sync(FULL, m, d);
        m = ((lane & size) == 0) == ((lane & d) == 0) ? fmaxf(m, o) : fminf(m, o);
      }
    return __shfl_sync(FULL, m, len() - 1);
  }
};

__device__ __forceinline__ void load(float4 (&b)[U], const float4* __restrict__ body, int f0,
                                     int nv, int lane) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int f = f0 + u * 32 + lane;
    b[u] = f < nv ? __ldcs(body + f) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  }
}

template <int K, int S>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
topk_lse_kernel(const float* __restrict__ x, float* __restrict__ vals,
                int* __restrict__ idx, float* __restrict__ lse, int N, int V, int pitch,
                int k) {
  __shared__ float4 stage[WARPS][CHUNK];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int row = warp * gridDim.x + blockIdx.x; row < N; row += gridDim.x * WARPS) {
    const float* xr = x + static_cast<size_t>(row) * pitch;
    // columns [0, h) scalar, [h, h + 4 nv) as float4, the rest scalar
    const int h = min(V, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / 4);
    const int nv = (V - h) / 4;
    const int t0 = h + 4 * nv;
    const float4* body = reinterpret_cast<const float4*>(xr + h);

    RowState<K, S> st;
    st.init(k);
    st.scalar(lane < h ? xr[lane] : -INFINITY, lane < h ? lane : EMPTY_IDX, lane);
    const int chunks = (nv + CHUNK - 1) / CHUNK;
    float4 a[U], b[U];
    load(a, body, 0, nv, lane);
    for (int c = 0; c < chunks; c += 2) {
      load(b, body, (c + 1) * CHUNK, nv, lane);
      st.chunk(a, c * CHUNK, h, lane, stage[warp]);
      if (c + 1 < chunks) {
        load(a, body, (c + 2) * CHUNK, nv, lane);
        st.chunk(b, (c + 1) * CHUNK, h, lane, stage[warp]);
      }
    }
    st.scalar(t0 + lane < V ? xr[t0 + lane] : -INFINITY, t0 + lane < V ? t0 + lane : EMPTY_IDX,
              lane);

    // the lanes' (max, sum) merged by butterfly shuffles
    float m = st.m, s = st.s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m, off);
      const float os = __shfl_xor_sync(FULL, s, off);
      const float nm = fmaxf(m, om);
      s = (m == nm ? s : s * expf(m - nm)) + (om == nm ? os : os * expf(om - nm));
      m = nm;
    }
    const int n = st.len();
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (32 * j + lane < n) {
        vals[static_cast<size_t>(row) * n + 32 * j + lane] = st.lv[j];
        idx[static_cast<size_t>(row) * n + 32 * j + lane] = st.li[j];
      }
    if (lane == 0) lse[row] = m + logf(s);
  }
}

// ---------------------------------------------------------------------
// lists past 32: a block a row, the row staged in shared memory
// ---------------------------------------------------------------------

constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_MIN_BLOCKS = 3;        // launch bounds: three blocks an SM, 40 registers
constexpr int SEL_STAGES = 1;            // rows staged a block at once (two, the next row's copy
                                         // in flight, leave room for two blocks an SM: slower)
constexpr int SEL_STAGE_COLS = 16384;    // the widest row staged (64 KB); wider rows are read
                                         // from x in each pass
constexpr int SEL_DIGIT = 11;            // the first digit's bits; then 11 a digit
constexpr int SEL_BINS = 1 << 11;
constexpr int SEL_CAND = 512;            // candidates a list holds (two lists, ping-pong)
constexpr int SEL_WIN = 512;             // winners held in shared memory; past it a workspace
constexpr int SEL_RANK = 256;            // winners placed by counting up to here, then sorted

// the order of the select: a monotone 32-bit image of the value (larger
// key, larger value), -0 as +0 (a tie, as in the sort) and every NaN the
// largest value (torch.sort's order)
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = v != v ? 0x7fffffffu : __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// an entry of the lists: the key above the inverted column, so a larger
// entry is a better one (value descending, then column ascending); every
// entry of a row is nonzero (a key is at least that of -inf)
__device__ __forceinline__ unsigned long long sel_entry(uint32_t key, int col) {
  return (static_cast<unsigned long long>(key) << 32) | ~static_cast<uint32_t>(col);
}

// the value whose order key is key (-0 comes back as +0, every NaN as
// the one NaN order_key maps them to)
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

__device__ __forceinline__ int sel_col(unsigned long long e) {
  return static_cast<int>(~static_cast<uint32_t>(e));
}

struct alignas(16) SelShared {
  uint32_t hist[SEL_BINS];
  unsigned long long cand[2][SEL_CAND];
  unsigned long long win[SEL_WIN];
  uint64_t bar[SEL_STAGES];
  float red_m[SEL_WARPS], red_s[SEL_WARPS];
  uint32_t bound[SEL_WARPS];
  int scan[SEL_WARPS];
  int cut[3];
  int win_n, cand_n[2];
};

__host__ __device__ constexpr int sel_row_floats(int V) { return (V + 6) / 4 * 4; }
__host__ __device__ constexpr int sel_pad(int k) {
  int n = 1;
  while (n < k) n *= 2;
  return n;
}

// the head or tail column of this thread in a row of V columns whose body
// is [h, h + 4 nv) (V or past where it has none)
__device__ __forceinline__ int edge_of(int h, int nv, int V) {
  const int t = threadIdx.x;
  return t < h ? t : h + 4 * nv + t - h;
}

// f(v, c, valid) over a row (row[c]: column c, staged or in x), every
// thread of the block calling f equally often: the 16-byte body [h, h +
// 4 nv) a float4 a thread (v holds columns c..c + 3), then the head [0,
// h) and the tail [h + 4 nv, V), fewer than 8 columns, a column a thread
// (in v.x); valid: the bits of v that hold a column
template <class F>
__device__ __forceinline__ void each_quad(const float* row, int h, int nv, int V, F&& f) {
  const float4* body = reinterpret_cast<const float4*>(row + h);
  for (int q0 = 0; q0 < nv; q0 += SEL_THREADS) {
    const int q = q0 + static_cast<int>(threadIdx.x);
    const bool ok = q < nv;
    f(ok ? body[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f), h + 4 * q, ok ? 0xfu : 0u);
  }
  const int e = edge_of(h, nv, V);
  const bool ok = e < V;
  f(make_float4(ok ? row[e] : 0.0f, 0.0f, 0.0f, 0.0f), e, ok ? 1u : 0u);
}

// body(v, c) for each float4 of the row's 16-byte body that is this
// thread's (columns c..c + 3), then edge(v, c) for its head or tail column
// if it has one: the lanes of a warp need not call them alike
template <class Body, class Edge>
__device__ __forceinline__ void each_own(const float* row, int h, int nv, int V, Body&& body,
                                         Edge&& edge) {
  const float4* b4 = reinterpret_cast<const float4*>(row + h);
  for (int q = threadIdx.x; q < nv; q += SEL_THREADS) body(b4[q], h + 4 * q);
  const int e = edge_of(h, nv, V);
  if (e < V) edge(row[e], e);
}

// the largest of a, b, NaN where either is (max.NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

// one more key in bin `bin` of the histogram, where ok; every lane of the
// warp calls it
__device__ __forceinline__ void count_key(uint32_t* hist, uint32_t bin, bool ok) {
  if (ok) atomicAdd(&hist[bin], 1u);
}

// e appended to list (the warp's takers by one atomic on *n, which counts
// them all), where take and while the list holds fewer than cap; every
// lane of the warp calls it
__device__ __forceinline__ void append(unsigned long long* list, int* n, int cap, bool take,
                                       unsigned long long e) {
  const unsigned m = __ballot_sync(FULL, take);
  if (m == 0) return;
  const int lane = threadIdx.x % 32, first = __ffs(m) - 1;
  int base = 0;
  if (lane == first) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(FULL, base, first);
  const int at = base + __popc(m & ((1u << lane) - 1u));
  if (take && at < cap) list[at] = e;
}

// the n distinct entries of list placed by the count of those above each
// (q threads an entry): those placed below k are the row's top k, their
// values copied from the row
__device__ __forceinline__ void place(const unsigned long long* list, int n, int k,
                                      const float* row, float* vr, int* ir) {
  const int q = min(32, SEL_THREADS / sel_pad(n));
  for (int i0 = 0; i0 < n; i0 += SEL_THREADS / q) {
    const int i = i0 + static_cast<int>(threadIdx.x) / q, part = threadIdx.x % q;
    const unsigned long long e = i < n ? list[i] : 0ull;
    int above = 0;
#pragma unroll 4
    for (int j = part; j < n; j += q) above += list[j] > e;
    for (int o = q / 2; o > 0; o >>= 1) above += __shfl_xor_sync(FULL, above, o);
    if (part == 0 && i < n && above < k) {
      const int c = sel_col(e);
      vr[above] = row[c];
      ir[above] = c;
    }
  }
}

// the block's inclusive scan of v in thread order (a barrier inside; the
// next use of sh.scan must follow another)
__device__ __forceinline__ int block_scan(int v, SelShared& sh) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
  if (lane == 31) sh.scan[warp] = v;
  __syncthreads();
  int t = lane < SEL_WARPS ? sh.scan[lane] : 0;   // the warps' totals, scanned
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, t, d);
    if (lane >= d) t += o;
  }
  return v + (warp > 0 ? __shfl_sync(FULL, t, warp - 1) : 0);
}

struct Cut {
  int bin, above, count;
};

// the bin of the histogram (nb bins) that holds the
// need-th largest key, and the keys above it and in it, in every thread:
// thread t scans the bins [nb - (t + 1) per, nb - t per), the block's
// scan of their sums finds the thread, which walks its bins down
__device__ __forceinline__ Cut find_cut(SelShared& sh, int nb, int need) {
  const int per = nb > SEL_THREADS ? nb / SEL_THREADS : 1;
  const int hi = nb - static_cast<int>(threadIdx.x) * per;
  int own = 0;
  for (int b = hi - 1; b >= max(hi - per, 0); --b) own += sh.hist[b];
  const int inc = block_scan(own, sh);
  const int ex = inc - own;
  if (ex < need && need <= inc) {
    int acc = ex;
    for (int b = hi - 1;; --b) {
      const int c = sh.hist[b];
      if (acc + c >= need) {
        sh.cut[0] = b;
        sh.cut[1] = acc;
        sh.cut[2] = c;
        break;
      }
      acc += c;
    }
  }
  __syncthreads();
  return {sh.cut[0], sh.cut[1], sh.cut[2]};
}

__device__ __forceinline__ void zero_hist(SelShared& sh) {
  for (int i = threadIdx.x; i < SEL_BINS; i += SEL_THREADS) sh.hist[i] = 0;
}

// columns [0, h) of row xr lie before its first 16-byte boundary
__device__ __forceinline__ int head_of(const float* xr, int V) {
  return min(V, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / 4);
}

// the copy of row xr's body into a stage (column c at buf[c], buf + h on
// a 16-byte boundary), completing on bar
__device__ __forceinline__ void stage_body(float* stage, uint64_t* bar, const float* xr, int V) {
  const int h = head_of(xr, V), nv = (V - h) / 4;
  float* dst = stage + ((4 - h) & 3) + h;
  mbar_expect_tx(bar, 16u * nv);
  if (nv > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(xr + h), "r"(16 * nv), "r"(smem_addr(bar)) : "memory");
}

// The row's top k where the threads' maxima give no bound, or too many
// columns reach it: a radix select on the row's keys.  The first digit
// (SEL_DIGIT bits) of every column: a histogram pass, the cut (the bin of
// the k-th key, by a scan from the top) and a pass sending the columns
// above it to the winners and those in it to the candidates (found again
// in the row where more than SEL_CAND); while the candidates outnumber the
// places left, their next digit (11 bits): histogram, cut, split; then
// either every candidate wins, or all hold one key t, whose lowest columns
// win by a block-wide count in column order (the tie rule).  The k winners
// are placed by counting those above each, or past SEL_RANK by a bitonic
// sort (in `win`: shared memory, or past SEL_WIN the block's workspace
// row), and their values copied from the row.
__device__ __forceinline__ void radix_select(SelShared& sh, const float* row, int h, int nv, int V,
                                             int k, unsigned long long* win, uint32_t* hc,
                                             float* vr, int* ir) {
  const int tid = threadIdx.x;
  int shift = 32 - SEL_DIGIT;
  each_quad(row, h, nv, V, [&](const float4& q, int, unsigned valid) {
    const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) count_key(hc, order_key(v[e]) >> shift, (valid >> e) & 1u);
  });
  __syncthreads();
  if (tid == 0) {   // every thread has read the candidates' count
    sh.win_n = 0;
    sh.cand_n[0] = 0;
  }
  Cut cut = find_cut(sh, 1 << SEL_DIGIT, k);
  zero_hist(sh);
  bool listed = cut.count <= SEL_CAND;
  uint32_t prefix = cut.bin;
  each_quad(row, h, nv, V, [&](const float4& q, int c, unsigned valid) {
    const float v[4] = {q.x, q.y, q.z, q.w};
    uint32_t key[4];
    bool any = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      key[e] = order_key(v[e]);
      any |= ((valid >> e) & 1u) && (key[e] >> shift) >= prefix;
    }
    if (!__any_sync(FULL, any)) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = (valid >> e) & 1u;
      const uint32_t d = key[e] >> shift;
      append(win, &sh.win_n, k, ok && d > prefix, sel_entry(key[e], c + e));
      append(sh.cand[0], &sh.cand_n[0], SEL_CAND, ok && listed && d == prefix,
             sel_entry(key[e], c + e));
    }
  });
  __syncthreads();
  int need = k - cut.above, C = cut.count, cur = 0;

  // the next digits of the candidates, while they outnumber the places
  while (need < C && shift > 0) {
    const int w = min(11, shift), s2 = shift - w;
    const uint32_t mask = (1u << w) - 1u;
    if (tid == 0) sh.cand_n[cur ^ 1] = 0;
    if (listed) {
      for (int i0 = 0; i0 < C; i0 += SEL_THREADS) {
        const int i = i0 + tid;
        const uint32_t key = i < C ? static_cast<uint32_t>(sh.cand[cur][i] >> 32) : 0u;
        count_key(hc, (key >> s2) & mask, i < C);
      }
    } else {
      each_quad(row, h, nv, V, [&](const float4& q, int, unsigned valid) {
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = order_key(v[e]);
          count_key(hc, (key >> s2) & mask, ((valid >> e) & 1u) && (key >> shift) == prefix);
        }
      });
    }
    __syncthreads();
    cut = find_cut(sh, 1 << w, need);
    zero_hist(sh);
    const bool keep = cut.count <= SEL_CAND;
    unsigned long long* next = sh.cand[cur ^ 1];
    if (listed) {
      for (int i0 = 0; i0 < C; i0 += SEL_THREADS) {
        const int i = i0 + tid;
        const unsigned long long e = i < C ? sh.cand[cur][i] : 0ull;
        const uint32_t d = (static_cast<uint32_t>(e >> 32) >> s2) & mask;
        append(win, &sh.win_n, k, i < C && d > cut.bin, e);
        append(next, &sh.cand_n[cur ^ 1], SEL_CAND, i < C && keep && d == cut.bin, e);
      }
    } else {
      each_quad(row, h, nv, V, [&](const float4& q, int c, unsigned valid) {
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = order_key(v[e]), d = (key >> s2) & mask;
          const bool ok = ((valid >> e) & 1u) && (key >> shift) == prefix;
          append(win, &sh.win_n, k, ok && d > cut.bin, sel_entry(key, c + e));
          append(next, &sh.cand_n[cur ^ 1], SEL_CAND, ok && keep && d == cut.bin,
                 sel_entry(key, c + e));
        }
      });
    }
    __syncthreads();
    need -= cut.above;
    C = cut.count;
    prefix = (prefix << w) | cut.bin;
    shift = s2;
    cur ^= 1;
    listed = keep;
  }

  // the last places: every candidate, or the lowest columns of one key
  if (need == C) {
    if (listed) {
      for (int i0 = 0; i0 < C; i0 += SEL_THREADS) {
        const int i = i0 + tid;
        append(win, &sh.win_n, k, i < C, i < C ? sh.cand[cur][i] : 0ull);
      }
    } else {
      each_quad(row, h, nv, V, [&](const float4& q, int c, unsigned valid) {
        const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = order_key(v[e]);
          append(win, &sh.win_n, k, ((valid >> e) & 1u) && (key >> shift) == prefix,
                 sel_entry(key, c + e));
        }
      });
    }
  } else {   // shift == 0: C columns hold the key `prefix`, the first `need` win
    const int seg = ((V + SEL_THREADS - 1) / SEL_THREADS) | 1;
    const int c0 = min(V, tid * seg), c1 = min(V, c0 + seg);
    int own = 0;
    for (int c = c0; c < c1; ++c) own += order_key(row[c]) == prefix;
    const int base = sh.win_n;
    int rank = block_scan(own, sh) - own;
    for (int c = c0; c < c1 && rank < need; ++c)
      if (order_key(row[c]) == prefix) win[base + rank++] = sel_entry(prefix, c);
  }
  __syncthreads();

  // the k winners in order
  if (k <= SEL_RANK) {
    place(win, k, k, row, vr, ir);
    return;
  }
  const int n = sel_pad(k);
  for (int i = k + tid; i < n; i += SEL_THREADS) win[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = tid; t < n / 2; t += SEL_THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const unsigned long long a = win[lo], b = win[lo + stride];
        if ((a < b) == ((lo & size) == 0)) {
          win[lo] = b;
          win[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  for (int j = tid; j < k; j += SEL_THREADS) {
    const int c = sel_col(win[j]);
    vr[j] = row[c];
    ir[j] = c;
  }
}

// The C candidates in sh.cand[0] (every column at or above lo; m the row's
// max), counting-sorted into sh.cand[1] by SEL_THREADS bins of their value
// over [lo, m] (the bin monotone in the value, NaN in the top one; one bin
// where the span is 0 or not finite), the bins in descending order: an
// entry's place is the count of the candidates in the bins above its own
// and of those above it in its bin.  The first k places are the row's top
// k, their values copied from the row.  The caller zeroes the counts and
// ends (sh.hist[0, 2 SEL_THREADS)) once every thread is past them.
__device__ __forceinline__ void bin_place(SelShared& sh, int C, int k, float lo, float m,
                                          const float* row, float* vr, int* ir) {
  constexpr int B = SEL_THREADS;
  static_assert(2 * B <= SEL_BINS, "the bins' counts and ends share the histogram");
  uint32_t* count = sh.hist;
  uint32_t* end = sh.hist + B;
  const int tid = threadIdx.x;
  const float scale = m > lo && m - lo < INFINITY ? B / (m - lo) : 0.0f;
  const auto bin_of = [&](unsigned long long e) {
    const float v = key_value(static_cast<uint32_t>(e >> 32));
    if (v != v) return B - 1;
    const float f = (v - lo) * scale;
    return f >= B - 1 ? B - 1 : f > 0.0f ? static_cast<int>(f) : 0;
  };
  for (int i = tid; i < C; i += B) atomicAdd(&count[bin_of(sh.cand[0][i])], 1u);
  __syncthreads();
  // thread t: bin B - 1 - t, after the candidates of the bins above it
  const int own = count[B - 1 - tid];
  end[B - 1 - tid] = block_scan(own, sh) - own;
  __syncthreads();
  for (int i = tid; i < C; i += B) {
    const unsigned long long e = sh.cand[0][i];
    sh.cand[1][atomicAdd(&end[bin_of(e)], 1u)] = e;
  }
  __syncthreads();
  for (int i = tid; i < C; i += B) {
    const unsigned long long e = sh.cand[1][i];
    const int b = bin_of(e), last = end[b], first = last - static_cast<int>(count[b]);
    if (first >= k) continue;
    int at = first;
    for (int j = first; j < last; ++j) at += sh.cand[1][j] > e;
    if (at < k) {
      const int c = sel_col(e);
      vr[at] = row[c];
      ir[at] = c;
    }
  }
}

// Rows r, r + gridDim.x, .. of x, one a block.  STAGED: each row's body
// lands in shared memory by one bulk copy, SEL_STAGES rows a block, its
// head and tail loaded by their threads a row ahead; else every pass
// reads x.  A row:
//   1. one pass: the row's max, and each thread's of its columns;
//   2. a bound on the k-th value from below: each warp's j-th largest of
//      its lanes' maxima (j = ceil(k / SEL_WARPS): j rounds of a warp-wide
//      max of their keys, redux.sync, its lane dropping out), and the
//      least of those, lo (j columns of every warp reach it);
//   3. one pass: the sum of exp(x - max), and the columns at or above lo
//      (two to three times k of them) to the candidates;
//   4. the candidates placed among themselves (bin_place), the first k
//      written; or, where there is no bound (k past 8 SEL_WARPS, where the
//      candidates would overflow SEL_CAND: 128 at 512 threads) or they
//      overflow SEL_CAND (ties, a narrow row, a long list), the radix
//      select on the row (radix_select).
// work: a workspace row of sel_pad(k) entries a block where k > SEL_WIN.
template <bool STAGED>
__global__ void __launch_bounds__(SEL_THREADS, SEL_MIN_BLOCKS)
topk_select_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
                   float* __restrict__ lse, unsigned long long* __restrict__ work, int N, int V,
                   int pitch, int k) {
  extern __shared__ __align__(16) unsigned char sel_raw[];
  SelShared& sh = *reinterpret_cast<SelShared*>(sel_raw);
  float* stage = reinterpret_cast<float*>(sel_raw + sizeof(SelShared));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x, rf = sel_row_floats(V);
  unsigned long long* win =
      work ? work + static_cast<size_t>(blockIdx.x) * sel_pad(k) : sh.win;
  uint32_t* hc = sh.hist;
  zero_hist(sh);
  // a row's head or tail column for this thread (V or past where none),
  // its value loaded a row ahead
  auto edge_col = [&](const float* xr) {
    const int h = head_of(xr, V);
    return edge_of(h, (V - h) / 4, V);
  };
  // edge[s]: the value of row it + s's (head or tail) column of this thread
  float edge[SEL_STAGES];
  const auto load_edge = [&](int r) {
    const float* xr = x + static_cast<size_t>(r) * pitch;
    const int ec = edge_col(xr);
    return r < N && ec < V ? xr[ec] : 0.0f;
  };
  if constexpr (STAGED) {
    if (tid == 0) {
      for (int s = 0; s < SEL_STAGES; ++s) mbar_init(&sh.bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < SEL_STAGES; ++s) {
        const int r = blockIdx.x + s * G;
        if (r < N) stage_body(stage + s * rf, &sh.bar[s], x + static_cast<size_t>(r) * pitch, V);
      }
    }
#pragma unroll
    for (int s = 0; s < SEL_STAGES; ++s) edge[s] = load_edge(blockIdx.x + s * G);
  }
  if (tid == 0) sh.cand_n[0] = 0;
  __syncthreads();

  for (int it = 0, r = blockIdx.x; r < N; ++it, r += G) {
    const float* xr = x + static_cast<size_t>(r) * pitch;
    const int h = head_of(xr, V), nv = (V - h) / 4;
    const float* row = xr;
    if constexpr (STAGED) {
      const int b = it % SEL_STAGES;
      float* buf = stage + b * rf + ((4 - h) & 3);
      const int ec = edge_col(xr);
      if (ec < V) buf[ec] = edge[0];
      mbar_wait(&sh.bar[b], (it / SEL_STAGES) & 1);
      row = buf;
    }

    // 1. the max: the block's, and each thread's of its own columns
    float mt = -INFINITY;
    each_own(row, h, nv, V,
             [&](const float4& q, int) { mt = fmaxf(mt, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w))); },
             [&](float v, int) { mt = fmaxf(mt, v); });
    float m = mt;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
    if (lane == 0) sh.red_m[warp] = m;

    // 2. the bound (a lane with no column holds key 0, below every value),
    // to k = 8 SEL_WARPS: past it the candidates outnumber SEL_CAND
    const bool bounded = k <= 8 * SEL_WARPS;
    if (bounded) {
      uint32_t km = tid < nv || edge_of(h, nv, V) < V ? order_key(mt) : 0u, kth = 0;
      for (int j = (k + SEL_WARPS - 1) / SEL_WARPS; j > 0; --j) {   // the largest, j times
        kth = __reduce_max_sync(FULL, km);
        if (lane == __ffs(__ballot_sync(FULL, km == kth)) - 1) km = 0;
      }
      if (lane == 0) sh.bound[warp] = kth;
    }
    __syncthreads();
    m = lane < SEL_WARPS ? sh.red_m[lane] : -INFINITY;
    uint32_t lo_key = bounded && lane < SEL_WARPS ? sh.bound[lane] : ~0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(FULL, m, d));
      lo_key = min(lo_key, __shfl_xor_sync(FULL, lo_key, d));
    }
    const float lo = !bounded ? INFINITY
                     : lo_key <= order_key(-INFINITY) ? -INFINITY : key_value(lo_key);

    // 3. the sum of exps; the columns at or above lo (NaN included) to the
    // candidates
    float s = 0.0f;
    const float mo = m == -INFINITY ? 0.0f : m * LOG2E;
    const auto take = [&](float v, int c) {
      const int at = atomicAdd(&sh.cand_n[0], 1);
      if (at < SEL_CAND) sh.cand[0][at] = sel_entry(order_key(v), c);
    };
    each_own(row, h, nv, V,
             [&](const float4& q, int c) {
               s += ex2(fmaf(q.x, LOG2E, -mo)) + ex2(fmaf(q.y, LOG2E, -mo)) +
                    ex2(fmaf(q.z, LOG2E, -mo)) + ex2(fmaf(q.w, LOG2E, -mo));
               if (!(max_nan(max_nan(q.x, q.y), max_nan(q.z, q.w)) < lo)) {
                 if (!(q.x < lo)) take(q.x, c);
                 if (!(q.y < lo)) take(q.y, c + 1);
                 if (!(q.z < lo)) take(q.z, c + 2);
                 if (!(q.w < lo)) take(q.w, c + 3);
               }
             },
             [&](float v, int c) {
               s += ex2(fmaf(v, LOG2E, -mo));
               if (!(v < lo)) take(v, c);
             });
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(FULL, s, d);
    if (lane == 0) sh.red_s[warp] = s;
    __syncthreads();

    // 4. the candidates in order
    float* vr = vals + static_cast<size_t>(r) * k;
    int* ir = idx + static_cast<size_t>(r) * k;
    const int C = sh.cand_n[0];
    const bool binned = bounded && C <= SEL_CAND;
    if (binned)
      bin_place(sh, C, k, lo, m, row, vr, ir);
    else
      radix_select(sh, row, h, nv, V, k, win, hc, vr, ir);
    if (warp == 0) {
      s = lane < SEL_WARPS ? sh.red_s[lane] : 0.0f;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(FULL, s, d);
      if (lane == 0) {
        lse[r] = m + logf(s);
        sh.cand_n[0] = 0;
      }
    }
    // the row and the lists are read before the next row's land (the
    // edges' stores ordered before the bulk copy that may overwrite them)
    if constexpr (STAGED) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (binned) {   // bin_place's counts and ends, read by now
      sh.hist[tid] = 0;
      sh.hist[SEL_THREADS + tid] = 0;
    }

    if constexpr (STAGED) {
      const int b = it % SEL_STAGES;
      const int rn = r + SEL_STAGES * G;
      if (tid == 0 && rn < N)
        stage_body(stage + b * rf, &sh.bar[b], x + static_cast<size_t>(rn) * pitch, V);
#pragma unroll
      for (int s = 0; s + 1 < SEL_STAGES; ++s) edge[s] = edge[s + 1];
      edge[SEL_STAGES - 1] = load_edge(rn);
    }
  }
}

bool sel_staged(int V) { return V <= SEL_STAGE_COLS; }

int sel_smem(int V) {
  return static_cast<int>(sizeof(SelShared)) +
         (sel_staged(V) ? SEL_STAGES * sel_row_floats(V) * 4 : 0);
}

// the persistent grid: as many blocks as the card holds at once, at most N;
// 0 where the launch cannot fit, < 0 a cudaError_t
int sel_grid(int N, int V, int sms) {
  static bool attr[2] = {false, false};
  const bool staged = sel_staged(V);
  const void* fn = staged ? reinterpret_cast<const void*>(topk_select_kernel<true>)
                          : reinterpret_cast<const void*>(topk_select_kernel<false>);
  if (!attr[staged]) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, sel_smem(staged ? SEL_STAGE_COLS : V)));
    if (err) return -err;
    attr[staged] = true;
  }
  static int last_smem = -1, last_blocks = 0;
  const int smem = sel_smem(V);
  if (smem != last_smem) {
    int blocks = 0;
    const int err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, SEL_THREADS, smem));
    if (err) return -err;
    last_smem = smem;
    last_blocks = blocks;
  }
  return static_cast<int>(min(static_cast<long long>(N), 1LL * sms * last_blocks));
}

}  // namespace

// the longest warp list: 1 entry a lane (ops/topk_lse.py: K_LIST)
#define VCT_TOPK_LSE_K_MAX 32

// x [N,V] f32 in rows of `pitch` floats (pitch >= V); vals [N,k] f32, idx
// [N,k] int32, lse [N] f32, 1 <= k <= min(V, 32); sms: the card's
// streaming multiprocessors.  Returns a cudaError_t as int.
extern "C" int vct_top_k_logsumexp(const void* x, void* vals, void* idx,
                                   void* lse, int N, int V, int pitch, int k, int sms,
                                   void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || pitch < V || sms <= 0 || k < 1 || k > VCT_TOPK_LSE_K_MAX || k > V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(idx);
  float* lp = static_cast<float*>(lse);
  const int grid = min((N + WARPS - 1) / WARPS, sms * BLOCKS_PER_SM);
#define VCT_CASE(KK)                                                           \
  case KK:                                                                     \
    topk_lse_kernel<KK, 1><<<grid, THREADS, 0, s>>>(xp, vp, ip, lp, N, V, pitch, k); \
    break;
  switch (k) {
    VCT_CASE(1) VCT_CASE(2) VCT_CASE(3) VCT_CASE(4)
    VCT_CASE(5) VCT_CASE(6) VCT_CASE(7) VCT_CASE(8)
    VCT_CASE(9) VCT_CASE(10) VCT_CASE(11) VCT_CASE(12)
    VCT_CASE(13) VCT_CASE(14) VCT_CASE(15) VCT_CASE(16)
    default:
      topk_lse_kernel<0, 1><<<grid, THREADS, 0, s>>>(xp, vp, ip, lp, N, V, pitch, k);
  }
#undef VCT_CASE
  return static_cast<int>(cudaGetLastError());
}

// The workspace bytes of vct_top_k_logsumexp_select at (N, V, k): 0 where
// a row's winners fit shared memory (k <= 512); -1 past 2^31 bytes; < -1
// a cudaError_t, negated.
extern "C" int vct_top_k_logsumexp_select_workspace(int N, int V, int k, int sms) {
  if (N <= 0 || k <= SEL_WIN) return 0;
  const int grid = sel_grid(N, V, sms);
  if (grid < 0) return grid - 1;
  const long long bytes = 8LL * grid * sel_pad(k);
  return bytes > 0x7fffffffLL ? -1 : static_cast<int>(bytes);
}

// The dynamic shared memory of the select's block at V (rows staged to
// 16,384 columns).
extern "C" int vct_top_k_logsumexp_select_smem(int V) { return sel_smem(V); }

// Lists of any length, 1 <= k <= V (the wrapper takes it past 32): x,
// pitch, vals, idx, lse as vct_top_k_logsumexp; work:
// vct_top_k_logsumexp_select_workspace bytes (null where that is 0).
// Returns a cudaError_t as int.
extern "C" int vct_top_k_logsumexp_select(const void* x, void* vals, void* idx, void* lse,
                                          void* work, int N, int V, int pitch, int k, int sms,
                                          void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || pitch < V || sms <= 0 || k < 1 || k > V || (k > SEL_WIN && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = sel_grid(N, V, sms);
  if (grid < 0) return -grid;
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = sel_staged(V) ? topk_select_kernel<true> : topk_select_kernel<false>;
  kernel<<<grid, SEL_THREADS, sel_smem(V), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), k > SEL_WIN ? static_cast<unsigned long long*>(work) : nullptr,
      N, V, pitch, k);
  return static_cast<int>(cudaGetLastError());
}
