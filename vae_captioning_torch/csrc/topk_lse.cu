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
// x [N,V] f32 -> vals [N,k] f32, idx [N,k] int32, lse [N] f32, for
// 1 <= k <= V.  Values are copied, never computed, so vals and idx equal
// a stable sort's prefix bit for bit; only lse differs from the plain
// version, by sum order.  Up to k = 64 (the warp lists) a row needs at
// least k values above -inf.
//
// What bounds it on this card: reading x once (70.7 MB at N = 1536, V =
// 11500: 21 us at 3.35 TB/s; 235 MB, 70 us, at N = 5120).  The TPU kernel
// makes k extraction passes over 8 rows held in VMEM; here a warp streams
// a row once.  The design, against what held the first port (one 256-thread
// block a row, scalar loads, an expf a value, one thread merging):
//
// * Bytes in flight: 16-byte loads (ld.global.cs), with a scalar head of
//   0-3 values up to the first 16-byte boundary (a row of 11519 floats
//   starts at any 4-byte offset) and a scalar tail.  A lane loads U = 8
//   float4 a chunk (4 KB a warp) into one of two register buffers while it
//   folds the other, so its loads stay outstanding through the arithmetic.
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
// * Lists past 16 (beams of 17 and more): k is a run-time value, and a
//   lane holds S entries, entry j in slot j / 32 of lane j % 32 (S = 1 up
//   to k = 32, then 2 up to 64, the widest beam a decode path runs, 40).
//   An insert counts its position over the S slots and shifts each slot
//   by one lane, lane 0 taking lane 31 of the slot above.  Past 32 entries
//   the lanes' maxima cannot bound the k-th value, so while the list is
//   not full every value of a chunk is a candidate.  Lists of 16 or fewer
//   keep their compile-time instances.
// * Lists past 64 (no beam search of the repository runs them): one
//   1024-thread block a row sorts the row's keys (value descending, then
//   index ascending, in one 64-bit word) by a bitonic sort, in shared
//   memory up to 16,384 columns (128 KB) and past that in a global
//   workspace row of the block's own, and copies the first k values from
//   x by their indices.  Simple and exact; it reads the row twice and
//   sorts all of it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
                int* __restrict__ idx, float* __restrict__ lse, int N, int V, int k) {
  __shared__ float4 stage[WARPS][CHUNK];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int row = warp * gridDim.x + blockIdx.x; row < N; row += gridDim.x * WARPS) {
    const float* xr = x + static_cast<size_t>(row) * V;
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
                 int k, int n_pad) {
  extern __shared__ unsigned long long skey[];
  __shared__ float red[SORT_THREADS / 32];
  unsigned long long* key = work ? work + static_cast<size_t>(blockIdx.x) * n_pad : skey;
  const int tid = threadIdx.x;
  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const float* xr = x + static_cast<size_t>(row) * V;
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

}  // namespace

// the longest warp list: 2 entries a lane (ops/topk_lse.py: K_LIST)
#define VCT_TOPK_LSE_K_MAX 64

// x [N,V] f32 contiguous; vals [N,k] f32, idx [N,k] int32, lse [N] f32,
// 1 <= k <= min(V, 64); sms: the card's streaming multiprocessors.
// Returns a cudaError_t as int.
extern "C" int vct_top_k_logsumexp(const void* x, void* vals, void* idx,
                                   void* lse, int N, int V, int k, int sms,
                                   void* stream) {
  if (N <= 0) return 0;
  if (V <= 0 || sms <= 0 || k < 1 || k > VCT_TOPK_LSE_K_MAX || k > V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(idx);
  float* lp = static_cast<float*>(lse);
  const int grid = min((N + WARPS - 1) / WARPS, sms * BLOCKS_PER_SM);
#define VCT_CASE(KK)                                                           \
  case KK:                                                                     \
    topk_lse_kernel<KK, 1><<<grid, THREADS, 0, s>>>(xp, vp, ip, lp, N, V, k); \
    break;
  switch (k) {
    VCT_CASE(1) VCT_CASE(2) VCT_CASE(3) VCT_CASE(4)
    VCT_CASE(5) VCT_CASE(6) VCT_CASE(7) VCT_CASE(8)
    VCT_CASE(9) VCT_CASE(10) VCT_CASE(11) VCT_CASE(12)
    VCT_CASE(13) VCT_CASE(14) VCT_CASE(15) VCT_CASE(16)
    default:
      if (k <= 32)
        topk_lse_kernel<0, 1><<<grid, THREADS, 0, s>>>(xp, vp, ip, lp, N, V, k);
      else
        topk_lse_kernel<0, 2><<<grid, THREADS, 0, s>>>(xp, vp, ip, lp, N, V, k);
  }
#undef VCT_CASE
  return static_cast<int>(cudaGetLastError());
}

// The workspace bytes of vct_top_k_logsumexp_sort at (N, V): 0 where a
// row's keys fit shared memory; -1 past 2^31 bytes.
extern "C" int vct_top_k_logsumexp_sort_workspace(int N, int V, int sms) {
  if (N <= 0 || V <= SORT_SMEM_COLS) return 0;
  const long long bytes = 8LL * min(N, sms) * sort_pad(V);
  return bytes > 0x7fffffffLL ? -1 : static_cast<int>(bytes);
}

// Lists of any length, 1 <= k <= V (the decode takes it past 64): x, vals,
// idx, lse as vct_top_k_logsumexp; work: vct_top_k_logsumexp_sort_workspace
// bytes (null where that is 0).  Returns a cudaError_t as int.
extern "C" int vct_top_k_logsumexp_sort(const void* x, void* vals, void* idx, void* lse,
                                        void* work, int N, int V, int k, int sms,
                                        void* stream) {
  if (N <= 0) return 0;
  const bool smem = V <= SORT_SMEM_COLS;
  if (V <= 0 || sms <= 0 || k < 1 || k > V || (!smem && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_pad = sort_pad(V);
  const int bytes = smem ? 8 * n_pad : 0;
  if (bytes > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        topk_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (err) return err;
  }
  topk_sort_kernel<<<min(N, sms), SORT_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), smem ? nullptr : static_cast<unsigned long long*>(work), N, V,
      k, n_pad);
  return static_cast<int>(cudaGetLastError());
}
