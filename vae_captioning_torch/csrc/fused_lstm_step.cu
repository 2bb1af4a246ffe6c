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
// design cuts what the blocks re-read and keeps the gates on chip.
//
// The kernel is lstm_cell.cuh's lstm_cell_kernel<U, StepEpi> (wgmma + TMA;
// the header's note says how it is laid out and why), the product loop
// that the sequence forward (fused_lstm_seq.cu) shares.  Here the block
// converts its f32 h rows to bf16 (A resident), W is one [E + H, 4H]
// matrix (its map passed for both weight maps, the h part from row E), and
// the epilogue writes c' and h' from registers.
// ops/fused_lstm_step.py's lstm_step_plan picks U: 32 where the grid at U
// = 64 would fill under half the SMs, else 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cell.cuh"

namespace {

// the decode step's epilogue: c' and h' [N, H] f32
struct StepEpi {
  static constexpr bool STREAM_A = false;
  const float* h;        // [N, H] f32, converted into A
  const float* c;        // [N, H] f32
  const float* b;        // [4H] f32
  float* c_out;
  float* h_out;
  float forget_bias;

  __device__ __forceinline__ void store(int, size_t o, int, const float2 (&)[4],
                                        float2, float2 nc, float2 nh) const {
    *reinterpret_cast<float2*>(&c_out[o]) = nc;
    *reinterpret_cast<float2*>(&h_out[o]) = nh;
  }
};

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
  const CellLayout lay = cell_layout<U>(E, H);
  err = allow_cell_smem<U, StepEpi>(lay.smem);
  if (err) return err;
  const StepEpi epi{static_cast<const float*>(h), static_cast<const float*>(c),
                    static_cast<const float*>(b), static_cast<float*>(c_out),
                    static_cast<float*>(h_out), forget_bias};
  const CellGeometry geo{N, E, H, 0, 0, E, lay.chunk_boxes, lay.stages};
  const dim3 grid((N + CELL_ROWS - 1) / CELL_ROWS, (H + 2 * U - 1) / (2 * U));
  // the h map is not read (A resident): x's map stands in
  lstm_cell_kernel<U, StepEpi><<<grid, CellShape<U, false>::THREADS, lay.smem, st>>>(
      xc.map, wc.map, wc.map, xc.map, epi, geo);
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
  const CellLayout lay =
      units == 64 ? cell_layout<64>(E, H) : cell_layout<32>(E, H);
  *chunk_boxes = lay.chunk_boxes;
  *stages = lay.stages;
  return static_cast<int>(lay.smem);
}
