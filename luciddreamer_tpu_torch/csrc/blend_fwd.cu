// K1: forward front-to-back alpha blend of the depth-sorted pair stream.
//
// Replaces luciddreamer_tpu/render/pallas_blend.py::_fwd_kernel (launched
// by _fwd_call).  The Pallas kernel walks a grid of (chunk, tile) segments
// in order on one TPU core and keeps each tile's state block resident in
// VMEM between segments.  Hopper runs blocks in parallel and in no order, so
// here one thread block owns one 16x16 tile for its whole range and one
// thread owns one pixel:
//
//   * the block walks the tile's [start, end) rows of the sorted stream in
//     batches of 256 rows, loaded cooperatively (one row per thread, three
//     16-byte loads) into shared memory, 11 used channels of the 16;
//   * each thread runs the sequential blend for its pixel: skip a pair if
//     power > 0, alpha < 1/255 or it is invalid; test_T = T * (1 - alpha);
//     if test_T < 1e-4 latch done without committing, else add w = alpha*T
//     to r, g, b, depth and acc and set T = test_T;
//   * the block leaves its range once every pixel is done
//     (__syncthreads_count, which is also the barrier before the next batch
//     overwrites shared memory);
//   * n_contrib is 1 + the position within the tile's range of the last
//     committed pair (skipped pairs counted), as in pallas_blend.py:200-205;
//   * each tile writes its state once; no trash tile.
//
// What bounds it on the card: each pair's 44 used bytes are read once, and
// each evaluated (pair, pixel) product costs 11 fp32 operations for power,
// one expf and, when committed, 12 more.  At the 1M-Gaussian 512x512 frame
// the bytes set the floor (about 122 MB of attributes against about 45M
// products), so the design reads each row once per tile into shared memory
// and keeps the per-pixel state in registers.  The floor is not reached:
// the walk is sequential per pixel, the longest tile bounds the launch (one
// block per tile, 1024 blocks at 512x512), and a pixel that is done idles
// until its whole tile is done.  This simple form is right first;
// cp.async/TMA double buffering of the batches and splitting long tiles
// come later.
//
// Built with -fmad=false so that power, alpha and T round like the plain
// PyTorch version's separate elementwise operations.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kBatch = kPix;          // rows staged per batch, one per thread
constexpr int kAttrDim = 16;
constexpr int kStateRows = 7;         // T, r, g, b, depth, acc, done
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1.0e-4f;

__global__ void __launch_bounds__(kPix)
blend_fwd_kernel(const float* __restrict__ attrs,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end,
                 int grid_x,
                 float* __restrict__ state,
                 int* __restrict__ n_contrib) {
  __shared__ float s_x[kBatch], s_y[kBatch];
  __shared__ float s_ca[kBatch], s_cb[kBatch], s_cc[kBatch], s_op[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_b[kBatch], s_d[kBatch];
  __shared__ float s_valid[kBatch];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((tile % grid_x) * kTile + p % kTile);
  const float py = static_cast<float>((tile / grid_x) * kTile + p / kTile);
  const int start = tile_start[tile];
  const int end = tile_end[tile];

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f, acc = 1e-6f;
  int nc = 0;
  bool done = false;

  for (int base = start; base < end; base += kBatch) {
    if (__syncthreads_count(!done) == 0) break;   // whole-tile early exit
    const int row = base + p;
    if (row < end) {
      const float4* src =
          reinterpret_cast<const float4*>(attrs + static_cast<size_t>(row) * kAttrDim);
      const float4 a0 = src[0], a1 = src[1], a2 = src[2];
      s_x[p] = a0.x;  s_y[p] = a0.y;  s_ca[p] = a0.z; s_cb[p] = a0.w;
      s_cc[p] = a1.x; s_op[p] = a1.y; s_r[p] = a1.z;  s_g[p] = a1.w;
      s_b[p] = a2.x;  s_d[p] = a2.y;  s_valid[p] = a2.z;
    }
    __syncthreads();
    if (done) continue;
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      if (!(s_valid[j] > 0.5f)) continue;
      const float dx = s_x[j] - px;
      const float dy = s_y[j] - py;
      const float power =
          -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy;
      if (!(power <= 0.0f)) continue;
      float alpha = s_op[j] * expf(power);
      alpha = alpha > kAlphaClamp ? kAlphaClamp : alpha;   // NaN stays NaN
      if (!(alpha >= kAlphaMin)) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTMin) {
        done = true;
        break;
      }
      const float w = alpha * T;
      r += w * s_r[j];
      g += w * s_g[j];
      b += w * s_b[j];
      d += w * s_d[j];
      acc += w;
      T = test_T;
      nc = base - start + j + 1;
    }
  }

  float* st = state + static_cast<size_t>(tile) * kStateRows * kPix + p;
  st[0 * kPix] = T;
  st[1 * kPix] = r;
  st[2 * kPix] = g;
  st[3 * kPix] = b;
  st[4 * kPix] = d;
  st[5 * kPix] = acc;
  st[6 * kPix] = done ? 1.0f : 0.0f;
  n_contrib[static_cast<size_t>(tile) * kPix + p] = nc;
}

}  // namespace

// attrs (pair_cap, 16) f32; tile_start/tile_end (num_tiles,) int32;
// state (num_tiles, 7, 256) f32; n_contrib (num_tiles, 256) int32.
// Launches on ``stream``; returns cudaGetLastError().
extern "C" int blend_fwd(const float* attrs, const int* tile_start,
                         const int* tile_end, float* state, int* n_contrib,
                         int num_tiles, int grid_x, void* stream) {
  if (num_tiles > 0) {
    blend_fwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        attrs, tile_start, tile_end, grid_x, state, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
