// K1: forward front-to-back alpha blend of the depth-sorted pair stream.
//
// Replaces luciddreamer_tpu/render/pallas_blend.py::_fwd_kernel (launched
// by _fwd_call).  The Pallas kernel walks a grid of (chunk, tile) segments
// in order on one TPU core over a stream of attribute rows that binning
// copied into (tile, depth) order, and keeps each tile's state block
// resident in VMEM between segments.  Hopper runs blocks in parallel and in
// no order, so here one thread block owns one 16x16 tile for its whole
// range and one thread owns one pixel; and no stream-order copy exists:
// row i of the stream is table[src[i]], read through the pair sort's owner
// index straight from the (P+1, 16) attribute table.
//
// Per pixel, the arithmetic is the plain version's, operation for
// operation: skip a pair if it is invalid, power > 0 or alpha < 1/255;
// test_T = T * (1 - alpha); if test_T < 1e-4 latch done without
// committing, else add w = alpha * T to r, g, b, depth and acc (seeded at
// 1e-6) and set T = test_T.  n_contrib is 1 + the position within the
// tile's range of the last committed pair (skipped pairs counted), as in
// pallas_blend.py:200-205.  Built with -fmad=false and without fast-math
// intrinsics: K2 (blend_bwd.cu) re-derives this committed set, pair by
// pair, and depends on it being bit-exact.
//
// What bounds it on the card: a tile stops as soon as every one of its
// pixels is done, at the 1M-Gaussian 512x512 frame after about a tenth of
// its range (PERF.md), so it needs only the rows it walks (44 used bytes
// and a 4-byte src entry each) and 32 B of state per pixel; by the
// published peaks the operations on them take longer than those bytes.
// The time goes to issuing the sequential per-pixel walk and to the
// latency of the loads it does make.  The design:
//
//   * Rows through the owner index (pair_rows.cuh).  Each staged 16-byte
//     piece of a row is copied by one thread: it reads src[row] and issues
//     a cp.async of 16 bytes from table + src * 16.  A Gaussian's row is
//     read once for each tile whose walk reaches it; the rows a tile never
//     walks are never read, where a stream-order copy wrote and read all
//     pair_cap of them.
//   * Two cp.async stages of 64 rows.  While batch b is walked, batch b+1's
//     row copies are in flight and batch b+2's src entries are being loaded
//     into registers, so that both hops of the indirection overlap the
//     walk.  The barrier before each batch is also the whole-tile early
//     exit, taken once every pixel is done: a tile stages at most two
//     batches beyond its walk.
//   * Rows read back from shared memory as three 16-byte broadcast loads,
//     all issued before the first test.
//   * A warp takes an 8x4 block of the tile's pixels, not a 16x2 strip: a
//     round splat then touches fewer warps, and a warp's lanes finish
//     closer together.
//   * Each pixel's state stays in registers and is written once, with
//     n_contrib, in the (tile, 7, 256) and (tile, 256) layouts, pixel
//     y * 16 + x; no trash tile.
//   * 32 registers a thread, so that 8 blocks fit on an SM.
//
// Each choice was timed against its alternative (PERF.md): 32-row and
// 128-row batches, three stages, 16x2 strips and 6 blocks per SM were
// slower; a warp-uniform test that skips rows whose alpha >= 1/255
// ellipse misses the warp's block gained nothing at 8 blocks per SM and
// was not kept.
//
// Long tiles are not split: the longest walk bounds the launch.

#include <cuda_runtime.h>

#include "pair_rows.cuh"

namespace {

using pair_rows::kRowVec;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kBatch = 64;            // rows staged per batch
constexpr int kStages = 2;
constexpr int kStateRows = 7;         // T, r, g, b, depth, acc, done
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1.0e-4f;

// 8 blocks per SM: the SMs then hold all 1,024 tiles of a 512x512 frame at
// once (ptxas left alone takes 38 registers, which allows 6)
__global__ void __launch_bounds__(kPix, 8)
blend_fwd_kernel(const float* __restrict__ table,
                 const int* __restrict__ src,
                 int n_rows,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end,
                 int grid_x,
                 float* __restrict__ state,
                 int* __restrict__ n_contrib) {
  __shared__ float4 s_rows[kStages][kBatch][kRowVec];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const float px = static_cast<float>((tile % grid_x) * kTile + tx);
  const float py = static_cast<float>((tile / grid_x) * kTile + ty);
  const int start = tile_start[tile];
  const int end = tile_end[tile];
  const int num_batches = (end - start + kBatch - 1) / kBatch;

  const pair_rows::Stager<kBatch, kPix> rows(table, src, n_rows, start, end, p);
  int next = rows.row_of(0);   // src entries are loaded a batch ahead
  if (num_batches > 0) rows.stage(s_rows[0], next);
  next = rows.row_of(1);

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f, acc = 1e-6f;
  int nc = 0;
  bool done = false;

  for (int bt = 0; bt < num_batches; ++bt) {
    // this thread's copies of batch bt have landed; after the barrier,
    // everyone's have, the walk of batch bt-1 is over and its stage is free
    pair_rows::cp_async_wait_all();
    if (__syncthreads_count(!done) == 0) break;   // whole-tile early exit
    if (bt + 1 < num_batches) {
      rows.stage(s_rows[(bt + 1) & 1], next);
      next = rows.row_of(bt + 2);
    }
    if (done) continue;
    const int base = start + bt * kBatch;
    const int n = min(kBatch, end - base);
    const float4* cur = &s_rows[bt & 1][0][0];
    for (int j = 0; j < n; ++j, cur += kRowVec) {
      // x, y, conic a, conic b | conic c, opacity, r, g | b, depth, valid
      const float4 a0 = cur[0], a1 = cur[1], a2 = cur[2];
      if (!(a2.z > 0.5f)) continue;
      const float dx = a0.x - px;
      const float dy = a0.y - py;
      const float power =
          -0.5f * (a0.z * dx * dx + a1.x * dy * dy) - a0.w * dx * dy;
      if (!(power <= 0.0f)) continue;
      float alpha = a1.y * expf(power);
      alpha = alpha > kAlphaClamp ? kAlphaClamp : alpha;   // NaN stays NaN
      if (!(alpha >= kAlphaMin)) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTMin) {
        done = true;
        break;
      }
      const float w = alpha * T;
      r += w * a1.z;
      g += w * a1.w;
      b += w * a2.x;
      d += w * a2.y;
      acc += w;
      T = test_T;
      nc = base - start + j + 1;
    }
  }

  const int pix = ty * kTile + tx;
  float* st = state + static_cast<size_t>(tile) * kStateRows * kPix + pix;
  st[0 * kPix] = T;
  st[1 * kPix] = r;
  st[2 * kPix] = g;
  st[3 * kPix] = b;
  st[4 * kPix] = d;
  st[5 * kPix] = acc;
  st[6 * kPix] = done ? 1.0f : 0.0f;
  n_contrib[static_cast<size_t>(tile) * kPix + pix] = nc;
}

}  // namespace

// table (n_rows, 16) f32; src (pair_cap,) int32, row i of the stream being
// table[src[i]]; tile_start/tile_end (num_tiles,) int32; state
// (num_tiles, 7, 256) f32; n_contrib (num_tiles, 256) int32.
// Launches on ``stream``; returns cudaGetLastError().
extern "C" int blend_fwd(const float* table, const int* src,
                         const int* tile_start, const int* tile_end,
                         float* state, int* n_contrib, int n_rows,
                         int num_tiles, int grid_x, void* stream) {
  if (num_tiles > 0) {
    blend_fwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        table, src, n_rows, tile_start, tile_end, grid_x, state, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
