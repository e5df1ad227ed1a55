// K2: backward of the front-to-back alpha blend (K1, blend_fwd.cu).
//
// Replaces luciddreamer_tpu/render/pallas_blend.py::_bwd_kernel and
// _bwd_chunk_body (launched by _bwd_call).  The Pallas kernel walks the
// (chunk, tile) segments in order on one TPU core, carrying each tile's
// running T, done latch and prefix sum in VMEM scratch between grid steps.
// Here, as in K1, one thread block owns one 16x16 tile for its whole range
// and one thread owns one pixel:
//
//   * the block walks the tile's [start, end) rows front to back in
//     shared-memory batches of 128 rows;
//   * each thread recomputes power, alpha, the skip tests, T and the done
//     latch with exactly K1's arithmetic (same operation order, built with
//     -fmad=false), so its committed set is bit-identical to the forward's;
//   * the suffix sum_{j>i} w_j q_j comes from the saved totals minus a
//     running prefix (pallas_blend.py:272-307): q = g_rgb . rgb + g_d depth
//     + g_acc, total = g_rgb . C + g_d D + g_acc (acc - 1e-6), and
//     dalpha = T_before q - (suffix + g_T T_final) / (1 - alpha), with the
//     0.99 clamp straight-through (dpower = op * G * dalpha);
//   * each pair's 10 gradient values (x, y, conic a/b/c, opacity, r, g, b,
//     depth) are sums over the tile's 256 pixels.  A pair row belongs to one
//     tile only, so no global atomics are needed: every warp reduces with
//     shuffles in a fixed order, lane 0 parks the warp's partial in shared
//     memory, and after the batch one thread per row adds the 8 partials in
//     warp order.  The gradient is deterministic;
//   * the block leaves its range once every pixel is done, like K1.  The
//     output is zero-filled first (one memset of the whole (pair_cap, 16)
//     buffer, enqueued by the launcher on the same stream and so part of K2's
//     time), so rows after the latch, columns 10-15 and rows at or past
//     num_pairs read as zero.
//
// This is the front-to-back form of pallas_blend.py, not the back-to-front
// T / (1 - alpha) unwind from n_contrib of the original CUDA rasterizer.
//
// What bounds it on the card: it re-reads each live pair's 44 used bytes,
// reads 6 saved state rows and 6 cotangent rows per pixel and writes 40
// bytes per live pair row, against about 45M (pair, pixel) products at the
// 1M-Gaussian 512x512 frame, each committed one some 50 fp32 operations
// plus its share of 10 reductions.  Compared with K1 it adds the per-row
// warp reductions; a warp whose 32 pixels all skip a pair writes a zero
// partial without shuffling.  Simple and right first: no cp.async/TMA
// double buffering, no splitting of long tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 128;           // rows staged per batch
constexpr int kAttrDim = 16;
constexpr int kStateRows = 7;         // T, r, g, b, depth, acc, done
constexpr int kGradCh = 10;           // x y ca cb cc op r g b depth
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1.0e-4f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix)
blend_bwd_kernel(const float* __restrict__ attrs,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end,
                 int grid_x,
                 const float* __restrict__ state,
                 const float* __restrict__ d_state,
                 float* __restrict__ d_attrs) {
  __shared__ float s_x[kBatch], s_y[kBatch];
  __shared__ float s_ca[kBatch], s_cb[kBatch], s_cc[kBatch], s_op[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_b[kBatch], s_d[kBatch];
  __shared__ float s_valid[kBatch];
  __shared__ float s_part[kWarps][kBatch][kGradCh];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = static_cast<float>((tile % grid_x) * kTile + p % kTile);
  const float py = static_cast<float>((tile / grid_x) * kTile + p / kTile);
  const int start = tile_start[tile];
  const int end = tile_end[tile];

  const size_t off = static_cast<size_t>(tile) * kStateRows * kPix + p;
  const float* st = state + off;
  const float* ds = d_state + off;
  const float t_fin = st[0];
  const float g_t = ds[0 * kPix];
  const float g_r = ds[1 * kPix];
  const float g_g = ds[2 * kPix];
  const float g_b = ds[3 * kPix];
  const float g_d = ds[4 * kPix];
  const float g_acc = ds[5 * kPix];
  // sum over the committed pairs of w * q, from the saved outputs
  const float wq_total = g_r * st[1 * kPix] + g_g * st[2 * kPix] +
                         g_b * st[3 * kPix] + g_d * st[4 * kPix] +
                         g_acc * (st[5 * kPix] - 1e-6f);
  const float gt_tfin = g_t * t_fin;

  float T = 1.0f, wq_run = 0.0f;
  bool done = false;

  for (int base = start; base < end; base += kBatch) {
    // whole-tile early exit; also the barrier before the batch's shared
    // memory is overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int row = base + p;
    if (p < kBatch && row < end) {
      const float4* src =
          reinterpret_cast<const float4*>(attrs + static_cast<size_t>(row) * kAttrDim);
      const float4 a0 = src[0], a1 = src[1], a2 = src[2];
      s_x[p] = a0.x;  s_y[p] = a0.y;  s_ca[p] = a0.z; s_cb[p] = a0.w;
      s_cc[p] = a1.x; s_op[p] = a1.y; s_r[p] = a1.z;  s_g[p] = a1.w;
      s_b[p] = a2.x;  s_d[p] = a2.y;  s_valid[p] = a2.z;
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      float v[kGradCh];
#pragma unroll
      for (int c = 0; c < kGradCh; ++c) v[c] = 0.0f;
      bool hit = false;
      if (!done && s_valid[j] > 0.5f) {
        const float dx = s_x[j] - px;
        const float dy = s_y[j] - py;
        const float power =
            -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha_raw = s_op[j] * G;
          const float alpha = alpha_raw > kAlphaClamp ? kAlphaClamp : alpha_raw;
          if (alpha >= kAlphaMin) {
            const float test_T = T * (1.0f - alpha);
            if (test_T < kTMin) {
              done = true;        // the latching pair is not committed
            } else {
              hit = true;
              const float w = alpha * T;
              const float q = g_r * s_r[j] + g_g * s_g[j] + g_b * s_b[j] +
                              g_d * s_d[j] + g_acc;
              wq_run += w * q;
              const float suffix = wq_total - wq_run;
              const float inv1ma = 1.0f / (1.0f - alpha);
              const float dalpha = T * q - (suffix + gt_tfin) * inv1ma;
              const float dpower = alpha_raw * dalpha;
              v[0] = dpower * -(s_ca[j] * dx + s_cb[j] * dy);
              v[1] = dpower * -(s_cc[j] * dy + s_cb[j] * dx);
              v[2] = dpower * (-0.5f * dx * dx);
              v[3] = dpower * (-dx * dy);
              v[4] = dpower * (-0.5f * dy * dy);
              v[5] = G * dalpha;
              v[6] = w * g_r;
              v[7] = w * g_g;
              v[8] = w * g_b;
              v[9] = w * g_d;
              T = test_T;
            }
          }
        }
      }
      if (__any_sync(kFull, hit)) {
#pragma unroll
        for (int c = 0; c < kGradCh; ++c) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v[c] += __shfl_down_sync(kFull, v[c], o);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kGradCh; ++c) s_part[warp][j][c] = v[c];
      }
    }
    __syncthreads();
    if (p < n) {
      float sum[kGradCh];
#pragma unroll
      for (int c = 0; c < kGradCh; ++c) sum[c] = s_part[0][p][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
#pragma unroll
        for (int c = 0; c < kGradCh; ++c) sum[c] += s_part[w][p][c];
      }
      float2* dst = reinterpret_cast<float2*>(
          d_attrs + static_cast<size_t>(base + p) * kAttrDim);
#pragma unroll
      for (int c = 0; c < kGradCh; c += 2) dst[c / 2] = make_float2(sum[c], sum[c + 1]);
    }
  }
}

}  // namespace

// attrs (pair_cap, 16) f32; tile_start/tile_end (num_tiles,) int32;
// state and d_state (num_tiles, 7, 256) f32; d_attrs (pair_cap, 16) f32.
// Zero-fills d_attrs and launches on ``stream``; returns cudaGetLastError().
extern "C" int blend_bwd(const float* attrs, const int* tile_start,
                         const int* tile_end, const float* state,
                         const float* d_state, float* d_attrs,
                         long long pair_cap, int num_tiles, int grid_x,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      d_attrs, 0, static_cast<size_t>(pair_cap) * kAttrDim * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, kPix, 0, s>>>(
        attrs, tile_start, tile_end, grid_x, state, d_state, d_attrs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
