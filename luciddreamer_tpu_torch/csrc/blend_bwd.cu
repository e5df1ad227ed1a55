// K2: backward of the front-to-back alpha blend (K1, blend_fwd.cu).
//
// Replaces luciddreamer_tpu/render/pallas_blend.py::_bwd_kernel and
// _bwd_chunk_body (launched by _bwd_call).  The Pallas kernel walks the
// (chunk, tile) segments in order on one TPU core, carrying each tile's
// running T, done latch and prefix sum in VMEM scratch between grid steps.
// Here, as in K1, one thread block owns one 16x16 tile for its whole range
// and one thread owns one pixel:
//
//   * the block walks the tile's [start, end) rows front to back in batches
//     of kBatch rows, and leaves its range once every pixel is done, like K1;
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
//     tile only, so no float atomics are needed and none are used: the sums
//     are taken in a fixed order and two runs give the same bits.
//
// This is the front-to-back form of pallas_blend.py, not the back-to-front
// T / (1 - alpha) unwind from n_contrib of the original CUDA rasterizer.
//
// What bounds it on the card: bytes by the published peaks (44 B and a 4-byte
// src entry read per row walked before the tile's last pixel is done, 40 B
// written per live pair, 48 B of saved state and cotangent per pixel),
// but what it spends its time on is instruction
// throughput: the walk is sequential per pixel, a tile is done after about
// a tenth of its rows, and at the 1M-Gaussian frame about a third of the
// (warp, row) pairs it walks have a
// commit, on more than half of the 32 lanes on average (PERF.md), so the
// per-pair sums across threads are the rule and not the exception.  The
// design spends as little as it can on them (PERF.md has the time of each
// choice below beside that of the alternative it was measured against):
//
//   * A warp takes an 8x4 block of the tile's pixels, not a 16x2 strip: a
//     round splat then commits in fewer warps, on more lanes of each.
//   * Sums only where something committed.  A warp takes one ballot per row.
//     No lane committed: nothing is done, nothing stored.  One lane: it
//     stores its 10 values.  Several: a halving exchange, in which each step
//     hands half of a lane's values to its partner and keeps the other half
//     (5+3+2+1+1 = 12 shuffles for 10 values instead of the 50 of a
//     butterfly per channel); the 10 totals end in 10 lanes, which store
//     them with one instruction.  The exchange adds in the order of a
//     shuffle-down butterfly, so its sums have that butterfly's bits.
//   * No dense partials.  Each warp keeps, in a register, the bit mask of
//     the batch's rows it stored a partial for, and parks it in shared
//     memory once per batch.  The finish, four threads per row, adds only
//     the partials whose bit is set, in warp order, and writes the whole
//     64-byte row as four 16-byte stores (columns 10-15 zero), so that both
//     of its sectors are written in full.
//   * Batch loads overlap the blend.  Row i of the stream is table[src[i]],
//     read through the pair sort's owner index as K1 reads it
//     (pair_rows.cuh): two stages of 64 rows (48 of each row's 64 bytes:
//     the 11 used channels) are filled with cp.async, the next batch's
//     copies in flight and the src entries of the one after it loading
//     while this one is blended; a row is then read back as three 16-byte
//     broadcast loads.  cp.async and not TMA: the rows of a batch are
//     scattered over the table, one 48-byte piece each.
//   * A small footprint.  With batches of 64 rows the block holds 30.8 KB
//     of shared memory, so that registers and not shared memory limit the
//     blocks per SM (chip_smoke.py prints what ptxas's numbers imply).
//
// The gradient terms are the plain version's, operation for operation: no
// fused multiply-adds (the build has -fmad=false for the commit arithmetic
// anyway) and the exact reciprocal of 1 - alpha.
//
// The output stays in stream order, (pair_cap, 16): row i is the gradient
// of table[src[i]], which binning's VJP (K3 and a prefix sum) sums per
// Gaussian.  Rows of a tile's range that the walk visited are written in
// full, zeros where nothing committed.  Every other row (after a tile's
// latch, outside every range, at or past num_pairs) is zero because the
// launcher zero-fills the whole (pair_cap, 16) buffer first on the same
// stream; that fill is part of K2's time, and blend_bwd_zero_fill is
// exported so that it can be timed on its own.  Long tiles are not split: a split needs K1 to save the state at
// the split points.

#include <cuda_runtime.h>

#include "pair_rows.cuh"

namespace {

using pair_rows::kAttrDim;
using pair_rows::kRowVec;

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;            // rows staged per batch, one mask bit each
constexpr int kStages = 2;
constexpr int kStateRows = 7;         // T, r, g, b, depth, acc, done
constexpr int kGradCh = 10;           // x y ca cb cc op r g b depth
constexpr int kPartStride = 12;       // a partial row, padded to 16-byte pieces
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1.0e-4f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBatch <= 64, "one 64-bit row mask per warp");

// The channel whose total the halving exchange leaves in this lane, or -1.
// Bit 4 of the lane picks channels 0-4 or 5-9; bits 3, 2, 1 split those five
// as 3|2, 2|1 and 1|1, the short side padded with zeros; bit 0 is the last,
// symmetric step, after which both lanes of a pair hold the total.
__device__ __forceinline__ int halving_channel(int lane) {
  if (lane & 1) return -1;
  const int local = (lane >> 1) & 7;          // bits 3, 2, 1
  const int base = (lane & 16) ? 5 : 0;
  if (local < 3) return base + local;
  if (local == 4 || local == 5) return base + local - 1;
  return -1;
}

// Sum v[0..9] over the warp's 32 lanes in a fixed order and store the 10
// totals to dst[0..9].  Every lane of the warp calls it.
__device__ __forceinline__ void warp_sum_store(float (&v)[kGradCh], float* dst,
                                               int lane, int out_ch) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[6], b[4], c[2];
  a[5] = 0.0f;                                // the short sides' padding
  b[3] = 0.0f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {               // 10 -> 5 | 5
    const float keep = b4 ? v[k + 5] : v[k];
    const float send = b4 ? v[k] : v[k + 5];
    a[k] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {               // 5 -> 3 | 2 and a zero
    const float keep = b3 ? a[k + 3] : a[k];
    const float send = b3 ? a[k] : a[k + 3];
    b[k] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {               // 3 -> 2 | 1 and a zero
    const float keep = b2 ? b[k + 2] : b[k];
    const float send = b2 ? b[k] : b[k + 2];
    c[k] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  float d = (b1 ? c[1] : c[0]) + __shfl_xor_sync(kFull, b1 ? c[0] : c[1], 2);
  d += __shfl_xor_sync(kFull, d, 1);
  if (out_ch >= 0) dst[out_ch] = d;
}

__global__ void __launch_bounds__(kPix)
blend_bwd_kernel(const float* __restrict__ table,
                 const int* __restrict__ src,
                 int n_rows,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end,
                 int grid_x,
                 const float* __restrict__ state,
                 const float* __restrict__ d_state,
                 float* __restrict__ d_rows) {
  __shared__ float4 s_rows[kStages][kBatch][kRowVec];
  __shared__ __align__(16) float s_part[kWarps][kBatch][kPartStride];
  __shared__ unsigned long long s_hit[kWarps];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int out_ch = halving_channel(lane);
  // the thread's pixel of the tile: a warp takes an 8x4 block of pixels and
  // not a 16x2 strip, so that a round splat commits in fewer warps
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

  const size_t off =
      static_cast<size_t>(tile) * kStateRows * kPix + ty * kTile + tx;
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

  for (int b = 0; b < num_batches; ++b) {
    // this thread's copies of batch b have landed; after the barrier,
    // everyone's have, the previous batch's finish is over and the other
    // stage is free.  The barrier is also the whole-tile early exit.
    pair_rows::cp_async_wait_all();
    if (__syncthreads_count(!done) == 0) break;
    if (b + 1 < num_batches) {
      rows.stage(s_rows[(b + 1) & 1], next);
      next = rows.row_of(b + 2);
    }
    const int base = start + b * kBatch;
    const int n = min(kBatch, end - base);
    const float4* cur = &s_rows[b & 1][0][0];   // row j of the stage
    float* dst = &s_part[warp][0][0];           // this warp's partial of row j

    unsigned long long hit_rows = 0ull;   // rows this warp stored a partial for
    if (!__all_sync(kFull, done)) {
      for (int j = 0; j < n; ++j, cur += kRowVec, dst += kPartStride) {
        // x, y, conic a, conic b | conic c, opacity, r, g | b, depth, valid
        const float4 a0 = cur[0], a1 = cur[1], a2 = cur[2];
        float v[kGradCh];
#pragma unroll
        for (int c = 0; c < kGradCh; ++c) v[c] = 0.0f;
        bool hit = false;
        if (!done) {
          const float dx = a0.x - px;
          const float dy = a0.y - py;
          const float power =
              -0.5f * (a0.z * dx * dx + a1.x * dy * dy) - a0.w * dx * dy;
          if (a2.z > 0.5f && power <= 0.0f) {
            const float G = expf(power);
            const float alpha_raw = a1.y * G;
            const float alpha = alpha_raw > kAlphaClamp ? kAlphaClamp : alpha_raw;
            if (alpha >= kAlphaMin) {
              const float test_T = T * (1.0f - alpha);
              if (test_T < kTMin) {
                done = true;        // the latching pair is not committed
              } else {
                hit = true;
                const float w = alpha * T;
                const float q = g_r * a1.z + g_g * a1.w + g_b * a2.x +
                                g_d * a2.y + g_acc;
                wq_run += w * q;
                const float suffix = wq_total - wq_run;
                const float inv1ma = 1.0f / (1.0f - alpha);
                const float dalpha = T * q - (suffix + gt_tfin) * inv1ma;
                const float dpower = alpha_raw * dalpha;
                v[0] = dpower * -(a0.z * dx + a0.w * dy);
                v[1] = dpower * -(a1.x * dy + a0.w * dx);
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
        const unsigned m = __ballot_sync(kFull, hit);
        if (m == 0u) continue;
        hit_rows |= 1ull << j;
        if ((m & (m - 1u)) == 0u) {       // one lane: its values are the sums
          if (hit) {
            float4* d4 = reinterpret_cast<float4*>(dst);
            d4[0] = make_float4(v[0], v[1], v[2], v[3]);
            d4[1] = make_float4(v[4], v[5], v[6], v[7]);
            reinterpret_cast<float2*>(dst)[4] = make_float2(v[8], v[9]);
          }
        } else {
          warp_sum_store(v, dst, lane, out_ch);
        }
      }
    }
    if (lane == 0) s_hit[warp] = hit_rows;
    __syncthreads();

    // finish: thread (row, q) adds piece q of the row's partials in warp
    // order and stores 16 bytes; piece 2 is channels 8, 9 and two zeros,
    // piece 3 four zeros
    for (int idx = p; idx < n * 4; idx += kPix) {
      const int row = idx >> 2;
      const int q = idx & 3;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < 3) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if ((s_hit[w] >> row) & 1ull) {
            const float4 t =
                *reinterpret_cast<const float4*>(&s_part[w][row][4 * q]);
            sum.x += t.x;
            sum.y += t.y;
            if (q < 2) {
              sum.z += t.z;
              sum.w += t.w;
            }
          }
        }
      }
      reinterpret_cast<float4*>(
          d_rows + static_cast<size_t>(base + row) * kAttrDim)[q] = sum;
    }
  }
}

}  // namespace

// Zero-fills d_rows (pair_cap, 16) f32 on ``stream``; returns the error code.
extern "C" int blend_bwd_zero_fill(float* d_rows, long long pair_cap,
                                   void* stream) {
  return static_cast<int>(cudaMemsetAsync(
      d_rows, 0, static_cast<size_t>(pair_cap) * kAttrDim * sizeof(float),
      static_cast<cudaStream_t>(stream)));
}

// table (n_rows, 16) f32; src (pair_cap,) int32, row i of the stream being
// table[src[i]]; tile_start/tile_end (num_tiles,) int32; state and d_state
// (num_tiles, 7, 256) f32; d_rows (pair_cap, 16) f32, the gradient of the
// stream's rows.  Zero-fills d_rows and launches on ``stream``; returns
// cudaGetLastError().
extern "C" int blend_bwd(const float* table, const int* src,
                         const int* tile_start, const int* tile_end,
                         const float* state, const float* d_state,
                         float* d_rows, int n_rows, long long pair_cap,
                         int num_tiles, int grid_x, void* stream) {
  const int err = blend_bwd_zero_fill(d_rows, pair_cap, stream);
  if (err != 0) return err;
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        table, src, n_rows, tile_start, tile_end, grid_x, state, d_state,
        d_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
