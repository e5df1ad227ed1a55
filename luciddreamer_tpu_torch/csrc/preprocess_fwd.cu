// The preprocess forward: cull, projection, conic, SH colour and tile rect
// of every Gaussian, one thread per Gaussian.
//
// Not a TPU kernel: the JAX package leaves luciddreamer_tpu/render/
// preprocess.py::preprocess_gaussians to XLA, which fuses it.  On the card
// the port ran it as about 150 elementwise PyTorch launches over P rows
// (render/cuda_preprocess.py::preprocess_fwd_torch, the plain version this
// kernel is held to), plus a (P, 16, 3) copy to concatenate the SH
// coefficients.  The rasterizer the JAX package follows does the same work
// as one preprocessCUDA kernel (computeCov2D and computeColorFromSH fused per
// Gaussian), and so does this kernel.
//
// What bounds it on the card is bytes: each Gaussian's 59 parameters (236 B,
// 180 of them the 45 features_rest floats at SH degree 3) are read once and
// about 65 B of outputs written; its ~500 operations are far below the fp32
// rate.  So the design is one pass and coalesced access to the wide rows: a
// block's 128 features_rest rows are one contiguous run of 128 * 3 * n_rest
// floats, which the block copies into shared memory with consecutive threads
// on consecutive floats (the row stride, 45 floats at degree 3, is odd, so
// each thread's reads of its own row are free of bank conflicts).  The other
// inputs are 3 or 4 floats a row and are read straight.  The camera is a
// packed tensor of 39 floats that every thread reads through the cache.
//
// Every arithmetic step follows the plain version's order (see
// preprocess_math.cuh), so the integer outputs are equal to the plain
// version's on the card and the float outputs agree to its rounding.
// Coefficients past the active degree are neither staged nor read.

#include <cuda_runtime.h>

#include "preprocess_math.cuh"

namespace {

struct FwdArgs {
  const float* xyz;              // (P, 3)
  const float* f_dc;             // (P, 1, 3)
  const float* f_rest;           // (P, n_rest, 3)
  const float* scaling;          // (P, 3)
  const float* rotation;         // (P, 4)
  const float* opacity;          // (P, 1)
  const unsigned char* alive;    // (P,) bool
  const float* offset;           // (P, 2) or null
  const float* cam;              // (kCamLen,)
  float* mean2d;                 // (P, 2)
  float* depth;                  // (P,)
  float* conic;                  // (P, 3)
  float* opac;                   // (P,)
  float* rgb;                    // (P, 3)
  int* radius;                   // (P,)
  int* rect_min;                 // (P, 2)
  int* rect_max;                 // (P, 2)
  int* tiles;                    // (P,)
  unsigned char* visible;        // (P,) bool
  long long P;
  int n_rest, width, height, grid_x, grid_y;
  float tile_size, inv_tile, scale_modifier, near_plane;
};

// clip(int32(v), 0, grid) as render/cuda_preprocess.py::_tile_coord does it:
// NaN -> 0, +-inf saturate, clamp, then truncate
__device__ __forceinline__ int tile_coord(float v, int grid) {
  if (v != v) v = 0.0f;
  v = fminf(fmaxf(v, 0.0f), static_cast<float>(grid));
  return static_cast<int>(v);
}

// min_x, min_y, max_x, max_y of the tile rect of half-widths (rx, ry); the
// division by the tile size is the multiplication by its reciprocal that
// PyTorch's kernel for a tensor divided by a Python number does
__device__ __forceinline__ void tile_rect(const FwdArgs& a, float px, float py,
                                          float rx, float ry, int* out) {
  out[0] = tile_coord((px - rx) * a.inv_tile, a.grid_x);
  out[1] = tile_coord((py - ry) * a.inv_tile, a.grid_y);
  out[2] = tile_coord(((px + rx) + a.tile_size - 1.0f) * a.inv_tile, a.grid_x);
  out[3] = tile_coord(((py + ry) + a.tile_size - 1.0f) * a.inv_tile, a.grid_y);
}

template <int DEG>
__global__ void __launch_bounds__(pp::kThreads)
preprocess_fwd_kernel(const FwdArgs a) {
  extern __shared__ float s_rest[];
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * pp::kThreads;
  const long long left = a.P - row0;
  const int n = left < pp::kThreads ? static_cast<int>(left) : pp::kThreads;
  const int rw = 3 * a.n_rest;                   // floats of a features_rest row
  if (DEG > 0) {
    const float* src = a.f_rest + row0 * rw;
    for (int k = tid; k < n * rw; k += pp::kThreads) s_rest[k] = src[k];
    __syncthreads();
  }
  if (tid >= n) return;
  const long long i = row0 + tid;

  pp::Geo g;
  pp::geometry(a.cam, a.xyz + 3 * i, a.scaling + 3 * i, a.rotation + 4 * i,
               a.opacity[i], a.scale_modifier, a.width, a.height, g);
  float px = g.m2x, py = g.m2y;
  if (a.offset != nullptr) {
    px = px + a.offset[2 * i];
    py = py + a.offset[2 * i + 1];
  }
  const float depth = g.t[2];
  const bool in_front = depth > a.near_plane;

  // 3-sigma radius and the alpha = 1/255 level set's half-widths
  const float mid = 0.5f * (g.cxx + g.cyy);
  const float disc = sqrtf(pp::t_max(mid * mid - g.det, static_cast<float>(0.1)));
  const float sigma = sqrtf(pp::t_max(mid + disc, 0.0f));
  const float radius_f = ceilf(3.0f * sigma);
  const float c_level = 2.0f * pp::t_max(logf(255.0f * g.op),
                                         static_cast<float>(5e-3));
  const float r3s = 3.0f * sigma;
  const float rx = ceilf(pp::t_min(r3s, sqrtf(c_level * g.cxx)));
  const float ry = ceilf(pp::t_min(r3s, sqrtf(c_level * g.cyy)));
  int rc[4], r3[4];
  tile_rect(a, px, py, rx, ry, rc);
  tile_rect(a, px, py, radius_f, radius_f, r3);
  const int tiles = (rc[2] - rc[0]) * (rc[3] - rc[1]);
  const int tiles_ref = (r3[2] - r3[0]) * (r3[3] - r3[1]);
  const bool visible = in_front && g.det != 0.0f && tiles_ref > 0 && a.alive[i];

  // SH -> RGB
  pp::Dir dir;
  pp::view_dir(a.cam, a.xyz + 3 * i, dir);
  float b[16];
  pp::sh_basis(DEG, dir.d[0], dir.d[1], dir.d[2], b);
  const float* rest = s_rest + tid * rw;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dc = a.f_dc[3 * i + c];
    const float res = pp::eval_sh(DEG, b, [&](int k) {
      return k == 0 ? dc : rest[3 * (k - 1) + c];
    });
    a.rgb[3 * i + c] = pp::t_max(res + 0.5f, 0.0f);
  }

  a.mean2d[2 * i] = px;
  a.mean2d[2 * i + 1] = py;
  a.depth[i] = depth;
  a.conic[3 * i] = g.cyy * g.inv;
  a.conic[3 * i + 1] = -g.cxy * g.inv;
  a.conic[3 * i + 2] = g.cxx * g.inv;
  a.opac[i] = g.op;
  a.radius[i] = visible ? static_cast<int>(radius_f) : 0;
  a.rect_min[2 * i] = rc[0];
  a.rect_min[2 * i + 1] = rc[1];
  a.rect_max[2 * i] = rc[2];
  a.rect_max[2 * i + 1] = rc[3];
  a.tiles[i] = visible ? tiles : 0;
  a.visible[i] = visible ? 1 : 0;
}

template <int DEG>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = DEG > 0 ? sizeof(float) * pp::kThreads * 3 * a.n_rest : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        preprocess_fwd_kernel<DEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((a.P + pp::kThreads - 1) / pp::kThreads);
  preprocess_fwd_kernel<DEG><<<blocks, pp::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs and outputs as FwdArgs; every pointer is a contiguous float32
// (int32, bool) tensor on the card, offset may be null; 0 <= deg <= 3 and
// (deg + 1)^2 - 1 <= n_rest.  Enqueues the kernel on ``stream``; returns
// cudaGetLastError() or the error of raising the shared-memory limit.
extern "C" int preprocess_fwd(
    const float* xyz, const float* f_dc, const float* f_rest,
    const float* scaling, const float* rotation, const float* opacity,
    const unsigned char* alive, const float* offset, const float* cam,
    float* mean2d, float* depth, float* conic, float* opac, float* rgb,
    int* radius, int* rect_min, int* rect_max, int* tiles,
    unsigned char* visible, long long P, int n_rest, int deg, int width,
    int height, int tile_size, float scale_modifier, float near_plane,
    void* stream) {
  const FwdArgs a{xyz, f_dc, f_rest, scaling, rotation, opacity, alive,
                  offset, cam, mean2d, depth, conic, opac, rgb, radius,
                  rect_min, rect_max, tiles, visible, P, n_rest, width,
                  height, (width + tile_size - 1) / tile_size,
                  (height + tile_size - 1) / tile_size,
                  static_cast<float>(tile_size),
                  1.0f / static_cast<float>(tile_size), scale_modifier,
                  near_plane};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  switch (deg) {
    case 0: return launch<0>(a, s);
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
