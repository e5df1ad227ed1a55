// Per-Gaussian preprocess arithmetic shared by preprocess_fwd.cu and
// preprocess_bwd.cu: the activations, the 3D covariance, its EWA projection,
// the conic, the screen position and the SH colour, written operation by
// operation in the order of the plain forward
// (render/cuda_preprocess.py::preprocess_fwd_torch and core/{covariance,sh}.py).
// Built with -fmad=false, IEEE division and square root and the same
// expf/logf/ceilf as PyTorch's own kernels, every value rounds as the plain
// version's does on the card, so that the integer outputs (radius, tile
// rects, tiles touched, visibility) that binning's pairs depend on are equal.
//
// The camera is a packed float32 tensor, built by the wrapper with torch ops
// (so focal lengths and clamp limits round as the plain version's do).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pp {

constexpr int kThreads = 128;      // Gaussians per block, one per thread

// packed camera: world->view and proj @ view row-major, the camera centre,
// the focal lengths and the 1.3 * tan(fov / 2) clamp limits
constexpr int kVm = 0;
constexpr int kPm = 16;
constexpr int kCampos = 32;
constexpr int kFocalX = 35;
constexpr int kFocalY = 36;
constexpr int kLimX = 37;
constexpr int kLimY = 38;
constexpr int kCamLen = 39;

// SH constants as PyTorch rounds the Python doubles (core/sh.py)
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);

// torch.maximum / torch.minimum / clamp_min: a NaN operand wins
__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.sum over a last dimension of 3 or 4 on the card, in the order ATen's
// reduction takes (found on an H100 against every order, torch 2.11): two
// lanes, the first summing elements 0 and 2, then the lanes folded
__device__ __forceinline__ float t_sum3(float a, float b, float c) {
  return (a + c) + b;
}

__device__ __forceinline__ float t_sum4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}

// x @ row r of a row-major 4x4, as the plain version sums it
__device__ __forceinline__ float row_dot(const float* m, int r, float x,
                                         float y, float z) {
  return ((m[4 * r] * x + m[4 * r + 1] * y) + m[4 * r + 2] * z) + m[4 * r + 3];
}

// Everything the differentiable outputs are made of, for one Gaussian.
struct Geo {
  float op;                    // sigmoid(opacity)
  float sc[3];                 // exp(scaling)
  float qraw[4], qn, q[4];     // rotation, sqrt(|q|^2 + 1e-24), normalized
  float R[9];                  // rotation matrix, row-major
  float s[3];                  // sc * scale_modifier
  float M[9];                  // R diag(s)
  float S[6];                  // cov3d: xx, xy, xz, yy, yz, zz
  float t[3], tz;              // view-space mean, tz = clamp_min(t2, 0.01)
  float u[2], mxv[2], cl[2];   // t/tz, its max with -lim, then min with lim
  float tx, ty;                // cl * tz
  float V[6];                  // W S W^T: v00, v01, v02, v11, v12, v22
  float inv_z, inv_z2, j00, j11, j02, j12;
  float cxx, cxy, cyy, det, inv;   // cov2d (+0.3), det, 1 / det_safe
  float hom_x, hom_y, p_w, inv_w;
  float m2x, m2y;              // mean2d before the offset
};

__device__ __forceinline__ void geometry(const float* cam, const float* xyz,
                                         const float* scaling,
                                         const float* rotation, float o_raw,
                                         float scale_modifier, int width,
                                         int height, Geo& g) {
  const float* vm = cam + kVm;
  const float* pm = cam + kPm;
  const float mx = xyz[0], my = xyz[1], mz = xyz[2];
  g.op = 1.0f / (1.0f + expf(-o_raw));
#pragma unroll
  for (int k = 0; k < 3; ++k) g.sc[k] = expf(scaling[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) g.qraw[k] = rotation[k];
  g.qn = sqrtf(t_sum4(g.qraw[0] * g.qraw[0], g.qraw[1] * g.qraw[1],
                      g.qraw[2] * g.qraw[2], g.qraw[3] * g.qraw[3])
               + static_cast<float>(1e-24));
#pragma unroll
  for (int k = 0; k < 4; ++k) g.q[k] = g.qraw[k] / g.qn;

  // projection (render/preprocess: hom, p_w, inv_w, ndc2pix)
  g.hom_x = row_dot(pm, 0, mx, my, mz);
  g.hom_y = row_dot(pm, 1, mx, my, mz);
  g.p_w = row_dot(pm, 3, mx, my, mz);
  g.inv_w = 1.0f / (t_max(g.p_w, static_cast<float>(1e-3))
                    + static_cast<float>(1e-7));
  const float ndc_x = g.hom_x * g.inv_w;
  const float ndc_y = g.hom_y * g.inv_w;
  g.m2x = ((ndc_x + 1.0f) * static_cast<float>(width) - 1.0f) * 0.5f;
  g.m2y = ((ndc_y + 1.0f) * static_cast<float>(height) - 1.0f) * 0.5f;

  // covariance.build_cov3d
  const float r = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  g.R[0] = 1.0f - 2.0f * (y * y + z * z);
  g.R[1] = 2.0f * (x * y - r * z);
  g.R[2] = 2.0f * (x * z + r * y);
  g.R[3] = 2.0f * (x * y + r * z);
  g.R[4] = 1.0f - 2.0f * (x * x + z * z);
  g.R[5] = 2.0f * (y * z - r * x);
  g.R[6] = 2.0f * (x * z - r * y);
  g.R[7] = 2.0f * (y * z + r * x);
  g.R[8] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int k = 0; k < 3; ++k) g.s[k] = g.sc[k] * scale_modifier;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g.M[3 * i + j] = g.R[3 * i + j] * g.s[j];
  }
  const float* M = g.M;
  g.S[0] = (M[0] * M[0] + M[1] * M[1]) + M[2] * M[2];
  g.S[1] = (M[0] * M[3] + M[1] * M[4]) + M[2] * M[5];
  g.S[2] = (M[0] * M[6] + M[1] * M[7]) + M[2] * M[8];
  g.S[3] = (M[3] * M[3] + M[4] * M[4]) + M[5] * M[5];
  g.S[4] = (M[3] * M[6] + M[4] * M[7]) + M[5] * M[8];
  g.S[5] = (M[6] * M[6] + M[7] * M[7]) + M[8] * M[8];

  // covariance.project_cov3d_to_2d
#pragma unroll
  for (int k = 0; k < 3; ++k) g.t[k] = row_dot(vm, k, mx, my, mz);
  g.tz = t_max(g.t[2], static_cast<float>(0.01));
  const float lim[2] = {cam[kLimX], cam[kLimY]};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    g.u[k] = g.t[k] / g.tz;
    g.mxv[k] = t_max(g.u[k], -lim[k]);
    g.cl[k] = t_min(g.mxv[k], lim[k]);
  }
  g.tx = g.cl[0] * g.tz;
  g.ty = g.cl[1] * g.tz;
  const float* S = g.S;
  float a[9];                  // row i of W S
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float w0 = vm[4 * i], w1 = vm[4 * i + 1], w2 = vm[4 * i + 2];
    a[3 * i] = (w0 * S[0] + w1 * S[1]) + w2 * S[2];
    a[3 * i + 1] = (w0 * S[1] + w1 * S[3]) + w2 * S[4];
    a[3 * i + 2] = (w0 * S[2] + w1 * S[4]) + w2 * S[5];
  }
  // v_ij = a_i . W_j for (i, j) in (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
  const int vi[6] = {0, 0, 0, 1, 1, 2}, vj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float* ai = a + 3 * vi[k];
    const float* wj = vm + 4 * vj[k];
    g.V[k] = (ai[0] * wj[0] + ai[1] * wj[1]) + ai[2] * wj[2];
  }
  const float fx = cam[kFocalX], fy = cam[kFocalY];
  g.inv_z = 1.0f / g.tz;
  g.inv_z2 = g.inv_z * g.inv_z;
  g.j00 = fx * g.inv_z;
  g.j11 = fy * g.inv_z;
  g.j02 = (-fx * g.tx) * g.inv_z2;
  g.j12 = (-fy * g.ty) * g.inv_z2;
  const float* V = g.V;
  g.cxx = (((g.j00 * g.j00) * V[0] + ((2.0f * g.j00) * g.j02) * V[2])
           + (g.j02 * g.j02) * V[5]) + static_cast<float>(0.3);
  g.cxy = (((g.j00 * g.j11) * V[1] + (g.j00 * g.j12) * V[2])
           + (g.j02 * g.j11) * V[4]) + (g.j02 * g.j12) * V[5];
  g.cyy = (((g.j11 * g.j11) * V[3] + ((2.0f * g.j11) * g.j12) * V[4])
           + (g.j12 * g.j12) * V[5]) + static_cast<float>(0.3);

  // covariance.invert_cov2d
  g.det = g.cxx * g.cyy - g.cxy * g.cxy;
  g.inv = 1.0f / (g.det == 0.0f ? 1.0f : g.det);
}

// SH basis of degree <= 3 at the unit direction (x, y, z): b[k] multiplies
// coefficient k; b[1] and b[3] are the subtracted terms' factors, so the
// forward subtracts them as core/sh.py does.
__device__ __forceinline__ void sh_basis(int deg, float x, float y, float z,
                                         float* b) {
  b[0] = kC0;
  if (deg > 0) {
    b[1] = kC1 * y;
    b[2] = kC1 * z;
    b[3] = kC1 * x;
  }
  if (deg > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC20 * xy;
    b[5] = kC21 * yz;
    b[6] = kC22 * ((2.0f * zz - xx) - yy);
    b[7] = kC23 * xz;
    b[8] = kC24 * (xx - yy);
    if (deg > 2) {
      b[9] = (kC30 * y) * (3.0f * xx - yy);
      b[10] = (kC31 * xy) * z;
      b[11] = (kC32 * y) * ((4.0f * zz - xx) - yy);
      b[12] = (kC33 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (kC34 * x) * ((4.0f * zz - xx) - yy);
      b[14] = (kC35 * z) * (xx - yy);
      b[15] = (kC36 * x) * (xx - 3.0f * yy);
    }
  }
}

// The unit direction from the camera centre to the mean (core/sh.py), and
// the pieces its backward needs.
struct Dir {
  float v[3], n, d[3];
};

__device__ __forceinline__ void view_dir(const float* cam, const float* xyz,
                                         Dir& o) {
#pragma unroll
  for (int k = 0; k < 3; ++k) o.v[k] = xyz[k] - cam[kCampos + k];
  o.n = sqrtf(t_sum3(o.v[0] * o.v[0], o.v[1] * o.v[1], o.v[2] * o.v[2])
              + static_cast<float>(1e-20));
#pragma unroll
  for (int k = 0; k < 3; ++k) o.d[k] = o.v[k] / o.n;
}

// eval_sh(deg, sh, d) for one channel: sh(k) is coefficient k
template <typename Coef>
__device__ __forceinline__ float eval_sh(int deg, const float* b, Coef sh) {
  float res = b[0] * sh(0);
  if (deg > 0) res = ((res - b[1] * sh(1)) + b[2] * sh(2)) - b[3] * sh(3);
  if (deg > 1)
#pragma unroll
    for (int k = 4; k < 9; ++k) res = res + b[k] * sh(k);
  if (deg > 2)
#pragma unroll
    for (int k = 9; k < 16; ++k) res = res + b[k] * sh(k);
  return res;
}

}  // namespace pp
