// The preprocess backward: the gradient of the differentiable outputs of
// preprocess_fwd.cu (mean2d, depth, conic, opacity, rgb) with respect to
// every parameter group and the mean2d offset, one thread per Gaussian.
//
// Not a TPU kernel: JAX differentiates luciddreamer_tpu/render/preprocess.py
// itself.  On the card autograd ran it as about 1,000 launches (the
// backward of each elementwise op, and for each of the 16 SH coefficient
// reads a zero-filled (P, 16, 3) gradient, then added up).  This kernel is
// the derivation by hand, written out as explicit PyTorch ops in
// render/cuda_preprocess.py::preprocess_bwd_torch in the same order; it
// recomputes the forward's intermediates from the parameters (nothing is
// saved between the passes) and writes all six gradient groups and
// d mean2d_offset in one pass.  It keeps autograd's conventions, which the
// plain version is held to: clamp_min passes the gradient where its input is
// >= the bound, torch.maximum / torch.minimum give half of it at a tie, the
// det == 0 rows take none through the conic's where, and the tile rect,
// radius and level-set arithmetic (integer outputs) contribute nothing.
//
// What bounds it on the card is bytes: the parameters and the 10 cotangent
// channels read (276 B a Gaussian) and the gradients written (236 B), far
// more time than its ~1,000 operations.  The features_rest rows, 180 of the
// 236 bytes at degree 3, go through shared memory both ways: a block reads
// its 128 rows as one contiguous run, each thread overwrites its own row
// with that row's gradient (coefficients past the active degree get 0), and
// the block writes the run back contiguously.

#include <cuda_runtime.h>

#include "preprocess_math.cuh"

namespace {

struct BwdArgs {
  const float* xyz;              // (P, 3)
  const float* f_dc;             // (P, 1, 3)
  const float* f_rest;           // (P, n_rest, 3)
  const float* scaling;          // (P, 3)
  const float* rotation;         // (P, 4)
  const float* opacity;          // (P, 1)
  const float* cam;              // (kCamLen,)
  const float* g_mean2d;         // (P, 2) cotangents of the outputs
  const float* g_depth;          // (P,)
  const float* g_conic;          // (P, 3)
  const float* g_opac;           // (P,)
  const float* g_rgb;            // (P, 3)
  float* d_xyz;                  // (P, 3) gradients of the inputs
  float* d_dc;                   // (P, 1, 3)
  float* d_rest;                 // (P, n_rest, 3)
  float* d_scaling;              // (P, 3)
  float* d_rotation;             // (P, 4)
  float* d_opacity;              // (P, 1)
  float* d_offset;               // (P, 2) or null
  long long P;
  int n_rest, width, height;
  float scale_modifier;
};

// The gradient torch.minimum(v, lim) / torch.maximum(v, lim) passes to v:
// all of g on v's side of lim, none beyond it, half at a tie
__device__ __forceinline__ float pass_min(float v, float lim, float g) {
  return v > lim ? 0.0f : (v == lim ? g / 2.0f : g);
}

__device__ __forceinline__ float pass_max(float v, float lim, float g) {
  return v < lim ? 0.0f : (v == lim ? g / 2.0f : g);
}

template <int DEG>
__global__ void __launch_bounds__(pp::kThreads)
preprocess_bwd_kernel(const BwdArgs a) {
  extern __shared__ float s_rest[];
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * pp::kThreads;
  const long long left = a.P - row0;
  const int n = left < pp::kThreads ? static_cast<int>(left) : pp::kThreads;
  const int rw = 3 * a.n_rest;
  constexpr bool stage = DEG > 0;
  constexpr int n_act = (DEG + 1) * (DEG + 1);   // active coefficients
  if (stage) {
    const float* src = a.f_rest + row0 * rw;
    for (int k = tid; k < n * rw; k += pp::kThreads) s_rest[k] = src[k];
    __syncthreads();
  }
  if (tid < n) {
    const long long i = row0 + tid;
    const float* cam = a.cam;
    const float* vm = cam + pp::kVm;
    const float* pm = cam + pp::kPm;
    pp::Geo g;
    pp::geometry(cam, a.xyz + 3 * i, a.scaling + 3 * i, a.rotation + 4 * i,
                 a.opacity[i], a.scale_modifier, a.width, a.height, g);
    const float gm2x = a.g_mean2d[2 * i], gm2y = a.g_mean2d[2 * i + 1];
    const float gdep = a.g_depth[i];
    const float gca = a.g_conic[3 * i], gcb = a.g_conic[3 * i + 1];
    const float gcc = a.g_conic[3 * i + 2];
    if (a.d_offset != nullptr) {
      a.d_offset[2 * i] = gm2x;
      a.d_offset[2 * i + 1] = gm2y;
    }
    a.d_opacity[i] = (a.g_opac[i] * (1.0f - g.op)) * g.op;

    // depth = t2 and the projection: ndc = hom * inv_w, inv_w = 1 / (p_w' + 1e-7)
    const float dndc_x = (gm2x * 0.5f) * static_cast<float>(a.width);
    const float dndc_y = (gm2y * 0.5f) * static_cast<float>(a.height);
    const float d_hom_x = dndc_x * g.inv_w;
    const float d_hom_y = dndc_y * g.inv_w;
    const float d_inv_w = dndc_x * g.hom_x + dndc_y * g.hom_y;
    const float d_den = -d_inv_w * (g.inv_w * g.inv_w);
    const float d_pw = g.p_w >= static_cast<float>(1e-3) ? d_den : 0.0f;
    float dxyz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dxyz[k] = ((gdep * vm[8 + k] + d_hom_x * pm[k]) + d_hom_y * pm[4 + k])
                + d_pw * pm[12 + k];

    // conic = (cyy, -cxy, cxx) / det_safe, det = cxx cyy - cxy^2
    float d_cxx = gcc * g.inv;
    float d_cyy = gca * g.inv;
    float d_cxy = -(gcb * g.inv);
    const float d_inv = (gca * g.cyy + gcb * -g.cxy) + gcc * g.cxx;
    const float d_det = g.det == 0.0f ? 0.0f : -d_inv * (g.inv * g.inv);
    d_cxx = d_cxx + d_det * g.cyy;
    d_cyy = d_cyy + d_det * g.cxx;
    d_cxy = d_cxy - 2.0f * (d_det * g.cxy);

    // cov2d = J V J^T
    const float j00 = g.j00, j11 = g.j11, j02 = g.j02, j12 = g.j12;
    const float* V = g.V;
    float dV[6];
    dV[0] = d_cxx * (j00 * j00);
    dV[1] = d_cxy * (j00 * j11);
    dV[2] = d_cxx * (2.0f * j00 * j02) + d_cxy * (j00 * j12);
    dV[3] = d_cyy * (j11 * j11);
    dV[4] = d_cxy * (j02 * j11) + d_cyy * (2.0f * j11 * j12);
    dV[5] = (d_cxx * (j02 * j02) + d_cxy * (j02 * j12)) + d_cyy * (j12 * j12);
    const float d_j00 = d_cxx * (2.0f * j00 * V[0] + 2.0f * j02 * V[2])
                        + d_cxy * (j11 * V[1] + j12 * V[2]);
    const float d_j02 = d_cxx * (2.0f * j00 * V[2] + 2.0f * j02 * V[5])
                        + d_cxy * (j11 * V[4] + j12 * V[5]);
    const float d_j11 = d_cyy * (2.0f * j11 * V[3] + 2.0f * j12 * V[4])
                        + d_cxy * (j00 * V[1] + j02 * V[4]);
    const float d_j12 = d_cyy * (2.0f * j11 * V[4] + 2.0f * j12 * V[5])
                        + d_cxy * (j00 * V[2] + j02 * V[5]);

    // J from tz and the clamped tx, ty
    const float fx = cam[pp::kFocalX], fy = cam[pp::kFocalY];
    const float d_txy[2] = {(d_j02 * -fx) * g.inv_z2, (d_j12 * -fy) * g.inv_z2};
    const float d_inv_z2 = d_j02 * (-fx * g.tx) + d_j12 * (-fy * g.ty);
    const float d_inv_z = (d_j00 * fx + d_j11 * fy) + 2.0f * g.inv_z * d_inv_z2;
    float d_tz = -d_inv_z * (g.inv_z * g.inv_z);
    float d_t[3];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float lim = cam[pp::kLimX + k];
      const float d_cl = d_txy[k] * g.tz;
      d_tz = d_tz + d_txy[k] * g.cl[k];
      const float d_u = pass_max(g.u[k], -lim, pass_min(g.mxv[k], lim, d_cl));
      d_t[k] = d_u / g.tz;
      d_tz = d_tz + (-d_u * g.t[k]) / (g.tz * g.tz);
    }
    d_t[2] = g.t[2] >= static_cast<float>(0.01) ? d_tz : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dxyz[k] = ((dxyz[k] + d_t[0] * vm[k]) + d_t[1] * vm[4 + k])
                + d_t[2] * vm[8 + k];

    // V = W S W^T through the rows a_i of W S: v_ij = a_i . W_j
    const int vi[6] = {0, 0, 0, 1, 1, 2}, vj[6] = {0, 1, 2, 1, 2, 2};
    float da[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) da[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        da[3 * vi[k] + c] = da[3 * vi[k] + c] + dV[k] * vm[4 * vj[k] + c];
    }
    float dS[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) dS[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float w0 = vm[4 * r], w1 = vm[4 * r + 1], w2 = vm[4 * r + 2];
      const float a0 = da[3 * r], a1 = da[3 * r + 1], a2 = da[3 * r + 2];
      dS[0] = dS[0] + a0 * w0;
      dS[1] = dS[1] + (a0 * w1 + a1 * w0);
      dS[2] = dS[2] + (a0 * w2 + a2 * w0);
      dS[3] = dS[3] + a1 * w1;
      dS[4] = dS[4] + (a1 * w2 + a2 * w1);
      dS[5] = dS[5] + a2 * w2;
    }

    // S = M M^T, M = R diag(s), s = exp(scaling) * scale_modifier
    const float* M = g.M;
    float dM[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dM[j] = (2.0f * dS[0] * M[j] + dS[1] * M[3 + j]) + dS[2] * M[6 + j];
      dM[3 + j] = (dS[1] * M[j] + 2.0f * dS[3] * M[3 + j]) + dS[4] * M[6 + j];
      dM[6 + j] = (dS[2] * M[j] + dS[4] * M[3 + j]) + 2.0f * dS[5] * M[6 + j];
    }
    float dR[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float ds = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        dR[3 * r + j] = dM[3 * r + j] * g.s[j];
        ds = ds + dM[3 * r + j] * g.R[3 * r + j];
      }
      a.d_scaling[3 * i + j] = (ds * a.scale_modifier) * g.sc[j];
    }

    // R from the normalized quaternion (r, x, y, z), then the normalization
    const float qr = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
    float dq[4];
    dq[0] = 2.0f * (((((-qz * dR[1] + qy * dR[2]) + qz * dR[3]) - qx * dR[5])
                     - qy * dR[6]) + qx * dR[7]);
    dq[1] = 2.0f * (((((((qy * dR[1] + qz * dR[2]) + qy * dR[3])
                        - 2.0f * qx * dR[4]) - qr * dR[5]) + qz * dR[6])
                     + qr * dR[7]) - 2.0f * qx * dR[8]);
    dq[2] = 2.0f * ((((((-2.0f * qy * dR[0] + qx * dR[1]) + qr * dR[2])
                       + qx * dR[3]) + qz * dR[5]) - qr * dR[6])
                    + qz * dR[7] - 2.0f * qy * dR[8]);
    dq[3] = 2.0f * (((((((-2.0f * qz * dR[0] - qr * dR[1]) + qx * dR[2])
                        + qr * dR[3]) - 2.0f * qz * dR[4]) + qy * dR[5])
                     + qx * dR[6]) + qy * dR[7]);
    const float qdot = ((dq[0] * g.qraw[0] + dq[1] * g.qraw[1])
                        + dq[2] * g.qraw[2]) + dq[3] * g.qraw[3];
    const float dq_sum = (-qdot / (g.qn * g.qn)) / (2.0f * g.qn);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a.d_rotation[4 * i + k] = dq[k] / g.qn + (2.0f * g.qraw[k]) * dq_sum;

    // SH -> RGB: rgb = clamp_min(eval_sh + 0.5, 0)
    pp::Dir dir;
    pp::view_dir(cam, a.xyz + 3 * i, dir);
    const float x = dir.d[0], y = dir.d[1], z = dir.d[2];
    float b[16];
    pp::sh_basis(DEG, x, y, z, b);
    float* rest = s_rest + tid * rw;
    float d_res[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dc = a.f_dc[3 * i + c];
      const float res = pp::eval_sh(DEG, b, [&](int k) {
        return k == 0 ? dc : rest[3 * (k - 1) + c];
      });
      d_res[c] = res + 0.5f >= 0.0f ? a.g_rgb[3 * i + c] : 0.0f;
      a.d_dc[3 * i + c] = pp::kC0 * d_res[c];
    }
    // per coefficient k: w[k] = sum_c d_res[c] sh[k][c]; its gradient is
    // +-b[k] d_res (b[1] and b[3] enter subtracted), written over its row
    float w[16];
#pragma unroll
    for (int k = 1; k < n_act; ++k) {
      float* sk = rest + 3 * (k - 1);
      w[k] = (d_res[0] * sk[0] + d_res[1] * sk[1]) + d_res[2] * sk[2];
      const float bk = (k == 1 || k == 3) ? -b[k] : b[k];
#pragma unroll
      for (int c = 0; c < 3; ++c) sk[c] = bk * d_res[c];
    }
    if (stage)
      for (int k = 3 * (n_act - 1); k < rw; ++k) rest[k] = 0.0f;
    float dd[3] = {0.0f, 0.0f, 0.0f};
    if (DEG > 0) {
      dd[1] = dd[1] - pp::kC1 * w[1];
      dd[2] = dd[2] + pp::kC1 * w[2];
      dd[0] = dd[0] - pp::kC1 * w[3];
    }
    if (DEG > 1) {
      dd[0] = dd[0] + (pp::kC20 * y) * w[4];
      dd[1] = dd[1] + (pp::kC20 * x) * w[4];
      dd[1] = dd[1] + (pp::kC21 * z) * w[5];
      dd[2] = dd[2] + (pp::kC21 * y) * w[5];
      dd[0] = dd[0] + (pp::kC22 * (-2.0f * x)) * w[6];
      dd[1] = dd[1] + (pp::kC22 * (-2.0f * y)) * w[6];
      dd[2] = dd[2] + (pp::kC22 * (4.0f * z)) * w[6];
      dd[0] = dd[0] + (pp::kC23 * z) * w[7];
      dd[2] = dd[2] + (pp::kC23 * x) * w[7];
      dd[0] = dd[0] + (pp::kC24 * (2.0f * x)) * w[8];
      dd[1] = dd[1] + (pp::kC24 * (-2.0f * y)) * w[8];
    }
    if (DEG > 2) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      dd[0] = dd[0] + (pp::kC30 * (6.0f * xy)) * w[9];
      dd[1] = dd[1] + (pp::kC30 * (3.0f * xx - 3.0f * yy)) * w[9];
      dd[0] = dd[0] + (pp::kC31 * yz) * w[10];
      dd[1] = dd[1] + (pp::kC31 * xz) * w[10];
      dd[2] = dd[2] + (pp::kC31 * xy) * w[10];
      dd[0] = dd[0] + (pp::kC32 * (-2.0f * xy)) * w[11];
      dd[1] = dd[1] + (pp::kC32 * ((4.0f * zz - xx) - 3.0f * yy)) * w[11];
      dd[2] = dd[2] + (pp::kC32 * (8.0f * yz)) * w[11];
      dd[0] = dd[0] + (pp::kC33 * (-6.0f * xz)) * w[12];
      dd[1] = dd[1] + (pp::kC33 * (-6.0f * yz)) * w[12];
      dd[2] = dd[2] + (pp::kC33 * ((6.0f * zz - 3.0f * xx) - 3.0f * yy)) * w[12];
      dd[0] = dd[0] + (pp::kC34 * ((4.0f * zz - 3.0f * xx) - yy)) * w[13];
      dd[1] = dd[1] + (pp::kC34 * (-2.0f * xy)) * w[13];
      dd[2] = dd[2] + (pp::kC34 * (8.0f * xz)) * w[13];
      dd[0] = dd[0] + (pp::kC35 * (2.0f * xz)) * w[14];
      dd[1] = dd[1] + (pp::kC35 * (-2.0f * yz)) * w[14];
      dd[2] = dd[2] + (pp::kC35 * (xx - yy)) * w[14];
      dd[0] = dd[0] + (pp::kC36 * (3.0f * xx - 3.0f * yy)) * w[15];
      dd[1] = dd[1] + (pp::kC36 * (-6.0f * xy)) * w[15];
    }
    // d = v / n, n = sqrt(|v|^2 + 1e-20), v = xyz - campos
    const float vdot = (dd[0] * dir.v[0] + dd[1] * dir.v[1]) + dd[2] * dir.v[2];
    const float dv_sum = (-vdot / (dir.n * dir.n)) / (2.0f * dir.n);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      a.d_xyz[3 * i + k] = dxyz[k] + (dd[k] / dir.n + (2.0f * dir.v[k]) * dv_sum);
  }
  if (rw > 0) {
    float* dst = a.d_rest + row0 * rw;
    if (stage) {
      __syncthreads();
      for (int k = tid; k < n * rw; k += pp::kThreads) dst[k] = s_rest[k];
    } else {
      for (int k = tid; k < n * rw; k += pp::kThreads) dst[k] = 0.0f;
    }
  }
}

template <int DEG>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = DEG > 0 ? sizeof(float) * pp::kThreads * 3 * a.n_rest : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        preprocess_bwd_kernel<DEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((a.P + pp::kThreads - 1) / pp::kThreads);
  preprocess_bwd_kernel<DEG><<<blocks, pp::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs and outputs as BwdArgs; every pointer is a contiguous float32
// tensor on the card, d_offset may be null; 0 <= deg <= 3 and
// (deg + 1)^2 - 1 <= n_rest.  Enqueues the kernel on ``stream``; returns
// cudaGetLastError() or the error of raising the shared-memory limit.
extern "C" int preprocess_bwd(
    const float* xyz, const float* f_dc, const float* f_rest,
    const float* scaling, const float* rotation, const float* opacity,
    const float* cam, const float* g_mean2d, const float* g_depth,
    const float* g_conic, const float* g_opac, const float* g_rgb,
    float* d_xyz, float* d_dc, float* d_rest, float* d_scaling,
    float* d_rotation, float* d_opacity, float* d_offset, long long P,
    int n_rest, int deg, int width, int height, float scale_modifier,
    void* stream) {
  const BwdArgs a{xyz, f_dc, f_rest, scaling, rotation, opacity, cam,
                  g_mean2d, g_depth, g_conic, g_opac, g_rgb, d_xyz, d_dc,
                  d_rest, d_scaling, d_rotation, d_opacity, d_offset, P,
                  n_rest, width, height, scale_modifier};
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
