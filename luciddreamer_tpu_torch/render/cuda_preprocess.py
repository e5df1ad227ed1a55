"""The preprocess layer (cull, projection, conic, SH colour and tile rect of
every Gaussian) as a pair of hand-written CUDA kernels for Hopper,
``csrc/preprocess_fwd.cu`` and ``csrc/preprocess_bwd.cu``, tied together by
a ``torch.autograd.Function``.

Neither replaces a TPU kernel: the JAX package leaves
``luciddreamer_tpu/render/preprocess.py::preprocess_gaussians`` to XLA,
which fuses it.  Run as plain PyTorch on the card it was about 150
elementwise launches forward and about 1,000 in autograd's backward, where
each of the 16 SH coefficient reads zero-fills a (P, 16, 3) gradient
(PERF.md).  Each kernel does its direction in one pass, one thread per
Gaussian, reading ``features_dc`` and ``features_rest`` where they lie (no
concatenated copy); the backward recomputes the forward's intermediates
from the parameters.  Both are built at first use by ``kernels``.

``preprocess_fwd`` and ``preprocess_bwd`` launch the kernels on CUDA
tensors and count each launch in ``preprocess_fwd.launches`` /
``preprocess_bwd.launches``.  Their plain versions:
``preprocess_fwd_torch`` is the forward as the port always computed it,
which ``render/preprocess.py`` differentiates by autograd on the CPU;
``preprocess_bwd_torch`` is its backward derived by hand, as explicit
PyTorch ops in the kernel's order, holding to autograd's conventions
(``clamp_min`` passes the gradient where its input is >= the bound,
``torch.maximum`` / ``torch.minimum`` split it in half at a tie, no
gradient through the ``det == 0`` branch or the integer outputs).
``preprocess`` is the differentiable entry point: on CUDA tensors the
Function runs the two kernels, with no fallback; on CPU tensors the two
plain versions.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from luciddreamer_tpu_torch.core import covariance, sh as shlib
from luciddreamer_tpu_torch.core.transforms import ndc2pix
from luciddreamer_tpu_torch.core.types import Camera, GaussianParams, ProcessedGaussians
from luciddreamer_tpu_torch.render import kernels

CAM_LEN = 39            # the packed camera (csrc/preprocess_math.cuh)
MAX_DEGREE = 3          # SH degrees the kernels evaluate
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_FWD_ARGS = [_P] * 19 + [_LL] + [_I] * 5 + [_F, _F, _P]
_BWD_ARGS = [_P] * 19 + [_LL] + [_I] * 4 + [_F, _P]
_INT_FIELDS = ("radius", "rect_min", "rect_max", "tiles_touched", "visible")


# ------------------------------------------------------------ plain forward

def _tile_coord(v: torch.Tensor, grid: int) -> torch.Tensor:
    """clip(int32(v), 0, grid) with the JAX package's saturating float->int
    conversion (NaN -> 0, +-inf saturate), which a C cast on the CPU leaves
    undefined.  Clamping before the truncation gives the same integers."""
    return torch.nan_to_num(v, nan=0.0).clamp(0, grid).to(torch.int32)


def preprocess_fwd_torch(
    xyz, features_dc, features_rest, scaling, rotation, opacity, alive,
    camera: Camera,
    active_sh_degree: int,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    near_plane: float = 0.2,
    mean2d_offset: torch.Tensor | None = None,
) -> ProcessedGaussians:
    """Screen-space quantities of every Gaussian (masked), from the raw
    parameters of ``GaussianParams``: the plain forward, differentiable by
    autograd."""
    means = xyz                                     # (P, 3)
    opacity = torch.sigmoid(opacity)[..., 0]        # (P,)
    scales = torch.exp(scaling)
    # sqrt(sum + eps) keeps zero quaternions (dead capacity rows padded by
    # load_ply) finite, in value and gradient
    quats = rotation / torch.sqrt(
        torch.sum(rotation**2, dim=-1, keepdim=True) + 1e-24)
    mx, my, mz = means[..., 0], means[..., 1], means[..., 2]

    # --- frustum cull: view-space z > near_plane ---
    vm = camera.viewmatrix
    p_view_z = vm[2, 0] * mx + vm[2, 1] * my + vm[2, 2] * mz + vm[2, 3]
    in_front = p_view_z > near_plane

    # --- projection ---
    pm = camera.projmatrix
    hom_x = pm[0, 0] * mx + pm[0, 1] * my + pm[0, 2] * mz + pm[0, 3]
    hom_y = pm[1, 0] * mx + pm[1, 1] * my + pm[1, 2] * mz + pm[1, 3]
    p_w = pm[3, 0] * mx + pm[3, 1] * my + pm[3, 2] * mz + pm[3, 3]
    # culled rows (w <= 0.2) must not produce inf; visible rows unchanged
    inv_w = 1.0 / (torch.clamp_min(p_w, 1e-3) + 1e-7)
    ndc_x = hom_x * inv_w
    ndc_y = hom_y * inv_w
    mean2d = torch.stack(
        [ndc2pix(ndc_x, camera.width), ndc2pix(ndc_y, camera.height)], dim=-1
    )
    if mean2d_offset is not None:
        # zeros passed by a training step; its gradient is the screen-space
        # densification signal
        mean2d = mean2d + mean2d_offset

    # --- covariance -> conic ---
    cov3d = covariance.build_cov3d(scales, quats, scale_modifier)
    cov2d = covariance.project_cov3d_to_2d(
        means, cov3d, vm, camera.focal_x, camera.focal_y,
        camera.tanfovx, camera.tanfovy,
    )
    conic, det = covariance.invert_cov2d(cov2d)
    det_ok = det != 0.0
    sigma_max = covariance.cov2d_max_sigma(cov2d, det)
    radius_f = torch.ceil(3.0 * sigma_max)          # reported 3-sigma radius

    # --- tile rect, tightened to the alpha = 1/255 ellipse ---
    # Pairs outside the bounding box of the level set op * exp(-d^T S^-1 d / 2)
    # = 1/255 (half-widths sqrt(c * Sigma_xx), sqrt(c * Sigma_yy) with
    # c = 2 ln(255 op)) are skipped by the blend anyway; intersecting with
    # the 3-sigma square never adds a pair.
    c_level = 2.0 * torch.clamp_min(torch.log(255.0 * opacity), 5e-3)
    r3s = 3.0 * sigma_max
    rx = torch.ceil(torch.minimum(r3s, torch.sqrt(c_level * cov2d[..., 0])))
    ry = torch.ceil(torch.minimum(r3s, torch.sqrt(c_level * cov2d[..., 2])))
    grid_x = (camera.width + tile_size - 1) // tile_size
    grid_y = (camera.height + tile_size - 1) // tile_size
    px, py = mean2d[..., 0], mean2d[..., 1]

    def rect(rx, ry):
        min_x = _tile_coord((px - rx) / tile_size, grid_x)
        min_y = _tile_coord((py - ry) / tile_size, grid_y)
        max_x = _tile_coord((px + rx + tile_size - 1) / tile_size, grid_x)
        max_y = _tile_coord((py + ry + tile_size - 1) / tile_size, grid_y)
        return min_x, min_y, max_x, max_y

    with torch.no_grad():
        rect_min_x, rect_min_y, rect_max_x, rect_max_y = rect(rx, ry)
        tiles = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
        # visibility and the reported radius come from the 3-sigma rect
        r3 = rect(radius_f, radius_f)
        tiles_ref = (r3[2] - r3[0]) * (r3[3] - r3[1])

        visible = in_front & det_ok & (tiles_ref > 0) & alive
        tiles = torch.where(visible, tiles, torch.zeros_like(tiles))
        radius = torch.where(
            visible, radius_f, torch.zeros_like(radius_f)
        ).to(torch.int32)

    # --- SH -> RGB ---
    shs = torch.cat([features_dc, features_rest], dim=1)   # (P, K, 3)
    rgb = shlib.sh_to_rgb_clamped(active_sh_degree, shs, means, camera.campos)

    return ProcessedGaussians(
        mean2d=mean2d,
        depth=p_view_z,
        conic=conic,
        opacity=opacity,
        rgb=rgb,
        radius=radius,
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        tiles_touched=tiles,
        visible=visible,
    )


# ----------------------------------------------------------- plain backward

def _row(m, r, x, y, z):
    return m[r, 0] * x + m[r, 1] * y + m[r, 2] * z + m[r, 3]


def _pass_min(v, lim, g):
    """The gradient torch.minimum(v, lim) passes to ``v``."""
    return torch.where(v > lim, 0.0, torch.where(v == lim, g / 2, g))


def _pass_max(v, lim, g):
    """The gradient torch.maximum(v, lim) passes to ``v``."""
    return torch.where(v < lim, 0.0, torch.where(v == lim, g / 2, g))


def _sh_basis(deg, x, y, z):
    """The SH basis of degree <= 3 at unit directions, as core/sh.py forms
    it; b[1] and b[3] enter the sum subtracted."""
    b = [shlib.C0]
    if deg > 0:
        b += [shlib.C1 * y, shlib.C1 * z, shlib.C1 * x]
    if deg > 1:
        C2 = shlib.C2
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        b += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
              C2[3] * xz, C2[4] * (xx - yy)]
        if deg > 2:
            C3 = shlib.C3
            b += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
                  C3[2] * y * (4.0 * zz - xx - yy),
                  C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  C3[4] * x * (4.0 * zz - xx - yy), C3[5] * z * (xx - yy),
                  C3[6] * x * (xx - 3.0 * yy)]
    return b


def preprocess_bwd_torch(
    xyz, features_dc, features_rest, scaling, rotation, opacity,
    camera: Camera, active_sh_degree: int, scale_modifier: float,
    g_mean2d, g_depth, g_conic, g_opacity, g_rgb,
):
    """The gradients of the differentiable outputs of
    ``preprocess_fwd_torch`` (mean2d, depth, conic, opacity, rgb, whose
    cotangents are ``g_*``), derived by hand in the order of
    ``csrc/preprocess_bwd.cu``: (d xyz, d features_dc, d features_rest,
    d scaling, d rotation, d opacity, d mean2d_offset)."""
    vm, pm = camera.viewmatrix, camera.projmatrix
    mx, my, mz = xyz.unbind(-1)
    deg = active_sh_degree

    # the forward's intermediates, recomputed (csrc/preprocess_math.cuh)
    op = torch.sigmoid(opacity[:, 0])
    sc = torch.exp(scaling).unbind(-1)
    qraw = rotation.unbind(-1)
    qn = torch.sqrt(torch.sum(rotation**2, dim=-1) + 1e-24)
    r, x, y, z = (c / qn for c in qraw)
    hom_x, hom_y, p_w = (_row(pm, k, mx, my, mz) for k in (0, 1, 3))
    inv_w = 1.0 / (torch.clamp_min(p_w, 1e-3) + 1e-7)
    R = [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
         2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
         2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)]
    s = [c * scale_modifier for c in sc]
    M = [R[3 * i + j] * s[j] for i in range(3) for j in range(3)]
    S = [M[0] * M[0] + M[1] * M[1] + M[2] * M[2],
         M[0] * M[3] + M[1] * M[4] + M[2] * M[5],
         M[0] * M[6] + M[1] * M[7] + M[2] * M[8],
         M[3] * M[3] + M[4] * M[4] + M[5] * M[5],
         M[3] * M[6] + M[4] * M[7] + M[5] * M[8],
         M[6] * M[6] + M[7] * M[7] + M[8] * M[8]]
    t = [_row(vm, k, mx, my, mz) for k in range(3)]
    tz = torch.clamp_min(t[2], 0.01)
    lim = (1.3 * camera.tanfovx, 1.3 * camera.tanfovy)
    u = [t[k] / tz for k in range(2)]
    mxv = [torch.maximum(u[k], -lim[k]) for k in range(2)]
    cl = [torch.minimum(mxv[k], lim[k]) for k in range(2)]
    tx, ty = cl[0] * tz, cl[1] * tz
    W = [[vm[i, j] for j in range(3)] for i in range(3)]
    a = []
    for i in range(3):
        w0, w1, w2 = W[i]
        a += [w0 * S[0] + w1 * S[1] + w2 * S[2],
              w0 * S[1] + w1 * S[3] + w2 * S[4],
              w0 * S[2] + w1 * S[4] + w2 * S[5]]
    VI, VJ = (0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2)
    V = [a[3 * i] * W[j][0] + a[3 * i + 1] * W[j][1] + a[3 * i + 2] * W[j][2]
         for i, j in zip(VI, VJ)]
    fx, fy = camera.focal_x, camera.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j11 = fx * inv_z, fy * inv_z
    j02, j12 = -fx * tx * inv_z2, -fy * ty * inv_z2
    cxx = j00 * j00 * V[0] + 2.0 * j00 * j02 * V[2] + j02 * j02 * V[5] + 0.3
    cxy = j00 * j11 * V[1] + j00 * j12 * V[2] + j02 * j11 * V[4] + j02 * j12 * V[5]
    cyy = j11 * j11 * V[3] + 2.0 * j11 * j12 * V[4] + j12 * j12 * V[5] + 0.3
    det = cxx * cyy - cxy * cxy
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)

    gm2x, gm2y = g_mean2d.unbind(-1)
    gca, gcb, gcc = g_conic.unbind(-1)
    d_opacity = (g_opacity * (1.0 - op) * op)[:, None]

    # depth = t2 and the projection: ndc = hom * inv_w
    dndc_x = gm2x * 0.5 * camera.width
    dndc_y = gm2y * 0.5 * camera.height
    d_hom_x, d_hom_y = dndc_x * inv_w, dndc_y * inv_w
    d_inv_w = dndc_x * hom_x + dndc_y * hom_y
    d_den = -d_inv_w * (inv_w * inv_w)
    d_pw = torch.where(p_w >= 1e-3, d_den, 0.0)
    dxyz = [g_depth * vm[2, k] + d_hom_x * pm[0, k] + d_hom_y * pm[1, k]
            + d_pw * pm[3, k] for k in range(3)]

    # conic = (cyy, -cxy, cxx) / det_safe
    d_cxx, d_cyy, d_cxy = gcc * inv, gca * inv, -(gcb * inv)
    d_inv = gca * cyy + gcb * -cxy + gcc * cxx
    d_det = torch.where(det == 0.0, 0.0, -d_inv * (inv * inv))
    d_cxx = d_cxx + d_det * cyy
    d_cyy = d_cyy + d_det * cxx
    d_cxy = d_cxy - 2.0 * (d_det * cxy)

    # cov2d = J V J^T
    dV = [d_cxx * (j00 * j00),
          d_cxy * (j00 * j11),
          d_cxx * (2.0 * j00 * j02) + d_cxy * (j00 * j12),
          d_cyy * (j11 * j11),
          d_cxy * (j02 * j11) + d_cyy * (2.0 * j11 * j12),
          d_cxx * (j02 * j02) + d_cxy * (j02 * j12) + d_cyy * (j12 * j12)]
    d_j00 = (d_cxx * (2.0 * j00 * V[0] + 2.0 * j02 * V[2])
             + d_cxy * (j11 * V[1] + j12 * V[2]))
    d_j02 = (d_cxx * (2.0 * j00 * V[2] + 2.0 * j02 * V[5])
             + d_cxy * (j11 * V[4] + j12 * V[5]))
    d_j11 = (d_cyy * (2.0 * j11 * V[3] + 2.0 * j12 * V[4])
             + d_cxy * (j00 * V[1] + j02 * V[4]))
    d_j12 = (d_cyy * (2.0 * j11 * V[4] + 2.0 * j12 * V[5])
             + d_cxy * (j00 * V[2] + j02 * V[5]))

    # J from tz and the clamped tx, ty
    d_txy = (d_j02 * -fx * inv_z2, d_j12 * -fy * inv_z2)
    d_inv_z2 = d_j02 * (-fx * tx) + d_j12 * (-fy * ty)
    d_inv_z = d_j00 * fx + d_j11 * fy + 2.0 * inv_z * d_inv_z2
    d_tz = -d_inv_z * (inv_z * inv_z)
    d_t = []
    for k in range(2):
        d_cl = d_txy[k] * tz
        d_tz = d_tz + d_txy[k] * cl[k]
        d_u = _pass_max(u[k], -lim[k], _pass_min(mxv[k], lim[k], d_cl))
        d_t.append(d_u / tz)
        d_tz = d_tz + (-d_u * t[k]) / (tz * tz)
    d_t.append(torch.where(t[2] >= 0.01, d_tz, 0.0))
    dxyz = [dxyz[k] + d_t[0] * vm[0, k] + d_t[1] * vm[1, k] + d_t[2] * vm[2, k]
            for k in range(3)]

    # V = W S W^T through the rows a_i of W S
    da = [torch.zeros_like(mx) for _ in range(9)]
    for k in range(6):
        for c in range(3):
            da[3 * VI[k] + c] = da[3 * VI[k] + c] + dV[k] * W[VJ[k]][c]
    dS = [torch.zeros_like(mx) for _ in range(6)]
    for i in range(3):
        w0, w1, w2 = W[i]
        a0, a1, a2 = da[3 * i], da[3 * i + 1], da[3 * i + 2]
        dS[0] = dS[0] + a0 * w0
        dS[1] = dS[1] + (a0 * w1 + a1 * w0)
        dS[2] = dS[2] + (a0 * w2 + a2 * w0)
        dS[3] = dS[3] + a1 * w1
        dS[4] = dS[4] + (a1 * w2 + a2 * w1)
        dS[5] = dS[5] + a2 * w2

    # S = M M^T, M = R diag(s), s = exp(scaling) * scale_modifier
    dM = [None] * 9
    for j in range(3):
        dM[j] = 2.0 * dS[0] * M[j] + dS[1] * M[3 + j] + dS[2] * M[6 + j]
        dM[3 + j] = dS[1] * M[j] + 2.0 * dS[3] * M[3 + j] + dS[4] * M[6 + j]
        dM[6 + j] = dS[2] * M[j] + dS[4] * M[3 + j] + 2.0 * dS[5] * M[6 + j]
    dR = [dM[k] * s[k % 3] for k in range(9)]
    d_scaling = []
    for j in range(3):
        ds = torch.zeros_like(mx)
        for i in range(3):
            ds = ds + dM[3 * i + j] * R[3 * i + j]
        d_scaling.append(ds * scale_modifier * sc[j])

    # R from the normalized quaternion, then the normalization
    dq = [2.0 * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] - y * dR[6]
                 + x * dR[7]),
          2.0 * (y * dR[1] + z * dR[2] + y * dR[3] - 2.0 * x * dR[4]
                 - r * dR[5] + z * dR[6] + r * dR[7] - 2.0 * x * dR[8]),
          2.0 * (-2.0 * y * dR[0] + x * dR[1] + r * dR[2] + x * dR[3]
                 + z * dR[5] - r * dR[6] + z * dR[7] - 2.0 * y * dR[8]),
          2.0 * (-2.0 * z * dR[0] - r * dR[1] + x * dR[2] + r * dR[3]
                 - 2.0 * z * dR[4] + y * dR[5] + x * dR[6] + y * dR[7])]
    qdot = dq[0] * qraw[0] + dq[1] * qraw[1] + dq[2] * qraw[2] + dq[3] * qraw[3]
    dq_sum = (-qdot / (qn * qn)) / (2.0 * qn)
    d_rotation = [dq[k] / qn + (2.0 * qraw[k]) * dq_sum for k in range(4)]

    # SH -> RGB: rgb = clamp_min(eval_sh + 0.5, 0)
    v = xyz - camera.campos
    vn = torch.sqrt(torch.sum(v**2, dim=-1) + 1e-20)
    dx, dy, dz = (v / vn[:, None]).unbind(-1)
    b = _sh_basis(deg, dx, dy, dz)
    n_act = (deg + 1) ** 2
    sh = [features_dc[:, 0]] + [features_rest[:, k - 1] for k in range(1, n_act)]
    res = b[0] * sh[0]
    for k in range(1, n_act):
        term = b[k][:, None] * sh[k]
        res = res - term if k in (1, 3) else res + term
    d_res = torch.where(res + 0.5 >= 0.0, g_rgb, 0.0)
    d_dc = (shlib.C0 * d_res)[:, None]
    d_rest = torch.zeros_like(features_rest)
    w = [None] * n_act
    for k in range(1, n_act):
        w[k] = (d_res[:, 0] * sh[k][:, 0] + d_res[:, 1] * sh[k][:, 1]
                + d_res[:, 2] * sh[k][:, 2])
        bk = -b[k] if k in (1, 3) else b[k]
        d_rest[:, k - 1] = bk[:, None] * d_res
    dd = [torch.zeros_like(mx) for _ in range(3)]
    C1, C2, C3 = shlib.C1, shlib.C2, shlib.C3
    if deg > 0:
        dd[1] = dd[1] - C1 * w[1]
        dd[2] = dd[2] + C1 * w[2]
        dd[0] = dd[0] - C1 * w[3]
    if deg > 1:
        dd[0] = dd[0] + (C2[0] * dy) * w[4]
        dd[1] = dd[1] + (C2[0] * dx) * w[4]
        dd[1] = dd[1] + (C2[1] * dz) * w[5]
        dd[2] = dd[2] + (C2[1] * dy) * w[5]
        dd[0] = dd[0] + (C2[2] * (-2.0 * dx)) * w[6]
        dd[1] = dd[1] + (C2[2] * (-2.0 * dy)) * w[6]
        dd[2] = dd[2] + (C2[2] * (4.0 * dz)) * w[6]
        dd[0] = dd[0] + (C2[3] * dz) * w[7]
        dd[2] = dd[2] + (C2[3] * dx) * w[7]
        dd[0] = dd[0] + (C2[4] * (2.0 * dx)) * w[8]
        dd[1] = dd[1] + (C2[4] * (-2.0 * dy)) * w[8]
    if deg > 2:
        xx, yy, zz = dx * dx, dy * dy, dz * dz
        xy, yz, xz = dx * dy, dy * dz, dx * dz
        dd[0] = dd[0] + (C3[0] * (6.0 * xy)) * w[9]
        dd[1] = dd[1] + (C3[0] * (3.0 * xx - 3.0 * yy)) * w[9]
        dd[0] = dd[0] + (C3[1] * yz) * w[10]
        dd[1] = dd[1] + (C3[1] * xz) * w[10]
        dd[2] = dd[2] + (C3[1] * xy) * w[10]
        dd[0] = dd[0] + (C3[2] * (-2.0 * xy)) * w[11]
        dd[1] = dd[1] + (C3[2] * (4.0 * zz - xx - 3.0 * yy)) * w[11]
        dd[2] = dd[2] + (C3[2] * (8.0 * yz)) * w[11]
        dd[0] = dd[0] + (C3[3] * (-6.0 * xz)) * w[12]
        dd[1] = dd[1] + (C3[3] * (-6.0 * yz)) * w[12]
        dd[2] = dd[2] + (C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)) * w[12]
        dd[0] = dd[0] + (C3[4] * (4.0 * zz - 3.0 * xx - yy)) * w[13]
        dd[1] = dd[1] + (C3[4] * (-2.0 * xy)) * w[13]
        dd[2] = dd[2] + (C3[4] * (8.0 * xz)) * w[13]
        dd[0] = dd[0] + (C3[5] * (2.0 * xz)) * w[14]
        dd[1] = dd[1] + (C3[5] * (-2.0 * yz)) * w[14]
        dd[2] = dd[2] + (C3[5] * (xx - yy)) * w[14]
        dd[0] = dd[0] + (C3[6] * (3.0 * xx - 3.0 * yy)) * w[15]
        dd[1] = dd[1] + (C3[6] * (-6.0 * xy)) * w[15]
    # d = v / n, n = sqrt(|v|^2 + 1e-20), v = xyz - campos
    vx, vy, vz = v.unbind(-1)
    vdot = dd[0] * vx + dd[1] * vy + dd[2] * vz
    dv_sum = (-vdot / (vn * vn)) / (2.0 * vn)
    d_xyz = torch.stack([dxyz[k] + (dd[k] / vn + (2.0 * vc) * dv_sum)
                         for k, vc in enumerate((vx, vy, vz))], dim=-1)
    return (d_xyz, d_dc, d_rest, torch.stack(d_scaling, dim=-1),
            torch.stack(d_rotation, dim=-1), d_opacity, g_mean2d)


# ------------------------------------------------------------------ kernels

def pack_camera(camera: Camera) -> torch.Tensor:
    """The (CAM_LEN,) camera the kernels read: the view and full projection
    matrices row-major, the camera centre, the focal lengths and the
    1.3 tan(fov / 2) clamp limits, made by torch ops on the camera's device
    so that they round as in the plain version (no host read)."""
    return torch.cat([
        camera.viewmatrix.reshape(16), camera.projmatrix.reshape(16),
        camera.campos.reshape(3),
        torch.stack([camera.focal_x, camera.focal_y, 1.3 * camera.tanfovx,
                     1.3 * camera.tanfovy]).reshape(4),
    ])


def _checked(deg, **named):
    """(P, n_rest) after checking that every named tensor (None skipped) is
    contiguous, float32 (``alive`` bool), of its shape and on the device of
    ``xyz``, which must be a CUDA device; raises ValueError otherwise."""
    xyz, f_rest = named["xyz"], named["f_rest"]
    if xyz.dim() != 2 or f_rest.dim() != 3:
        raise ValueError(f"xyz must be (P, 3) and f_rest (P, n_rest, 3), got "
                         f"{tuple(xyz.shape)} and {tuple(f_rest.shape)}")
    P, n_rest = xyz.shape[0], f_rest.shape[1]
    shapes = dict(xyz=(P, 3), f_dc=(P, 1, 3), f_rest=(P, n_rest, 3),
                  scaling=(P, 3), rotation=(P, 4), opacity=(P, 1), alive=(P,),
                  offset=(P, 2), cam=(CAM_LEN,), g_mean2d=(P, 2), g_depth=(P,),
                  g_conic=(P, 3), g_opacity=(P,), g_rgb=(P, 3))
    for name, t in named.items():
        if t is None:
            continue
        dtype = torch.bool if name == "alive" else torch.float32
        if (t.dtype != dtype or tuple(t.shape) != shapes[name]
                or not t.is_contiguous() or t.device != xyz.device):
            raise ValueError(
                f"{name} must be contiguous {dtype} {shapes[name]} on "
                f"{xyz.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if xyz.device.type != "cuda":
        raise ValueError(f"the preprocess kernels need CUDA tensors, got {xyz.device}")
    if not 0 <= deg <= MAX_DEGREE or (deg + 1) ** 2 - 1 > n_rest:
        raise ValueError(f"SH degree {deg} needs 0 <= degree <= {MAX_DEGREE} "
                         f"and {(deg + 1) ** 2 - 1} <= {n_rest} coefficients")
    if P >= 2**31:
        raise ValueError("the kernels take fewer than 2^31 Gaussians")
    return P, n_rest


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def preprocess_fwd(xyz, f_dc, f_rest, scaling, rotation, opacity, alive, cam,
                   width, height, active_sh_degree, tile_size=16,
                   scale_modifier=1.0, near_plane=0.2, offset=None):
    """Launch the forward kernel on the raw parameters and the packed camera
    ``cam`` (``pack_camera``): every field of ``ProcessedGaussians``."""
    P, n_rest = _checked(active_sh_degree, xyz=xyz, f_dc=f_dc, f_rest=f_rest,
                         scaling=scaling, rotation=rotation, opacity=opacity,
                         alive=alive, offset=offset, cam=cam)
    i32 = dict(dtype=torch.int32, device=xyz.device)
    out = ProcessedGaussians(
        mean2d=xyz.new_empty((P, 2)), depth=xyz.new_empty((P,)),
        conic=xyz.new_empty((P, 3)), opacity=xyz.new_empty((P,)),
        rgb=xyz.new_empty((P, 3)), radius=torch.empty((P,), **i32),
        rect_min=torch.empty((P, 2), **i32), rect_max=torch.empty((P, 2), **i32),
        tiles_touched=torch.empty((P,), **i32),
        visible=torch.empty((P,), dtype=torch.bool, device=xyz.device),
    )
    kernels.launch(
        "preprocess_fwd", _FWD_ARGS,
        *(_ptr(t) for t in (xyz, f_dc, f_rest, scaling, rotation, opacity,
                            alive, offset, cam)),
        *(getattr(out, f.name).data_ptr()
          for f in dataclasses.fields(ProcessedGaussians)),
        P, n_rest, active_sh_degree, width, height, tile_size,
        scale_modifier, near_plane, _stream(xyz.device),
    )
    preprocess_fwd.launches += 1
    return out


def preprocess_bwd(xyz, f_dc, f_rest, scaling, rotation, opacity, cam,
                   width, height, active_sh_degree, scale_modifier,
                   g_mean2d, g_depth, g_conic, g_opacity, g_rgb,
                   with_offset=True):
    """Launch the backward kernel: the gradients of the differentiable
    outputs' cotangents ``g_*``, in ``preprocess_bwd_torch``'s order (d
    mean2d_offset None unless ``with_offset``)."""
    P, n_rest = _checked(active_sh_degree, xyz=xyz, f_dc=f_dc, f_rest=f_rest,
                         scaling=scaling, rotation=rotation, opacity=opacity,
                         cam=cam, g_mean2d=g_mean2d, g_depth=g_depth,
                         g_conic=g_conic, g_opacity=g_opacity, g_rgb=g_rgb)
    grads = [torch.empty_like(t) for t in (xyz, f_dc, f_rest, scaling,
                                           rotation, opacity)]
    grads.append(torch.empty_like(g_mean2d) if with_offset else None)
    kernels.launch(
        "preprocess_bwd", _BWD_ARGS,
        *(_ptr(t) for t in (xyz, f_dc, f_rest, scaling, rotation, opacity, cam,
                            g_mean2d, g_depth, g_conic, g_opacity, g_rgb)),
        *(_ptr(t) for t in grads),
        P, n_rest, active_sh_degree, width, height, scale_modifier,
        _stream(xyz.device),
    )
    preprocess_bwd.launches += 1
    return tuple(grads)


preprocess_fwd.launches = 0
preprocess_bwd.launches = 0


class _Preprocess(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, f_dc, f_rest, scaling, rotation, opacity, offset,
                alive, camera, deg, tile_size, scale_modifier, near_plane,
                plain):
        if plain:
            cam = None
            proc = preprocess_fwd_torch(
                xyz, f_dc, f_rest, scaling, rotation, opacity, alive, camera,
                deg, tile_size, scale_modifier, near_plane, offset)
        else:
            cam = pack_camera(camera)
            proc = preprocess_fwd(
                xyz, f_dc, f_rest, scaling, rotation, opacity, alive, cam,
                camera.width, camera.height, deg, tile_size, scale_modifier,
                near_plane, offset)
        ctx.save_for_backward(xyz, f_dc, f_rest, scaling, rotation, opacity, cam)
        ctx.camera = camera
        ctx.args = (deg, scale_modifier, plain, offset is not None)
        outs = tuple(getattr(proc, f.name)
                     for f in dataclasses.fields(ProcessedGaussians))
        ctx.mark_non_differentiable(*(getattr(proc, k) for k in _INT_FIELDS))
        return outs

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, g_opacity, g_rgb, *_):
        xyz, f_dc, f_rest, scaling, rotation, opacity, cam = ctx.saved_tensors
        deg, scale_modifier, plain, with_offset = ctx.args
        cot = [g.contiguous() for g in (g_mean2d, g_depth, g_conic, g_opacity, g_rgb)]
        if plain:
            grads = preprocess_bwd_torch(xyz, f_dc, f_rest, scaling, rotation,
                                         opacity, ctx.camera, deg,
                                         scale_modifier, *cot)
            grads = grads[:6] + (grads[6] if with_offset else None,)
        else:
            grads = preprocess_bwd(xyz, f_dc, f_rest, scaling, rotation,
                                   opacity, cam, ctx.camera.width,
                                   ctx.camera.height, deg, scale_modifier,
                                   *cot, with_offset=with_offset)
        return grads + (None,) * 7


def preprocess(
    params: GaussianParams,
    camera: Camera,
    active_sh_degree: int,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    near_plane: float = 0.2,
    mean2d_offset: torch.Tensor | None = None,
) -> ProcessedGaussians:
    """Every field of ``ProcessedGaussians``, differentiable in the six
    parameter groups and ``mean2d_offset`` through mean2d, depth, conic,
    opacity and rgb: the kernels on CUDA tensors, the plain versions on CPU
    tensors."""
    dev = params.xyz.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"preprocess: unsupported device {dev}")
    outs = _Preprocess.apply(
        params.xyz, params.features_dc, params.features_rest, params.scaling,
        params.rotation, params.opacity, mean2d_offset, params.alive, camera,
        active_sh_degree, tile_size, scale_modifier, near_plane,
        dev.type == "cpu")
    return ProcessedGaussians(*outs)
