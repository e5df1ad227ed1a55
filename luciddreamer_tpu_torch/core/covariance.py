"""Gaussian covariance math: 3D covariance from scale and quaternion, EWA
2D projection, conic and screen-space extent.

Written elementwise, as the JAX package does: no batched 3x3 products, so
the arithmetic and its rounding follow the reference function term by term.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z), already normalized -> (..., 3, 3) rotation."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
            2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
            2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def build_cov3d(scale: torch.Tensor, quat: torch.Tensor, scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space covariance Sigma = R S^2 R^T, packed symmetric.

    scale: (..., 3) activated scales; quat: (..., 4) normalized.
    Returns (..., 6): (xx, xy, xz, yy, yz, zz).
    """
    r, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    sx = scale[..., 0] * scale_modifier
    sy = scale[..., 1] * scale_modifier
    sz = scale[..., 2] * scale_modifier
    # M = R @ diag(s)
    m00 = (1.0 - 2.0 * (y * y + z * z)) * sx
    m01 = (2.0 * (x * y - r * z)) * sy
    m02 = (2.0 * (x * z + r * y)) * sz
    m10 = (2.0 * (x * y + r * z)) * sx
    m11 = (1.0 - 2.0 * (x * x + z * z)) * sy
    m12 = (2.0 * (y * z - r * x)) * sz
    m20 = (2.0 * (x * z - r * y)) * sx
    m21 = (2.0 * (y * z + r * x)) * sy
    m22 = (1.0 - 2.0 * (x * x + y * y)) * sz
    c_xx = m00 * m00 + m01 * m01 + m02 * m02
    c_xy = m00 * m10 + m01 * m11 + m02 * m12
    c_xz = m00 * m20 + m01 * m21 + m02 * m22
    c_yy = m10 * m10 + m11 * m11 + m12 * m12
    c_yz = m10 * m20 + m11 * m21 + m12 * m22
    c_zz = m20 * m20 + m21 * m21 + m22 * m22
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def project_cov3d_to_2d(
    mean: torch.Tensor,
    cov3d: torch.Tensor,
    viewmatrix: torch.Tensor,
    focal_x,
    focal_y,
    tanfovx,
    tanfovy,
) -> torch.Tensor:
    """EWA projection of the 3D covariance to screen space.

    mean: (..., 3) world means; cov3d: (..., 6) packed; viewmatrix: (4,4) w2c.
    Returns (..., 3): (cov_xx, cov_xy, cov_yy) with the +0.3 low-pass.
    The view-space x/y are clamped at 1.3 * tanfov before the Jacobian.
    """
    W = viewmatrix[:3, :3]
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    t0 = W[0, 0] * mx + W[0, 1] * my + W[0, 2] * mz + viewmatrix[0, 3]
    t1 = W[1, 0] * mx + W[1, 1] * my + W[1, 2] * mz + viewmatrix[1, 3]
    t2 = W[2, 0] * mx + W[2, 1] * my + W[2, 2] * mz + viewmatrix[2, 3]
    # culled rows (tz <= 0.2) are masked downstream; the clamp keeps 1/tz
    # finite for them, visible rows are unchanged
    tz = torch.clamp_min(t2, 0.01)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tx = torch.minimum(torch.maximum(t0 / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t1 / tz, -limy), limy) * tz

    # V = W Sigma W^T over the symmetric packing
    s = cov3d
    sxx, sxy, sxz = s[..., 0], s[..., 1], s[..., 2]
    syy, syz, szz = s[..., 3], s[..., 4], s[..., 5]

    def wsig_row(i):
        a0 = W[i, 0] * sxx + W[i, 1] * sxy + W[i, 2] * sxz
        a1 = W[i, 0] * sxy + W[i, 1] * syy + W[i, 2] * syz
        a2 = W[i, 0] * sxz + W[i, 1] * syz + W[i, 2] * szz
        return a0, a1, a2

    a00, a01, a02 = wsig_row(0)
    a10, a11, a12 = wsig_row(1)
    a20, a21, a22 = wsig_row(2)
    v00 = a00 * W[0, 0] + a01 * W[0, 1] + a02 * W[0, 2]
    v01 = a00 * W[1, 0] + a01 * W[1, 1] + a02 * W[1, 2]
    v02 = a00 * W[2, 0] + a01 * W[2, 1] + a02 * W[2, 2]
    v11 = a10 * W[1, 0] + a11 * W[1, 1] + a12 * W[1, 2]
    v12 = a10 * W[2, 0] + a11 * W[2, 1] + a12 * W[2, 2]
    v22 = a20 * W[2, 0] + a21 * W[2, 1] + a22 * W[2, 2]

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j11 = focal_y * inv_z
    j02 = -focal_x * tx * inv_z2
    j12 = -focal_y * ty * inv_z2

    # cov2d = J V J^T with J = [[j00, 0, j02], [0, j11, j12]]
    c_xx = j00 * j00 * v00 + 2.0 * j00 * j02 * v02 + j02 * j02 * v22 + 0.3
    c_xy = j00 * j11 * v01 + j00 * j12 * v02 + j02 * j11 * v12 + j02 * j12 * v22
    c_yy = j11 * j11 * v11 + 2.0 * j11 * j12 * v12 + j12 * j12 * v22 + 0.3
    return torch.stack([c_xx, c_xy, c_yy], dim=-1)


def invert_cov2d(cov2d: torch.Tensor):
    """(cov_xx, cov_xy, cov_yy) -> conic (a, b, c) and determinant."""
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv = 1.0 / det_safe
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], dim=-1)
    return conic, det


def cov2d_max_sigma(cov2d: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """sqrt of the max eigenvalue of the 2x2 screen covariance."""
    cxx, cyy = cov2d[..., 0], cov2d[..., 2]
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    return torch.sqrt(torch.clamp_min(mid + disc, 0.0))


def cov2d_extent_radius(cov2d: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Screen-space radius = ceil(3 * sqrt(max eigenvalue))."""
    return torch.ceil(3.0 * cov2d_max_sigma(cov2d, det))
