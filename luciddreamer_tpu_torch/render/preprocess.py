"""Per-Gaussian preprocessing: cull, project, conic, SH->RGB, tile rect.

Batched and differentiable; culled Gaussians are masked, not removed, so
every output keeps the capacity ``P``.
"""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.core import covariance, sh as shlib
from luciddreamer_tpu_torch.core.transforms import ndc2pix
from luciddreamer_tpu_torch.core.types import Camera, GaussianParams, ProcessedGaussians


def _tile_coord(v: torch.Tensor, grid: int) -> torch.Tensor:
    """clip(int32(v), 0, grid) with the JAX package's saturating float->int
    conversion (NaN -> 0, +-inf saturate), which a C cast on the CPU leaves
    undefined.  Clamping before the truncation gives the same integers."""
    return torch.nan_to_num(v, nan=0.0).clamp(0, grid).to(torch.int32)


def preprocess_gaussians(
    params: GaussianParams,
    camera: Camera,
    active_sh_degree: int,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    near_plane: float = 0.2,
    mean2d_offset: torch.Tensor | None = None,
) -> ProcessedGaussians:
    """Compute screen-space quantities for every Gaussian (masked)."""
    means = params.xyz                              # (P, 3)
    opacity = params.get_opacity()[..., 0]          # (P,)
    scales = params.get_scaling()
    quats = params.get_rotation()
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

        visible = in_front & det_ok & (tiles_ref > 0) & params.alive
        tiles = torch.where(visible, tiles, torch.zeros_like(tiles))
        radius = torch.where(
            visible, radius_f, torch.zeros_like(radius_f)
        ).to(torch.int32)

    # --- SH -> RGB ---
    shs = params.get_features()                     # (P, K, 3)
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
