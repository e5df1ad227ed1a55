"""Dense oracle renderer: exact blend semantics, O(P * pixels), autograd.

The port's own oracle for the tiled path, forward and gradients (the twin
of ``luciddreamer_tpu/render/dense.py``).  It composites all Gaussians over
all pixels in global depth order, chunk by chunk, with the per-tile
inclusion rule of the binning (a Gaussian affects only pixels whose tile
lies in its screen rect) as an explicit mask.  Each chunk is recomputed in
the backward pass, as the JAX oracle's ``jax.checkpoint`` does, so autograd
keeps one carry per chunk and the (chunk, pixels) intermediates of one
chunk at a time: it is the gradient oracle at BASELINE config 1's size
(10k Gaussians at 512x512) too.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams, ProcessedGaussians
from luciddreamer_tpu_torch.render import blend_math
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians


def _chunk_step(T, rgb, depth, acc, done, n_contrib, xy, conic, opacity,
                color, z, rmin, rmax, visible, pix_x, pix_y, tile_x, tile_y,
                c0):
    """One chunk's ``blend_chunk`` on a carry flattened to tensors, the
    form ``checkpoint`` saves and replays."""
    alpha, in_ellipse = blend_math.gaussian_alpha(
        xy[:, 0:1] - pix_x[None, :], xy[:, 1:2] - pix_y[None, :],
        conic[:, 0:1], conic[:, 1:2], conic[:, 2:3], opacity[:, None],
    )
    in_rect = (
        (tile_x >= rmin[:, 0:1]) & (tile_x < rmax[:, 0:1])
        & (tile_y >= rmin[:, 1:2]) & (tile_y < rmax[:, 1:2])
    )
    mask = (visible[:, None] & in_rect & in_ellipse
            & (alpha >= blend_math.ALPHA_MIN))
    c = blend_math.blend_chunk(
        blend_math.BlendCarry(T, rgb, depth, acc, done, n_contrib),
        alpha, mask, color, z, c0)
    return c.T, c.rgb, c.depth, c.acc, c.done, c.n_contrib


def _blend_dense(
    proc: ProcessedGaussians,
    order: torch.Tensor,
    height: int,
    width: int,
    tile_size: int,
    chunk: int,
) -> blend_math.BlendCarry:
    P = proc.depth.shape[0]
    dev = proc.depth.device
    pix_x = torch.arange(width, dtype=torch.float32, device=dev).repeat(height)
    pix_y = torch.arange(height, dtype=torch.float32, device=dev).repeat_interleave(width)
    tile_x = (pix_x / tile_size).to(torch.int32)[None, :]
    tile_y = (pix_y / tile_size).to(torch.int32)[None, :]
    c = blend_math.BlendCarry.init((), height * width, device=dev)
    carry = (c.T, c.rgb, c.depth, c.acc, c.done, c.n_contrib)
    for c0 in range(0, P, chunk):
        idx = order[c0:c0 + chunk]
        carry = checkpoint(
            _chunk_step, *carry, proc.mean2d[idx], proc.conic[idx],
            proc.opacity[idx], proc.rgb[idx], proc.depth[idx],
            proc.rect_min[idx], proc.rect_max[idx], proc.visible[idx],
            pix_x, pix_y, tile_x, tile_y, c0, use_reentrant=False)
    return blend_math.BlendCarry(*carry)


def render_dense(
    params: GaussianParams,
    camera: Camera,
    bg: torch.Tensor,
    active_sh_degree: int = 3,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    chunk: int = 64,
):
    """Render RGB + depth with the oracle path.

    Returns a dict: render (3,H,W), depth (H,W), acc (H,W), final_T (H,W),
    n_contrib (H,W), radii (P,), visibility_filter (P,), mean2d (P,2).
    """
    proc = preprocess_gaussians(
        params, camera, active_sh_degree, tile_size, scale_modifier
    )
    # a stable global depth sort is the per-tile depth order of the binning:
    # ties break by Gaussian index; culled Gaussians sort last
    depth_key = torch.where(proc.visible, proc.depth.detach(),
                            torch.full_like(proc.depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices
    carry = _blend_dense(proc, order, camera.height, camera.width,
                         tile_size, chunk)
    rgb, depth = blend_math.finalize(carry, bg)
    H, W = camera.height, camera.width
    return {
        "render": rgb.reshape(3, H, W),
        "depth": depth.reshape(H, W),
        "acc": carry.acc.reshape(H, W),
        "final_T": carry.T.reshape(H, W),
        "n_contrib": carry.n_contrib.reshape(H, W),
        "radii": proc.radius,
        "visibility_filter": proc.radius > 0,
        "mean2d": proc.mean2d,
    }
