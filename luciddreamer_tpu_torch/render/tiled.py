"""Tiled renderer: preprocess -> binning -> tile blend -> image.

Differentiable end to end.  Backends:
  * ``cuda``  - the hand-written blend kernels K1 (forward) and K2
                (backward) of render.cuda_blend, which read the sorted
                pairs' attribute rows through the sort's owner index; for
                tensors on the CPU the same autograd Function runs their
                plain versions;
  * ``torch`` - the plain PyTorch forward and backward blend
                (render.torch_blend) on any device, through the same
                Function.
The VJP of the row reads (render.binning.gather_vjp) launches K3 on CUDA
tensors under either backend.
"""
from __future__ import annotations

import math

import torch

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams
from luciddreamer_tpu_torch.render import blend_math, cuda_blend, torch_blend
from luciddreamer_tpu_torch.render.binning import build_tile_bins, num_tiles_for
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians


def default_pair_capacity(capacity: int, multiplier: float = 8.0) -> int:
    """Static pair budget, with a floor of 4096 so small scenes do not
    overflow on dense screen coverage."""
    return max(4096, int(capacity * multiplier))


def aligned_pair_capacity(pair_cap: int, chunk: int) -> int:
    """The pair slots ``render_tiled`` holds for a budget of ``pair_cap``:
    the JAX package's alignment (luciddreamer_tpu/render/tiled.py:60-68),
    so that both hold the same capacity and overflow on the same scenes:
    lcm(chunk, 1024) from 1024 up, chunk below so tiny caps still overflow."""
    align = math.lcm(chunk, 1024) if pair_cap >= 1024 else chunk
    return ((pair_cap + align - 1) // align) * align


def render_tiled(
    params: GaussianParams,
    camera: Camera,
    bg: torch.Tensor,
    active_sh_degree: int = 3,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    chunk: int = 384,
    pair_cap: int | None = None,
    backend: str = "cuda",
    mean2d_offset: torch.Tensor | None = None,
):
    """Render RGB + depth through the tiled path.

    Returns render (3,H,W), depth, acc, final_T, n_contrib (H,W), radii,
    visibility_filter, mean2d, ``overflow`` (pair capacity exceeded ->
    image invalid; render again with a larger ``pair_cap``) and num_pairs.
    """
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    H, W = camera.height, camera.width
    grid_x, grid_y = num_tiles_for(H, W, tile_size)
    if pair_cap is None:
        pair_cap = default_pair_capacity(params.capacity)
    pair_cap = aligned_pair_capacity(pair_cap, chunk)

    proc = preprocess_gaussians(
        params, camera, active_sh_degree, tile_size, scale_modifier,
        mean2d_offset=mean2d_offset,
    )
    bins = build_tile_bins(proc, H, W, tile_size, pair_cap)
    carry = cuda_blend.blend_tiles(bins, grid_x, tile_size, chunk,
                                   plain=backend == "torch")
    rgb, depth = blend_math.finalize(carry, bg)

    def to_img(x):
        return torch_blend.tilemajor_to_image(
            x, grid_x, grid_y, tile_size, H, W
        )

    return {
        "render": to_img(rgb.transpose(0, 1)),
        "depth": to_img(depth),
        "acc": to_img(carry.acc),
        "final_T": to_img(carry.T),
        "n_contrib": to_img(carry.n_contrib),
        "radii": proc.radius,
        "visibility_filter": proc.radius > 0,
        "mean2d": proc.mean2d,
        "overflow": bins.overflow,
        "num_pairs": bins.num_pairs,
    }
