"""The plain PyTorch version of the forward tile blend (kernel K1).

It composites every tile's ``[start, end)`` range of the sorted pair
stream chunk by chunk with ``blend_math.blend_chunk``, all tiles at once:
chunk c of every tile is rows ``start + c*chunk ...``, masked at ``end``.
The tests use it, and ``chip_smoke.py`` holds the CUDA kernel against it.
Nothing on the CUDA path calls it.
"""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.render import blend_math
from luciddreamer_tpu_torch.render.binning import (
    A_B, A_CA, A_CB, A_CC, A_DEPTH, A_OP, A_R, A_VALID, A_X, A_Y,
)


def pixel_coords(num_tiles: int, grid_x: int, tile_size: int, device):
    """(num_tiles, tile_size^2) float pixel x and y of every tile pixel."""
    lin = torch.arange(tile_size * tile_size, device=device)
    t = torch.arange(num_tiles, device=device)[:, None]
    px = (t % grid_x) * tile_size + lin % tile_size
    py = (t // grid_x) * tile_size + lin // tile_size
    return px.to(torch.float32), py.to(torch.float32)


def blend_tiles_torch(
    attrs: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    grid_x: int,
    tile_size: int,
    chunk: int,
) -> blend_math.BlendCarry:
    """Composite every tile; returns a carry of (num_tiles, tile_size^2)
    per-pixel fields (``rgb`` is (num_tiles, 3, tile_size^2))."""
    num_tiles = tile_start.shape[0]
    npix = tile_size * tile_size
    dev = attrs.device
    px, py = pixel_coords(num_tiles, grid_x, tile_size, dev)
    px, py = px[:, None, :], py[:, None, :]                     # (T, 1, N)
    start = tile_start.to(torch.int64)[:, None]
    end = tile_end.to(torch.int64)[:, None]
    carry = blend_math.BlendCarry.init((num_tiles,), npix, device=dev)
    longest = int((end - start).max()) if num_tiles else 0
    k = torch.arange(chunk, device=dev)
    for c0 in range(0, longest, chunk):
        rows = start + c0 + k                                   # (T, K)
        live = rows < end
        a = attrs[torch.where(live, rows, 0)]                   # (T, K, 16)
        col = lambda i: a[..., i, None]                         # (T, K, 1)
        alpha, in_ellipse = blend_math.gaussian_alpha(
            col(A_X) - px, col(A_Y) - py,
            col(A_CA), col(A_CB), col(A_CC), col(A_OP),
        )
        valid = (
            live[..., None]
            & (col(A_VALID) > 0.5)
            & in_ellipse
            & (alpha >= blend_math.ALPHA_MIN)
        )
        carry = blend_math.blend_chunk(
            carry, alpha, valid, a[..., A_R:A_B + 1], a[..., A_DEPTH], c0
        )
    return carry


def tilemajor_to_image(x: torch.Tensor, grid_x: int, grid_y: int,
                       tile_size: int, height: int, width: int) -> torch.Tensor:
    """(..., num_tiles, ts*ts) tile-major -> (..., H, W) image crop."""
    lead = x.shape[:-2]
    x = x[..., : grid_x * grid_y, :]
    x = x.reshape(lead + (grid_y, grid_x, tile_size, tile_size))
    x = x.transpose(-3, -2)
    x = x.reshape(lead + (grid_y * tile_size, grid_x * tile_size))
    return x[..., :height, :width]
