"""The plain PyTorch versions of the forward tile blend (kernel K1) and of
its backward (kernel K2).

Both walk every tile's ``[start, end)`` range of the sorted pair stream
chunk by chunk, all tiles at once: chunk c of every tile is rows
``start + c*chunk ...``, masked at ``end``.  The tests use them, and
``chip_smoke.py`` holds the CUDA kernels against them.  Nothing on the CUDA
path calls them.
"""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.render import blend_math
from luciddreamer_tpu_torch.render.binning import (
    A_B, A_CA, A_CB, A_CC, A_DEPTH, A_G, A_OP, A_R, A_VALID, A_X, A_Y,
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


def blend_tiles_bwd_torch(
    attrs: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    state: torch.Tensor,
    d_state: torch.Tensor,
    grid_x: int,
    tile_size: int,
    chunk: int,
) -> torch.Tensor:
    """The plain version of K2: the (pair_cap, 16) gradient of ``attrs``.

    ``state`` is the forward's (num_tiles, 7, tile_size^2) saved state (T,
    r, g, b, depth, acc, done) and ``d_state`` its cotangent.  An explicit
    front-to-back chunk walk over all tiles at once, the twin of
    ``luciddreamer_tpu/render/pallas_blend.py::_bwd_chunk_body``: it
    recomputes alpha, the commit set and T_before per chunk, takes the
    suffix sum_{j>i} w_j q_j as the saved total minus a running prefix, and
    reduces each pair's 10 gradient values over its tile's pixels.  It holds
    one chunk's (tiles, chunk, pixels) tensors at a time.  Rows of pairs that
    were not committed, rows after a tile's latch and rows outside every
    tile range are zero; columns 10-15 are zero.
    """
    num_tiles = tile_start.shape[0]
    dev = attrs.device
    px, py = pixel_coords(num_tiles, grid_x, tile_size, dev)
    px, py = px[:, None, :], py[:, None, :]                     # (T, 1, N)
    start = tile_start.to(torch.int64)[:, None]
    end = tile_end.to(torch.int64)[:, None]
    g_t, g_r, g_g, g_b, g_d, g_acc = (d_state[:, i, None, :] for i in range(6))
    t_fin = state[:, 0, None, :]
    wq_total = (g_r * state[:, 1, None] + g_g * state[:, 2, None]
                + g_b * state[:, 3, None] + g_d * state[:, 4, None]
                + g_acc * (state[:, 5, None] - 1e-6))           # (T, 1, N)
    t_run = torch.ones_like(t_fin)
    wq_run = torch.zeros_like(t_fin)
    done_run = torch.zeros_like(t_fin, dtype=torch.bool)
    out = torch.zeros_like(attrs)
    longest = int((end - start).max()) if num_tiles else 0
    k = torch.arange(chunk, device=dev)
    for c0 in range(0, longest, chunk):
        rows = start + c0 + k                                   # (T, K)
        live = rows < end
        a = attrs[torch.where(live, rows, 0)]                   # (T, K, 16)
        col = lambda i: a[..., i, None]                         # (T, K, 1)
        dx, dy = col(A_X) - px, col(A_Y) - py
        ca, cb, cc = col(A_CA), col(A_CB), col(A_CC)
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        G = torch.exp(torch.clamp_max(power, 0.0))
        alpha_raw = col(A_OP) * G
        alpha = torch.clamp_max(alpha_raw, blend_math.ALPHA_CLAMP)
        valid = (live[..., None] & (col(A_VALID) > 0.5) & (power <= 0.0)
                 & (alpha >= blend_math.ALPHA_MIN))
        a_eff = torch.where(valid, alpha, torch.zeros_like(alpha))
        incl = torch.cumprod(1.0 - a_eff, dim=1)                # prod_{j<=i}
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        t_before = t_run * excl
        done_after = done_run | (t_run * incl < blend_math.T_MIN)
        commit = valid & ~done_after
        w = torch.where(commit, a_eff * t_before, torch.zeros_like(a_eff))
        q = (g_r * col(A_R) + g_g * col(A_G) + g_b * col(A_B)
             + g_d * col(A_DEPTH) + g_acc)
        wq = w * q
        suffix = wq_total - (wq_run + torch.cumsum(wq, dim=1))
        dalpha = torch.where(
            commit,
            t_before * q - (suffix + g_t * t_fin) * (1.0 / (1.0 - a_eff)),
            torch.zeros_like(a_eff),
        )
        dpower = alpha_raw * dalpha
        red = lambda v: v.sum(dim=2)                            # over pixels
        vals = torch.stack([
            red(dpower * -(ca * dx + cb * dy)),
            red(dpower * -(cc * dy + cb * dx)),
            red(dpower * (-0.5 * dx * dx)),
            red(dpower * (-dx * dy)),
            red(dpower * (-0.5 * dy * dy)),
            red(G * dalpha),
            red(w * g_r), red(w * g_g), red(w * g_b), red(w * g_d),
        ], dim=-1)                                              # (T, K, 10)
        out[rows[live], :10] = vals[live]
        t_run = t_run * torch.amin(
            torch.where(commit, incl, torch.ones_like(incl)), dim=1, keepdim=True
        )
        wq_run = wq_run + wq.sum(dim=1, keepdim=True)
        done_run = done_after[:, -1:]
    return out


def tilemajor_to_image(x: torch.Tensor, grid_x: int, grid_y: int,
                       tile_size: int, height: int, width: int) -> torch.Tensor:
    """(..., num_tiles, ts*ts) tile-major -> (..., H, W) image crop."""
    lead = x.shape[:-2]
    x = x[..., : grid_x * grid_y, :]
    x = x.reshape(lead + (grid_y, grid_x, tile_size, tile_size))
    x = x.transpose(-3, -2)
    x = x.reshape(lead + (grid_y * tile_size, grid_x * tile_size))
    return x[..., :height, :width]
