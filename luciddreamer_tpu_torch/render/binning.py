"""Tile binning, forward: (Gaussian, tile) pair expansion and the
(tile, depth) sort.

1. a dense depth rank in (depth bits, index) order: for positive floats the
   IEEE-754 bit order is the value order, and the index breaks ties;
2. pair expansion into a fixed ``pair_cap`` buffer: each slot finds its
   owner Gaussian by binary search over the inclusive prefix sum of
   ``tiles_touched`` and its tile from the owner's rect;
3. one stable sort of the int64 key ``tile * P + rank``, then one row
   gather of the packed attribute table;
4. per-tile ``[start, end)`` ranges by binary search over the sorted keys.

The blend kernel walks each tile's range itself, so no chunk/segment
metadata is built.  Integers stay int32/int64 throughout.  ``overflow``
reports a pair count above ``pair_cap``: the slots past the cap are dropped
and the image is then invalid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from luciddreamer_tpu_torch.core.types import ProcessedGaussians

ATTR_DIM = 16
A_X, A_Y, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_DEPTH, A_VALID = range(11)


class TileBins(NamedTuple):
    """Depth-sorted pair stream and per-tile ranges."""

    attrs: torch.Tensor       # (pair_cap, ATTR_DIM) f32, (tile, depth)-sorted
    tile_start: torch.Tensor  # (num_tiles,) int32 first row of each tile
    tile_end: torch.Tensor    # (num_tiles,) int32 one past its last row
    num_pairs: torch.Tensor   # () int64 true pair count
    overflow: torch.Tensor    # () bool: pair_cap exceeded -> output invalid


def num_tiles_for(height: int, width: int, tile_size: int) -> tuple[int, int]:
    return (
        (width + tile_size - 1) // tile_size,
        (height + tile_size - 1) // tile_size,
    )


def gaussian_attr_table(proc: ProcessedGaussians) -> torch.Tensor:
    """(P+1, ATTR_DIM) packed attributes; row P is the zero sentinel
    (valid = 0) that empty slots gather."""
    P = proc.depth.shape[0]
    cols = [
        proc.mean2d[:, 0], proc.mean2d[:, 1],
        proc.conic[:, 0], proc.conic[:, 1], proc.conic[:, 2],
        proc.opacity,
        proc.rgb[:, 0], proc.rgb[:, 1], proc.rgb[:, 2],
        proc.depth,
        torch.ones_like(proc.depth),                     # valid
    ]
    cols += [torch.zeros_like(proc.depth)] * (ATTR_DIM - len(cols))
    table = torch.stack(cols, dim=-1)
    return torch.cat([table, table.new_zeros((1, ATTR_DIM))])


def build_tile_bins(
    proc: ProcessedGaussians,
    height: int,
    width: int,
    tile_size: int,
    pair_cap: int,
) -> TileBins:
    """Gradients flow only through the final attribute gather."""
    grid_x, grid_y = num_tiles_for(height, width, tile_size)
    num_tiles = grid_x * grid_y
    P = proc.depth.shape[0]
    dev = proc.depth.device

    with torch.no_grad():
        counts = proc.tiles_touched.to(torch.int64)
        cum = torch.cumsum(counts, dim=0)                # inclusive
        total = cum[-1]
        offsets = cum - counts                           # exclusive

        # dense depth rank in (depth bits, index) order
        depth_bits = proc.depth.detach().contiguous().view(torch.int32)
        perm = torch.sort(depth_bits, stable=True).indices
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(P, device=dev)

        # owner of slot s: the first Gaussian whose inclusive sum exceeds s
        slot = torch.arange(pair_cap, device=dev)
        valid = slot < total
        g = torch.searchsorted(cum, slot, right=True).clamp_(max=P - 1)
        local = slot - offsets[g]
        rect_min = proc.rect_min.to(torch.int64)
        rect_w = (proc.rect_max[:, 0].to(torch.int64) - rect_min[:, 0]).clamp_(min=1)
        rw = rect_w[g]
        tx = rect_min[g, 0] + local % rw
        ty = rect_min[g, 1] + local // rw
        tile = torch.where(valid, ty * grid_x + tx, num_tiles)
        key = tile * P + torch.where(valid, rank[g], 0)

        # one stable sort: (tile, rank) order; empty slots share the key
        # num_tiles * P and stay at the end
        key_s, order = torch.sort(key, stable=True)
        src = torch.where(valid, g, P)[order]
        bounds = torch.arange(num_tiles + 1, device=dev) * P
        edges = torch.searchsorted(key_s, bounds).to(torch.int32)

    attrs = gaussian_attr_table(proc)[src]               # (pair_cap, 16)
    return TileBins(
        attrs=attrs,
        tile_start=edges[:-1].contiguous(),
        tile_end=edges[1:].contiguous(),
        num_pairs=total,
        overflow=total > pair_cap,
    )
