"""Tile binning: (Gaussian, tile) pair expansion, the (tile, depth) sort,
and the deterministic VJP of the blend's attribute row reads.

1. a dense depth rank in (depth bits, index) order: for positive floats the
   IEEE-754 bit order is the value order, and the index breaks ties;
2. pair expansion into a fixed ``pair_cap`` buffer: each slot finds its
   owner Gaussian by binary search over the inclusive prefix sum of
   ``tiles_touched`` and its tile from the owner's rect;
3. one stable sort of the int64 key ``tile * P + rank``, which gives
   ``src``, the row of the packed attribute table that each sorted pair
   reads (the zero sentinel row P for the empty slots);
4. per-tile ``[start, end)`` ranges by binary search over the sorted keys.

No stream-order copy of the attribute rows is made: the blend kernels read
row i of the stream as ``table[src[i]]`` themselves (``pair_rows`` builds
the copy for the plain versions and the tests).  The blend kernels walk
each tile's range themselves, so no chunk/segment metadata is built.
Integers stay int32/int64 throughout.  ``overflow`` reports a pair count
above ``pair_cap``: the slots past the cap are dropped and the image is
then invalid.

The VJP of that row read, ``gather_vjp``, is the counterpart of the custom
VJP of ``luciddreamer_tpu/render/binning.py::_expand_sort`` (no atomics, so
the gradient is deterministic); the blend's backward calls it.  Kernel K3
(``cuda_repack``) takes the (pair_cap, 16) cotangent of the rows to 10
columns in slot order through the sort's permutation, zeroing rows at or
past the pair count; one prefix sum along slots (in float64: over millions
of slots an fp32 running sum loses the digits of the per-Gaussian
differences); and one gather at the P+1 exclusive offsets, whose adjacent
differences are the per-Gaussian sums (a Gaussian's slots are
contiguous).  The prefix sum is taken in two levels, within blocks of 1024
slots and then over the block totals: one scan along each of the 10
columns of millions of slots leaves most of the card idle (PERF.md has the
times).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from luciddreamer_tpu_torch.core.types import ProcessedGaussians
from luciddreamer_tpu_torch.render import cuda_repack

ATTR_DIM = 16
A_X, A_Y, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_DEPTH, A_VALID = range(11)


class TileBins(NamedTuple):
    """The depth-sorted pair stream, as table rows read through ``src``, and
    per-tile ranges."""

    table: torch.Tensor       # (P+1, ATTR_DIM) f32 attributes, differentiable
    src: torch.Tensor         # (pair_cap,) int32 table row of each sorted pair
    order: torch.Tensor       # (pair_cap,) int64 slot of each sorted pair
    offsets_p1: torch.Tensor  # (P+1,) int64 exclusive slot offsets, then total
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


class PairOrder(NamedTuple):
    """The pair sort of one frame: what the row reads and their VJP need."""

    src: torch.Tensor         # (pair_cap,) int32 table row of each sorted pair
    order: torch.Tensor       # (pair_cap,) int64 slot of each sorted pair
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_end: torch.Tensor    # (num_tiles,) int32
    offsets_p1: torch.Tensor  # (P+1,) int64 exclusive slot offsets, then total
    total: torch.Tensor       # () int64 true pair count


@torch.no_grad()
def sort_pairs(
    proc: ProcessedGaussians,
    height: int,
    width: int,
    tile_size: int,
    pair_cap: int,
) -> PairOrder:
    """Expand the (Gaussian, tile) pairs and sort them in (tile, depth rank)
    order; integer work only."""
    grid_x, grid_y = num_tiles_for(height, width, tile_size)
    num_tiles = grid_x * grid_y
    P = proc.depth.shape[0]
    if P + 1 >= 2**31:
        raise ValueError(f"{P} Gaussians: the table's row index must fit int32")
    dev = proc.depth.device

    counts = proc.tiles_touched.to(torch.int64)
    cum = torch.cumsum(counts, dim=0)                    # inclusive
    total = cum[-1]
    offsets = cum - counts                               # exclusive

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
    # num_tiles * P and stay at the end, in slot order
    key_s, order = torch.sort(key, stable=True)
    src = torch.where(valid, g, P)[order].to(torch.int32).contiguous()
    bounds = torch.arange(num_tiles + 1, device=dev) * P
    edges = torch.searchsorted(key_s, bounds).to(torch.int32)
    return PairOrder(
        src=src, order=order,
        tile_start=edges[:-1].contiguous(), tile_end=edges[1:].contiguous(),
        offsets_p1=torch.cat([cum.new_zeros(1), cum]), total=total,
    )


def _exclusive_prefix_at(cols: torch.Tensor, at: torch.Tensor,
                         block: int = 1024) -> torch.Tensor:
    """(C, len(at)) float64 sums of ``cols[:, :s]`` for each s in ``at``
    (0 <= s <= n), by a two-level scan: within blocks of ``block`` slots,
    then over the block totals."""
    n_ch, n = cols.shape
    nb = max(1, -(-n // block))
    x = cols.new_zeros((n_ch, nb * block), dtype=torch.float64)
    x[:, :n] = cols
    incl = torch.cumsum(x.view(n_ch, nb, block), dim=2)     # within blocks
    tot = incl[:, :, -1]
    before = torch.cumsum(tot, dim=1) - tot                 # exclusive, blocks
    last = (at - 1).clamp(min=0)                            # sum to s = incl[s-1]
    val = before[:, last // block] + incl[:, last // block, last % block]
    return torch.where(at > 0, val, 0.0)


def gather_vjp(d_attrs: torch.Tensor, order: torch.Tensor,
               offsets_p1: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The (P+1, ATTR_DIM) table gradient of ``table[src]`` from its
    (pair_cap, ATTR_DIM) cotangent: K3, a prefix sum along slots and one
    boundary gather.  Columns 10-15 and the sentinel row P are zero."""
    pair_cap = d_attrs.shape[0]
    n_ch = cuda_repack.N_GRAD_CH
    cols = cuda_repack.repack_cols(d_attrs, order, total)   # (10, pair_cap)
    csb = _exclusive_prefix_at(cols, offsets_p1.clamp(max=pair_cap))
    d_rows = (csb[:, 1:] - csb[:, :-1]).to(d_attrs.dtype)   # (10, P)
    d_table = d_attrs.new_zeros((offsets_p1.shape[0], ATTR_DIM))
    d_table[:-1, :n_ch] = d_rows.t()
    return d_table


def pair_rows(table: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The (pair_cap, ATTR_DIM) stream-order rows ``table[src]`` (of a
    ``TileBins``), for the plain blend versions and the tests; the CUDA
    path never builds them."""
    return table[src]


def build_tile_bins(
    proc: ProcessedGaussians,
    height: int,
    width: int,
    tile_size: int,
    pair_cap: int,
) -> TileBins:
    """Gradients flow only through ``table``, whose rows the blend reads
    through ``src``."""
    pairs = sort_pairs(proc, height, width, tile_size, pair_cap)
    return TileBins(
        table=gaussian_attr_table(proc),
        src=pairs.src,
        order=pairs.order,
        offsets_p1=pairs.offsets_p1,
        tile_start=pairs.tile_start,
        tile_end=pairs.tile_end,
        num_pairs=pairs.total,
        overflow=pairs.total > pair_cap,
    )
