"""What a sorted pair stream asks of the blend kernels, counted with plain
PyTorch, and synthetic pair streams that drive K1 (``csrc/blend_fwd.cu``)
and K2 (``csrc/blend_bwd.cu``) through their edges.  The smoke test on the
card and the tests use both: the counts give the kernels' bounds and show
which of K2's reduction branches a case reaches; the cases are held
against the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from luciddreamer_tpu_torch.render import blend_math, torch_blend
from luciddreamer_tpu_torch.render.binning import (
    A_CA, A_CB, A_CC, A_OP, A_VALID, A_X, A_Y, ATTR_DIM)

EDGE_GRID_X = 4                # the edge cases' image is 64x64: 16 tiles
EDGE_CASES = {
    # (range length of each of the 16 tiles, opaque wall, numpy seed)
    # ranges: empty, 1 row, and around every multiple of the kernels' batch
    # (64 rows), of half of it and of the plain walk's chunk (128)
    "ranges": ((0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 256, 257, 0,
                300, 700), False, 6),
    # opaque splats over the whole tile: every pixel latches within a few
    # rows, so the block leaves after its first batch
    "wall": ((300, 5, 64, 65, 0, 129, 300, 2, 700, 1, 128, 300, 40, 300,
              257, 3), True, 4),
}
SHARED_SHARE = 0.25            # stream rows that reuse the previous tile's rows
DECOY_ROWS = 50                # table rows no pair reads


def edge_case(name, device, dead_tail=37):
    """A synthetic pair stream over 16 tiles with the range lengths of
    ``EDGE_CASES[name]``: splats 1.5-6 px wide scattered over their tile,
    translucent (or, for a wall, wide and opaque), one row in 20 invalid,
    and ``dead_tail`` empty slots past the last range.

    The stream is given as binning gives it, a (n, 16) attribute table and
    the int32 table row ``src`` of each slot, and the table is laid out so
    that an indexing fault shows: its rows are shuffled against the
    stream; a quarter of the rows of a tile's range are rows that the
    previous tile's range reads too (one Gaussian in two tiles); it holds
    opaque decoy rows that no slot reads; and the empty slots read its last
    row, the zero sentinel.  Returns (table, src, tile_start, tile_end) on
    ``device``, made from a numpy seed."""
    lengths, wall, seed = EDGE_CASES[name]
    rng = np.random.default_rng(seed)
    ends = np.cumsum(lengths)
    starts = ends - np.asarray(lengths)
    total = int(ends[-1])
    tile = np.repeat(np.arange(len(lengths)), lengths)
    ox = (tile % EDGE_GRID_X) * 16.0
    oy = (tile // EDGE_GRID_X) * 16.0
    sigma = rng.uniform(8.0, 12.0, total) if wall else rng.uniform(1.5, 6.0, total)
    ca = 1.0 / sigma ** 2
    cc = ca * rng.uniform(0.5, 2.0, total)
    rows = np.zeros((total, ATTR_DIM), np.float32)
    rows[:, 0] = ox + rng.uniform(-2.0, 18.0, total)
    rows[:, 1] = oy + rng.uniform(-2.0, 18.0, total)
    rows[:, 2] = ca
    rows[:, 3] = rng.uniform(-0.3, 0.3, total) * np.sqrt(ca * cc)
    rows[:, 4] = cc
    rows[:, 5] = (rng.uniform(0.9, 0.97, total) if wall
                  else rng.uniform(0.02, 0.25, total))
    rows[:, 6:9] = rng.uniform(0.0, 1.0, (total, 3))
    rows[:, 9] = rng.uniform(1.0, 5.0, total)
    rows[:, 10] = rng.uniform(size=total) >= 0.05
    # the stream row each slot reads: its own, or one of the previous tile's
    owner = np.arange(total)
    shared = rng.uniform(size=total) < SHARED_SHARE
    for t in range(1, len(lengths)):
        mine = np.flatnonzero(shared[starts[t]:ends[t]]) + starts[t]
        if lengths[t - 1] > 0 and len(mine):
            owner[mine] = owner[rng.integers(starts[t - 1], ends[t - 1],
                                             len(mine))]
    unique = np.flatnonzero(owner == np.arange(total))
    n_table = len(unique) + DECOY_ROWS + 1
    place = rng.permutation(n_table - 1)     # table row of each unique row
    table = np.zeros((n_table, ATTR_DIM), np.float32)
    table[place[:len(unique)]] = rows[unique]
    decoy = place[len(unique):]
    table[decoy, 0:2] = rng.uniform(0.0, 64.0, (DECOY_ROWS, 2))
    table[decoy, 2] = table[decoy, 4] = 1.0 / 64.0
    table[decoy, 5:9] = 0.98
    table[decoy, 10] = 1.0
    row_of_stream = np.empty(total, np.int64)
    row_of_stream[unique] = place[:len(unique)]
    src = np.full(total + dead_tail, n_table - 1, np.int32)
    src[:total] = row_of_stream[owner]
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return (as_t(table, torch.float32), as_t(src, torch.int32),
            as_t(starts, torch.int32), as_t(ends, torch.int32))


def blend_work(table, src, tile_start, tile_end, grid_x, chunk=128):
    """What the blend must compute on the pair stream whose row i is
    ``table[src[i]]``, walked like the plain version.  Per pixel: the
    products evaluated before its done latch (``evaluated``), those with
    power <= 0 (one exp each, ``exps``) and the commits (``commits``).  Per
    tile: the rows before its last pixel is done (``walked``, a tensor).
    Over the (warp, row) pairs of those rows, a warp being an 8x4 block of
    the tile's pixels as in K1 and K2: those with a commit (``warp_rows``),
    with a commit on exactly one lane
    (``warp_rows_single``) and on none (``warp_rows_none``);
    ``warp_rows_strip`` counts those with a commit if a warp were a 16x2
    strip of pixels."""
    nt = tile_start.shape[0]
    px, py = torch_blend.pixel_coords(nt, grid_x, 16, table.device)
    px, py = px[:, None, :], py[:, None, :]
    start = tile_start.long()[:, None]
    end = tile_end.long()[:, None]
    T = torch.ones_like(px[:, 0])
    done = torch.zeros_like(T, dtype=torch.bool)
    work = dict.fromkeys(("evaluated", "exps", "commits", "warp_rows",
                          "warp_rows_single", "warp_rows_strip"), 0)
    walked = torch.zeros(nt, dtype=torch.int64, device=px.device)
    k = torch.arange(chunk, device=px.device)
    for c0 in range(0, int((end - start).max()), chunk):
        rows = start + c0 + k
        live = (rows < end)[..., None]
        a = table[src[torch.where(rows < end, rows, 0)]]
        col = lambda i: a[..., i, None]
        alpha, in_ellipse = blend_math.gaussian_alpha(
            col(A_X) - px, col(A_Y) - py, col(A_CA), col(A_CB), col(A_CC),
            col(A_OP))
        valid = (live & (col(A_VALID) > 0.5) & in_ellipse
                 & (alpha >= blend_math.ALPHA_MIN))
        a_eff = torch.where(valid, alpha, 0.0)
        t_after = T[:, None] * torch.cumprod(1.0 - a_eff, dim=1)
        done_after = done[:, None] | (t_after < blend_math.T_MIN)
        done_before = torch.cat([done[:, None], done_after[:, :-1]], dim=1)
        evaluated = live & ~done_before
        work["evaluated"] += int(evaluated.sum())
        work["exps"] += int((evaluated & in_ellipse & (col(A_VALID) > 0.5)).sum())
        commit = valid & ~done_after
        work["commits"] += int(commit.sum())
        walked += evaluated.any(dim=2).sum(dim=1)
        # pixel y * 16 + x as (y block, y in block, x block, x in block)
        lanes = commit.view(nt, chunk, 4, 4, 2, 8).sum(dim=(3, 5))
        work["warp_rows"] += int((lanes > 0).sum())
        work["warp_rows_single"] += int((lanes == 1).sum())
        work["warp_rows_strip"] += int(commit.view(nt, chunk, 8, 32).any(dim=3).sum())
        T = T * torch.prod(torch.where(commit, 1.0 - a_eff, 1.0), dim=1)
        done = done_after[:, -1]
    work["walked"] = walked
    work["warp_rows_none"] = int(walked.sum()) * 8 - work["warp_rows"]
    return work
