"""k-nearest-neighbour squared distances by the matrix-product formula (the
twin of ``luciddreamer_tpu/points/knn.py``).

For every point, the squared distances to its k nearest other alive points,
used to initialise Gaussian scales.  The N x N distance matrix is streamed
in (row block x column block) tiles as |r|^2 + |c|^2 - 2 r.c, the product
by ``torch.matmul`` in full fp32 (TF32 is switched off around it), with a
running top-k.  O(N^2) operations and O(row block x column block) memory.
It is not exact: the fp32 formula cancels where |r|^2 and |c|^2 dwarf the
distance, and loses about 1% on the app's clouds (more far from the
origin).  The exact counterpart, with coordinate differences, is
``points/knn_exact.py``; ``create_from_pcd`` keeps this one, as the JAX
package's does.  The default blocks are larger than the JAX package's:
each block is a Python-level step here, and the result does not depend on
them.
"""
from __future__ import annotations

import contextlib

import torch

_BIG = 3.4e38


@contextlib.contextmanager
def _full_fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _pad_to(x, n, fill):
    pad = x.new_full((n - x.shape[0],) + x.shape[1:], fill)
    return torch.cat([x, pad])


@torch.no_grad()
def knn_sq_dists(
    points: torch.Tensor,
    alive: torch.Tensor | None = None,
    k: int = 3,
    row_block: int = 4096,
    col_block: int = 16384,
) -> torch.Tensor:
    """(P, k) ascending squared distances to the k nearest *other* alive
    points.  Dead rows get 0; dead columns never count as neighbours; a row
    with fewer than k alive neighbours gets 0 in the missing places."""
    P = points.shape[0]
    dev = points.device
    if alive is None:
        alive = torch.ones(P, dtype=torch.bool, device=dev)
    rb = min(row_block, max(8, P))
    cb = min(col_block, max(128, P))
    n_rows = -(-P // rb) * rb
    n_cols = -(-P // cb) * cb
    pts_r = _pad_to(points.to(torch.float32), n_rows, 0.0)
    pts_c = _pad_to(points.to(torch.float32), n_cols, 0.0)
    alive_c = _pad_to(alive.to(torch.bool), n_cols, False)
    sq_r = torch.sum(pts_r * pts_r, dim=-1)
    sq_c = torch.sum(pts_c * pts_c, dim=-1)
    out = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    with _full_fp32_matmul():
        for r0 in range(0, n_rows, rb):
            rows = pts_r[r0:r0 + rb]
            ridx = torch.arange(r0, r0 + rb, device=dev)[:, None]
            best = torch.full((rb, k), _BIG, device=dev)
            for c0 in range(0, n_cols, cb):
                cidx = torch.arange(c0, c0 + cb, device=dev)[None, :]
                cross = torch.matmul(rows, pts_c[c0:c0 + cb].T)   # (rb, cb)
                d2 = sq_r[r0:r0 + rb, None] + sq_c[None, c0:c0 + cb] - 2.0 * cross
                d2 = torch.clamp_min(d2, 0.0)
                invalid = ~alive_c[None, c0:c0 + cb] | (ridx == cidx) | (cidx >= P)
                d2 = torch.where(invalid, _BIG, d2)
                blk = torch.topk(d2, k, dim=1, largest=False).values
                best = torch.topk(torch.cat([best, blk], dim=1), k, dim=1,
                                  largest=False).values
            out[r0:r0 + rb] = best
    out = out[:P]
    out = torch.where(out >= _BIG, 0.0, out)                # < k alive points
    return torch.where(alive[:, None], out, 0.0)


def mean_sq_dist_3nn(points: torch.Tensor, alive: torch.Tensor | None = None,
                     **kw) -> torch.Tensor:
    """(P,) mean of the squared distances to the 3 nearest neighbours."""
    return torch.mean(knn_sq_dists(points, alive, k=3, **kw), dim=-1)
