"""Exact mean squared distance to the 3 nearest neighbours, on the card as a
hand-written CUDA kernel (``csrc/knn3_exact.cu``).

The counterpart of the JAX package's host C++ extension
``luciddreamer_tpu/native/knn_native.cpp::mean_sq_dist_3nn`` (exposed as
``native.mean_sq_dist_3nn_cpu``), which is a KD-tree on the CPU and no TPU
kernel.  Unlike ``points/knn.py``, whose |r|^2 + |c|^2 - 2 r.c formula
loses about 1% to fp32 cancellation, it computes exact coordinate
differences: per pair (p_j - p_i)^2 per axis, summed x + y + z in that
order; it skips the query by index, keeps the 3 smallest with the
KD-tree's empty slot 1e30, and returns ((d0 + d1) + d2) / 3 over the slots
below 1e29, so a point with fewer than 3 other points counts the missing
ones as 0 and n <= 1 gives 0 (``knn_native.cpp:109-130``).

``mean_sq_dist_3nn_exact`` launches the kernel for a CUDA tensor and
counts each launch in ``mean_sq_dist_3nn_exact.launches``; for a CPU
tensor it runs the plain version ``mean_sq_dist_3nn_exact_torch``, which
does the same operations in the same order, so the two are bit-equal on
the card.  Non-finite coordinates are not supported.
"""
from __future__ import annotations

import ctypes

import torch

from luciddreamer_tpu_torch.render import kernels

EMPTY = 1e30          # the KD-tree's empty slot (knn_native.cpp:71)
PRESENT = 1e29        # a slot below it holds a neighbour (knn_native.cpp:125)
MAX_POINTS = 2**31 - 256
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


@torch.no_grad()
def mean_sq_dist_3nn_exact_torch(points: torch.Tensor,
                                 rows: torch.Tensor | None = None,
                                 row_block: int = 1024,
                                 col_block: int = 16384) -> torch.Tensor:
    """The plain version, blocked over (row block x column block) pairs:
    (n, 3) points -> (n,) float32, or the entries of the query indices
    ``rows`` only (each query still skips its own index)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    dev = pts.device
    rows = torch.arange(n, device=dev) if rows is None else rows.to(dev)
    out = torch.zeros(rows.shape[0], dtype=torch.float32, device=dev)
    if n <= 1:
        return out
    for r0 in range(0, rows.shape[0], row_block):
        qi = rows[r0:r0 + row_block]
        q = pts[qi]
        best = torch.full((qi.shape[0], 3), EMPTY, device=dev)
        for c0 in range(0, n, col_block):
            d = pts[None, c0:c0 + col_block] - q[:, None]
            v = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            cidx = torch.arange(c0, c0 + v.shape[1], device=dev)
            v = torch.where(cidx[None] == qi[:, None], torch.inf, v)
            k = min(3, v.shape[1])
            blk = torch.topk(v, k, dim=1, largest=False).values
            best = torch.topk(torch.cat([best, blk], dim=1), 3, dim=1,
                              largest=False).values
        s = torch.zeros(qi.shape[0], dtype=torch.float32, device=dev)
        for j in range(3):
            s = s + torch.where(best[:, j] < PRESENT, best[:, j], 0.0)
        # a tensor divisor: a scalar one may become a product by 1/3
        out[r0:r0 + row_block] = s / torch.full_like(s, 3.0)
    return out


def mean_sq_dist_3nn_exact(points: torch.Tensor) -> torch.Tensor:
    """(n, 3) float32 points -> (n,) float32 mean squared distance to each
    point's 3 nearest other points.  On the card ``points`` must be
    contiguous float32 with n < 2^31 - 256."""
    if points.device.type == "cpu":
        return mean_sq_dist_3nn_exact_torch(points)
    if points.device.type != "cuda":
        raise ValueError(f"mean_sq_dist_3nn_exact: unsupported device "
                         f"{points.device}")
    if (points.dtype != torch.float32 or points.dim() != 2
            or points.shape[1] != 3 or not points.is_contiguous()):
        raise ValueError("points must be contiguous float32 (n, 3)")
    n = points.shape[0]
    if n >= MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS - 1} points")
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
    kernels.launch("knn3_exact", _ARGS, points.data_ptr(), n, out.data_ptr(),
                   stream)
    mean_sq_dist_3nn_exact.launches += 1
    return out


mean_sq_dist_3nn_exact.launches = 0
