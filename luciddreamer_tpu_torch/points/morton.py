"""Morton (Z-order) codes and the Morton-stratified subsample of a point
cloud, on the device of the points (the counterpart of the JAX package's
native C++ ``morton3d`` / ``morton_subsample``).

Each axis is normalised to [0, 1] over the cloud's bounding box and
quantised to 21 bits with the same fp32 operations as the C++ code; the
bits interleave into a 63-bit code held in int64.  The subsample takes
every (n/m)-th point of a stable sort by code, which keeps the cloud's
spatial coverage where a random choice would thin it unevenly.
"""
from __future__ import annotations

import torch

_SPREAD = (  # (shift, mask) steps that spread 21 bits to every third bit
    (32, 0x1F00000000FFFF),
    (16, 0x1F0000FF0000FF),
    (8, 0x100F00F00F00F00F),
    (4, 0x10C30C30C30C30C3),
    (2, 0x1249249249249249),
)


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x1FFFFF
    for shift, mask in _SPREAD:
        v = (v | (v << shift)) & mask
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(n, 3) points -> (n,) int64 Morton codes (21 bits per axis)."""
    p = points.to(torch.float32)
    lo = p.amin(0)
    rng = torch.clamp_min(p.amax(0) - lo, 1e-12)
    q = ((p - lo) / rng * 2097151.0).to(torch.int64)       # 2^21 - 1
    codes = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for a in range(3):
        codes |= _spread_bits(q[:, a]) << a
    return codes


def morton_subsample(points: torch.Tensor, m: int) -> torch.Tensor:
    """(min(m, n),) int64 indices of a spatially stratified subsample."""
    n = points.shape[0]
    dev = points.device
    if m >= n:
        return torch.arange(n, device=dev)
    order = torch.sort(morton_codes(points), stable=True).indices
    return order[torch.arange(m, device=dev) * n // m]
