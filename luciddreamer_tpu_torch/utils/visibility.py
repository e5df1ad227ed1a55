"""Visibility query without a render: per-Gaussian frustum test."""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams


@torch.no_grad()
def mark_visible(params: GaussianParams, camera: Camera) -> torch.Tensor:
    """(P,) bool: alive, and view-space z beyond the near plane (0.2)."""
    vm = camera.viewmatrix
    z = params.xyz @ vm[2, :3] + vm[2, 3]
    return (z > 0.2) & params.alive
