"""Per-Gaussian preprocessing: cull, project, conic, SH->RGB, tile rect.

Batched and differentiable; culled Gaussians are masked, not removed, so
every output keeps the capacity ``P``.  The arithmetic and the kernels live
in ``render/cuda_preprocess.py``: on CUDA tensors one hand-written kernel
computes the forward and one the backward; on other devices the plain
PyTorch forward runs and autograd differentiates it.
"""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams, ProcessedGaussians
from luciddreamer_tpu_torch.render import cuda_preprocess


def preprocess_gaussians(
    params: GaussianParams,
    camera: Camera,
    active_sh_degree: int,
    tile_size: int = 16,
    scale_modifier: float = 1.0,
    near_plane: float = 0.2,
    mean2d_offset: torch.Tensor | None = None,
) -> ProcessedGaussians:
    """Compute screen-space quantities for every Gaussian (masked)."""
    if params.xyz.device.type == "cuda":
        return cuda_preprocess.preprocess(
            params, camera, active_sh_degree, tile_size, scale_modifier,
            near_plane, mean2d_offset)
    return cuda_preprocess.preprocess_fwd_torch(
        params.xyz, params.features_dc, params.features_rest, params.scaling,
        params.rotation, params.opacity, params.alive, camera,
        active_sh_degree, tile_size, scale_modifier, near_plane,
        mean2d_offset)
