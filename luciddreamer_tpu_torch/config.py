"""Configuration read by the render and training paths (mirrors
``luciddreamer_tpu.config``, with its defaults).  The dream stage's
``DreamConfig`` lives with its pipeline, ``dream/pipeline.py``.
``RenderConfig`` names the rasterizer's knobs and their values; the render
path takes its arguments directly and does not read it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class GSConfig:
    """3DGS optimization hyperparameters."""

    sh_degree: int = 3
    white_background: bool = False
    use_depth: bool = False
    iterations: int = 2990
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 2990
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    lambda_depth: float = 0.0        # weight of the masked depth L1
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class CameraConfig:
    """Pinhole intrinsics for generated scenes."""

    image_width: int = 512
    image_height: int = 512
    focal: tuple[float, float] = (5.8269e02, 5.8269e02)

    @property
    def fov_x(self) -> float:
        return 2.0 * math.atan(self.image_width / (2.0 * self.focal[0]))

    @property
    def fov_y(self) -> float:
        return 2.0 * math.atan(self.image_height / (2.0 * self.focal[1]))

    @property
    def K(self) -> np.ndarray:
        """(3, 3) float32 intrinsics with the principal point at the
        image centre."""
        w, h = self.image_width, self.image_height
        return np.array(
            [
                [self.focal[0], 0.0, w / 2.0],
                [0.0, self.focal[1], h / 2.0],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )


@dataclasses.dataclass
class RenderConfig:
    """Rasterizer geometry and capacity knobs.

    The pair buffers have an explicit capacity; the renderer reports
    overflow so that callers can render again with a larger one.
    """

    tile_size: int = 16
    max_pairs_per_gaussian: int = 0  # 0 = unlimited (rect area is the bound)
    pair_capacity_multiplier: float = 8.0  # max_pairs = multiplier * P
    chunk_size: int = 128            # gaussians blended per inner step
    # blend cutoffs
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1.0e-4
    acc_min: float = 0.5             # depth emitted only where acc > 0.5
    near_plane: float = 0.2          # frustum cull
