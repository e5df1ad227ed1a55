"""Configuration read by the render and training paths (mirrors
``luciddreamer_tpu.config``, with its defaults).

The dreaming fields come with the slice that uses them.
"""
from __future__ import annotations

import dataclasses
import math


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
