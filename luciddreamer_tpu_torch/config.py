"""Configuration read by the render path (mirrors ``luciddreamer_tpu.config``).

Only the fields this package reads are carried; the training and dreaming
fields come with the slices that use them.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class GSConfig:
    """The render-time subset of the 3DGS hyperparameters."""

    sh_degree: int = 3
    white_background: bool = False


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
