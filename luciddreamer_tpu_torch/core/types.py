"""Gaussian parameters, cameras and preprocessed Gaussians.

``GaussianParams`` is an ``nn.Module`` holding the raw (pre-activation)
parameters at a fixed capacity ``P`` with an ``alive`` mask buffer.
``Camera`` and ``ProcessedGaussians`` are dataclasses of tensors.  Matrices
use plain math convention: ``x_view = view @ [x, 1]``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


class GaussianParams(nn.Module):
    """Raw Gaussian parameters:

    - ``xyz``           (P, 3)  world-space means
    - ``features_dc``   (P, 1, 3)  SH DC coefficients
    - ``features_rest`` (P, (deg+1)^2-1, 3)  higher SH coefficients
    - ``scaling``       (P, 3)  log-scales  (activation: exp)
    - ``rotation``      (P, 4)  quaternions wxyz (activation: normalize)
    - ``opacity``       (P, 1)  logits (activation: sigmoid)
    - ``alive``         (P,)    capacity mask buffer (True = real Gaussian)
    """

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, alive):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.scaling = nn.Parameter(scaling)
        self.rotation = nn.Parameter(rotation)
        self.opacity = nn.Parameter(opacity)
        self.register_buffer("alive", alive.to(torch.bool))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    @property
    def max_sh_degree(self) -> int:
        n_coeffs = 1 + self.features_rest.shape[1]
        return int(round(n_coeffs**0.5)) - 1

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        # sqrt(sum + eps) keeps zero quaternions (dead capacity rows padded
        # by load_ply) finite, in value and gradient
        n = torch.sqrt(torch.sum(self.rotation**2, dim=-1, keepdim=True) + 1e-24)
        return self.rotation / n

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_features(self) -> torch.Tensor:
        """(P, (deg+1)^2, 3) concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def param_dict(self) -> dict:
        """The trainable tensors, detached, keyed by the JAX package's
        group names (``luciddreamer_tpu/core/types.py::param_pytree``)."""
        return {
            "xyz": self.xyz.detach(),
            "f_dc": self.features_dc.detach(),
            "f_rest": self.features_rest.detach(),
            "scaling": self.scaling.detach(),
            "rotation": self.rotation.detach(),
            "opacity": self.opacity.detach(),
        }

    @classmethod
    def from_param_dict(cls, p: dict, alive: torch.Tensor) -> "GaussianParams":
        return cls(p["xyz"], p["f_dc"], p["f_rest"], p["scaling"],
                   p["rotation"], p["opacity"], alive)


@dataclasses.dataclass
class Camera:
    """A pinhole camera.  ``viewmatrix`` is the 4x4 world->camera matrix,
    ``projmatrix`` the full transform proj @ view, ``campos`` the camera
    centre; the tan(fov/2) values are 0-d tensors."""

    viewmatrix: torch.Tensor            # (4, 4)
    projmatrix: torch.Tensor            # (4, 4) = proj @ view
    campos: torch.Tensor                # (3,)
    tanfovx: torch.Tensor               # ()
    tanfovy: torch.Tensor               # ()
    height: int = 512
    width: int = 512
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tanfovy)

    def to(self, device) -> "Camera":
        move = lambda t: t.to(device)
        return dataclasses.replace(
            self, viewmatrix=move(self.viewmatrix),
            projmatrix=move(self.projmatrix), campos=move(self.campos),
            tanfovx=move(self.tanfovx), tanfovy=move(self.tanfovy),
        )


@dataclasses.dataclass
class ProcessedGaussians:
    """Per-Gaussian screen-space quantities from render.preprocess."""

    mean2d: torch.Tensor         # (P, 2) pixel coords
    depth: torch.Tensor          # (P,) view-space z
    conic: torch.Tensor          # (P, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor        # (P,)
    rgb: torch.Tensor            # (P, 3)
    radius: torch.Tensor         # (P,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor       # (P, 2) int32 tile coords (x, y)
    rect_max: torch.Tensor       # (P, 2) int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # (P,) int32
    visible: torch.Tensor        # (P,) bool
