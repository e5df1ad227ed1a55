"""Camera/projection math (numpy matrices + torch camera).

Plain math convention: ``x_view = world2view @ [x, 1]``,
``x_clip = proj @ x_view``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from luciddreamer_tpu_torch.core.types import Camera
from luciddreamer_tpu_torch.device import resolve_device


def world2view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4 from the camera-to-world rotation R and the
    world->camera translation t, with optional recentering of the camera
    centre by ``translate`` and ``scale``."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        if translate is None:
            translate = np.zeros(3)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + np.asarray(translate)) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style projection, z in [0, 1]."""
    tan_y = math.tan(fovy / 2.0)
    tan_x = math.tan(fovx / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def ndc2pix(v, S):
    """NDC [-1,1] -> pixel centre coords."""
    return ((v + 1.0) * S - 1.0) * 0.5


def homogeneous_transform(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 to (..., 3) points; returns (..., 4)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return p @ matrix.T


def make_camera(
    c2w: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    device=None,
) -> Camera:
    """Build a renderer Camera from a 4x4 camera-to-world matrix."""
    dev = resolve_device(device)
    c2w = np.asarray(c2w, dtype=np.float64)
    w2c = np.linalg.inv(c2w)
    proj = projection_matrix(znear, zfar, fovx, fovy).astype(np.float64)
    full = proj @ w2c
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return Camera(
        viewmatrix=f32(w2c),
        projmatrix=f32(full),
        campos=f32(c2w[:3, 3]),
        tanfovx=f32(math.tan(fovx / 2.0)),
        tanfovy=f32(math.tan(fovy / 2.0)),
        height=int(height),
        width=int(width),
        znear=znear,
        zfar=zfar,
    )


def camera_from_w2c(
    w2c: np.ndarray, fovx: float, fovy: float, width: int, height: int,
    znear: float = 0.01, zfar: float = 100.0, device=None,
) -> Camera:
    """Build a renderer Camera from a 4x4 world-to-camera matrix."""
    c2w = np.linalg.inv(np.asarray(w2c, dtype=np.float64))
    return make_camera(c2w, fovx, fovy, width, height, znear, zfar,
                       device=device)
