"""Carry state across from the JAX package: its ``GaussianParams``,
``Camera`` and ``TrainState`` fields, given as numpy arrays, become the
port's objects.

No JAX import: callers pass ``np.asarray`` of each field.
"""
from __future__ import annotations

import numpy as np
import torch

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.train.checkpoint import state_from_dict

GAUSSIAN_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity", "alive")
CAMERA_ARRAYS = ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")


def gaussian_params(arrays: dict, device=None) -> GaussianParams:
    """``arrays`` maps every name in GAUSSIAN_FIELDS to a numpy array."""
    dev = resolve_device(device)
    t = {k: torch.as_tensor(np.array(arrays[k]), device=dev)
         for k in GAUSSIAN_FIELDS}
    return GaussianParams(
        **{k: v.to(torch.float32) for k, v in t.items() if k != "alive"},
        alive=t["alive"].to(torch.bool),
    )


def camera(arrays: dict, height: int, width: int, znear: float = 0.01,
           zfar: float = 100.0, device=None) -> Camera:
    """``arrays`` maps every name in CAMERA_ARRAYS to a numpy array."""
    dev = resolve_device(device)
    f32 = lambda k: torch.as_tensor(np.array(arrays[k], np.float32), device=dev)
    return Camera(**{k: f32(k) for k in CAMERA_ARRAYS}, height=int(height),
                  width=int(width), znear=znear, zfar=zfar)


def train_state(tree: dict, device=None):
    """A JAX ``TrainState`` as the nested dict of numpy arrays that
    ``luciddreamer_tpu/train/checkpoint.py::_state_to_pytree`` builds
    (params with alive, adam count/mu/nu, stats, step) -> the port's
    ``TrainState``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.array(x), device=dev)

    return state_from_dict(conv(tree))
