"""Shared utilities of the port's parity tests: the JAX package's objects
carried into ``luciddreamer_tpu_torch`` on the CPU, and back to numpy."""
import numpy as np
import torch

from luciddreamer_tpu_torch import convert


def port_params(jax_params):
    """JAX GaussianParams -> the port's GaussianParams on the CPU."""
    return convert.gaussian_params(
        {k: np.asarray(getattr(jax_params, k)) for k in convert.GAUSSIAN_FIELDS},
        device="cpu",
    )


def port_camera(jax_cam):
    """JAX Camera -> the port's Camera on the CPU."""
    return convert.camera(
        {k: np.asarray(getattr(jax_cam, k)) for k in convert.CAMERA_ARRAYS},
        jax_cam.height, jax_cam.width, jax_cam.znear, jax_cam.zfar,
        device="cpu",
    )


def np_(x):
    """A torch tensor or a JAX array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
