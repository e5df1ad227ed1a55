"""Shared utilities of the port's parity tests: the JAX package's objects
carried into ``luciddreamer_tpu_torch`` on the CPU, and back to numpy."""
import jax
import numpy as np
import pytest
import torch

from luciddreamer_tpu.train.checkpoint import _state_to_pytree
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


def port_state(jax_state):
    """JAX TrainState -> the port's TrainState on the CPU."""
    tree = jax.tree.map(np.asarray, _state_to_pytree(jax_state))
    return convert.train_state(tree, device="cpu")


def jax_tile_ranges(bins, num_tiles, chunk):
    """Per-tile [start, end) rows from the JAX segment metadata: a tile's
    first segment (k0 == 0) starts its range, its segments' ends bound it."""
    tile = np.asarray(bins.seg_tile)
    base = np.asarray(bins.seg_chunk) * chunk
    lo = base + np.asarray(bins.seg_lo)
    hi = base + np.asarray(bins.seg_hi)
    k0 = np.asarray(bins.seg_k0)
    start = np.zeros(num_tiles, np.int64)
    end = np.zeros(num_tiles, np.int64)
    for t in range(num_tiles):
        mine = tile == t
        start[t] = lo[mine & (k0 == 0)][0]
        end[t] = hi[mine].max()
    return start, end


def assert_scaled_close(out, ref, atol, err_msg=""):
    """|out - ref| <= atol * max|ref| elementwise."""
    out, ref = np_(out), np_(ref)
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(out / scale, ref / scale, atol=atol, rtol=0,
                               err_msg=err_msg)


@pytest.fixture
def one_torch_thread():
    """Run a test on one intra-op thread: the port's CPU tests use small
    tensors, and the suite's parallel workers share the CPU with JAX, so
    more threads only oversubscribe it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
