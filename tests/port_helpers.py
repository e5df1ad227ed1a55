"""Shared utilities of the port's parity tests: the JAX package's objects
carried into ``luciddreamer_tpu_torch`` on the CPU, and back to numpy, and
the golden pipeline run through either package."""
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
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


def jax_tree(model, x_shape, seed, noise=0.05):
    """A parameter tree of ``model`` for inputs of ``x_shape``: flax's
    initial values plus seeded noise on every leaf, the ViT's k bias 0."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            base = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif keys[-1] in ("scale", "gamma1", "gamma2"):
            base = np.ones(s.shape)
        else:
            base = np.zeros(s.shape)
        v = (base + noise * rng.normal(size=s.shape)).astype(np.float32)
        if keys[-2:] == ["qkv", "bias"] and "attn" in keys:
            third = s.shape[0] // 3
            v[third : 2 * third] = 0.0
        return v

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture
def one_torch_thread():
    """Run a test on one intra-op thread: the port's CPU tests use small
    tensors, and the suite's parallel workers share the CPU with JAX, so
    more threads only oversubscribe it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def without_adapters(monkeypatch, *protocols_modules):
    """Give each dream ``protocols`` module registries without the model
    adapters for one test (restored afterwards): an adapter asked for then
    registers anew, against the stand-ins the test installs."""
    for mod in protocols_modules:
        for reg in ("_INPAINTERS", "_DEPTH"):
            monkeypatch.setattr(mod, reg, {
                k: v for k, v in getattr(mod, reg).items()
                if k not in ("sd", "lama", "sd_controlnet", "zoedepth")})


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "waterfall_golden.npz")
EXAMPLE = os.path.join(REPO, "examples", "waterfall.png")
PROMPT = os.path.join(REPO, "examples", "waterfall.txt")


def block_means(img_chw, blocks=8):
    """(3, H, W) -> (blocks, blocks, 3) mean pooling."""
    c, h, w = img_chw.shape
    bh, bw = h // blocks, w // blocks
    x = img_chw[:, : bh * blocks, : bw * blocks]
    return x.reshape(c, blocks, bh, blocks, bw).mean(axis=(2, 4)).transpose(1, 2, 0)


def golden_run(which, save_dir, dream_seed=1, **create_kw):
    """tests/test_golden_pipeline.py's run on the CPU: the waterfall
    example at 64x64, rotate360, classic inpainter + radial depth,
    fill_iters 2, 80 iterations, the cloud cut to 3,000 points, then llff
    frames 0, 100 and 200.  ``which`` is "jax" (the JAX package) or "port"
    (``luciddreamer_tpu_torch`` on one torch thread).  ``dream_seed`` seeds
    the inpainter's noise; the bake's seed stays 1.  ``create_kw`` goes to
    ``create``.  Returns (the golden's statistics, the PLY path, the app)."""
    from PIL import Image

    if which == "jax":
        import jax.numpy as jnp

        import luciddreamer_tpu.app as app
        from luciddreamer_tpu.config import CameraConfig, GSConfig
        from luciddreamer_tpu.dream import DreamConfig
        from luciddreamer_tpu.video import render_frames
        extra, render_kw = {}, dict(bg=jnp.zeros(3), backend="xla")
    else:
        import luciddreamer_tpu_torch.app as app
        from luciddreamer_tpu_torch.config import CameraConfig, GSConfig
        from luciddreamer_tpu_torch.dream import DreamConfig
        from luciddreamer_tpu_torch.video import render_frames
        extra = {"device": "cpu"}
        render_kw = dict(bg=[0.0, 0.0, 0.0], backend="torch", device="cpu")
    size = 64
    focal = 5.8269e02 * size / 512.0
    ld = app.LucidDreamerTPU(
        gs_config=GSConfig(iterations=80, position_lr_max_steps=80,
                           densify_from_iter=30, densification_interval=40),
        cam_config=CameraConfig(image_width=size, image_height=size,
                                focal=(focal, focal)),
        dream_config=DreamConfig(inpainter="classic", depth_estimator="radial",
                                 fill_iters=2),
        save_dir=str(save_dir), capacity_multiplier=1.5, seed=1, **extra)
    threads = torch.get_num_threads()
    old_cap = app.MAX_PCD_POINTS
    app.MAX_PCD_POINTS = 3000
    try:
        torch.set_num_threads(1)
        with open(PROMPT) as f:
            prompt = f.readline().strip()
        ply_path = ld.create(Image.open(EXAMPLE).convert("RGB"), prompt, "",
                             "rotate360", seed=dream_seed, diff_steps=2,
                             **create_kw)
        cams = ld.scene.get_preset_cameras("llff")
        rgbs, depths = render_frames(ld.params, [cams[i] for i in (0, 100, 200)],
                                     **render_kw)
    finally:
        app.MAX_PCD_POINTS = old_cap
        torch.set_num_threads(threads)
    stats = {
        "alive": int(ld.params.num_alive),
        "xyz_mean": np_(ld.params.xyz).mean(0),
        "blocks": np.stack([block_means(np.asarray(r).transpose(2, 0, 1) / 255.0)
                            for r in rgbs]),
        "depth_mean": np.asarray([d[d > 0].mean() for d in depths]),
        "depth_posfrac": np.asarray([(d > 0).mean() for d in depths]),
    }
    return stats, ply_path, ld


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class GlooWorld:
    """``n`` CPU processes that run the script ``source`` as the ranks of one
    gloo world, started at once: each gets argv ``rank n port *args`` and
    writes ``rank<r>.npz`` into ``out_dir``.  The workers import neither JAX
    nor this module, and run on one torch thread (the script sets it)."""

    def __init__(self, source: str, n: int, out_dir, args=(), timeout=300):
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        script = os.path.join(self.out_dir, "worker.py")
        with open(script, "w") as f:
            f.write(source)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH",
                            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
        env["OMP_NUM_THREADS"] = "1"
        port = free_port()
        self.logs = [os.path.join(self.out_dir, f"rank{r}.log") for r in range(n)]
        self.procs = []
        for r in range(n):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, str(r), str(n), str(port),
                     *map(str, args)],
                    env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
        self.deadline = time.monotonic() + timeout
        self.results = None

    def wait(self) -> list:
        """Every rank's results (a dict of arrays each); fails the test when
        a rank fails or the world outlives its timeout."""
        if self.results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                pytest.fail(f"a gloo world in {self.out_dir} timed out")
            for p, log in zip(self.procs, self.logs):
                if p.returncode != 0:
                    pytest.fail(f"rank failed ({p.returncode}):\n"
                                + open(log).read()[-4000:])
            self.results = [dict(np.load(os.path.join(self.out_dir,
                                                      f"rank{r}.npz")))
                            for r in range(len(self.procs))]
        return self.results
