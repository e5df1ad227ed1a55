"""Port parity: PLY I/O, camera paths, ``render_frames`` and the app of
``luciddreamer_tpu_torch`` against ``luciddreamer_tpu`` (CPU); the port's
device rule; and the port's independence from JAX."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu import video as jvideo
from luciddreamer_tpu.model import ply as jply
from luciddreamer_tpu.scene.scene import _frame_to_camera as j_frame_to_camera
from luciddreamer_tpu.trajectory import get_camera_paths as j_paths
from luciddreamer_tpu_torch import video as tvideo
from luciddreamer_tpu_torch.app import LucidDreamerTPU
from luciddreamer_tpu_torch.config import CameraConfig
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model import ply as tply
from luciddreamer_tpu_torch.scene import frame_to_camera
from luciddreamer_tpu_torch.trajectory import get_camera_paths as t_paths
from tests.helpers import make_random_gaussians
from tests.port_helpers import np_, port_params

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "alive")


def test_ply_jax_to_port_and_back(rng, tmp_path):
    jp = make_random_gaussians(50, rng, sh_degree=3, capacity=64)
    j_path, t_path = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    assert jply.save_ply(jp, j_path) == 50

    loaded = tply.load_ply(j_path, capacity=64, device="cpu")
    j_loaded = jply.load_ply(j_path, capacity=64)
    for k in FIELDS:
        np.testing.assert_array_equal(np_(getattr(loaded, k)),
                                      np_(getattr(j_loaded, k)), err_msg=k)
        np.testing.assert_array_equal(np_(getattr(loaded, k))[:50],
                                      np_(getattr(jp, k))[:50], err_msg=k)
    assert not np_(loaded.alive)[50:].any() and not np_(loaded.xyz)[50:].any()
    assert tply.save_ply(loaded, t_path) == 50
    # byte-compatible: the port writes the file the JAX package writes
    assert Path(t_path).read_bytes() == Path(j_path).read_bytes()

    back = jply.load_ply(t_path, capacity=64)
    for k in FIELDS:
        np.testing.assert_array_equal(np_(getattr(back, k)),
                                      np_(getattr(j_loaded, k)), err_msg=k)


def test_ply_sh0_and_bad_files(rng, tmp_path):
    jp = make_random_gaussians(10, rng, sh_degree=0)
    path = str(tmp_path / "dc.ply")
    jply.save_ply(jp, path)
    loaded = tply.load_ply(path, device="cpu")
    assert loaded.features_rest.shape == (10, 0, 3) and loaded.max_sh_degree == 0
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError):
        tply.load_ply(str(bad), device="cpu")


def test_camera_paths_match():
    jpaths, tpaths = j_paths(), t_paths()
    assert {k: len(v["frames"]) for k, v in tpaths.items()} == {
        "back_and_forth": 201, "llff": 400, "headbanging": 720}
    for name, v in jpaths.items():
        np.testing.assert_array_equal(
            np.array([f["transform_matrix"] for f in tpaths[name]["frames"]]),
            np.array([f["transform_matrix"] for f in v["frames"]]), err_msg=name)


def _llff_cameras(n, W, H, fov=0.99):
    frames = t_paths()["llff"]["frames"][:n]
    jc = [j_frame_to_camera(f["transform_matrix"], fov, fov, W, H) for f in frames]
    tc = [frame_to_camera(f["transform_matrix"], fov, fov, W, H, device="cpu")
          for f in frames]
    return jc, tc


def test_frame_to_camera_matches():
    jc, tc = _llff_cameras(2, 48, 32)
    for j, t in zip(jc, tc):
        for k in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy"):
            np.testing.assert_array_equal(np_(getattr(t, k)), np_(getattr(j, k)))


def test_render_frames_matches_jax(rng):
    W, H = 48, 32
    jp = make_random_gaussians(150, rng, scale_range=(-3.5, -1.0))
    jc, tc = _llff_cameras(3, W, H)
    bg = np.array([0.0, 0.1, 0.2], np.float32)
    j_rgb, j_depth = jvideo.render_frames(jp, jc, jnp.asarray(bg),
                                          active_sh_degree=3, backend="xla")
    t_rgb, t_depth = tvideo.render_frames(port_params(jp), tc, bg,
                                          active_sh_degree=3, device="cpu")
    assert len(t_rgb) == len(t_depth) == 3
    for jr, tr, jd, td in zip(j_rgb, t_rgb, j_depth, t_depth):
        assert tr.dtype == np.uint8 and tr.shape == (H, W, 3)
        # uint8 truncation of values within roundoff of a level step
        assert np.abs(tr.astype(int) - jr.astype(int)).max() <= 1
        np.testing.assert_allclose(td, jd, atol=1e-4)


def test_render_frames_reports_overflow(rng):
    jp = make_random_gaussians(200, rng, scale_range=(-2.5, -1.0))
    _, tc = _llff_cameras(1, 32, 32)
    with pytest.raises(RuntimeError, match="overflow"):
        tvideo.render_frames(port_params(jp), tc, [0, 0, 0], pair_cap=32,
                             chunk=16, device="cpu")


def test_app_loads_and_renders_presets(rng, tmp_path):
    jp = make_random_gaussians(30, rng)
    path = str(tmp_path / "scene.ply")
    jply.save_ply(jp, path)
    app = LucidDreamerTPU(cam_config=CameraConfig(32, 32, (36.0, 36.0)),
                          save_dir=str(tmp_path / "out"), device="cpu")
    with pytest.raises(RuntimeError):
        app.render_video()
    params = app.load_ply(path, capacity=40)
    assert params.capacity == 40 and int(params.num_alive) == 30
    cams = app.preset_cameras("back_and_forth")
    assert len(cams) == 201 and (cams[0].height, cams[0].width) == (32, 32)
    # save_ply onto an existing file loads it, as in the JAX package
    assert app.save_ply(path) == path and app.params.capacity == 30
    new = str(tmp_path / "copy.ply")
    app.save_ply(new)
    assert Path(new).read_bytes() == Path(path).read_bytes()


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_camera(np.eye(4), 0.8, 0.8, 16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        LucidDreamerTPU()
    with pytest.raises(RuntimeError, match="CUDA"):
        tply.load_ply(str(tmp_path / "missing.ply"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tvideo.render_frames(None, [], [0, 0, 0])
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the JAX package may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import luciddreamer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'luciddreamer_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
