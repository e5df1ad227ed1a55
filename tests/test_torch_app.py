"""Port parity of the scene plumbing, the Morton subsample, the utilities and
the whole app of ``luciddreamer_tpu_torch`` against ``luciddreamer_tpu``
(CPU): ``Scene`` on the same traindata, the camera-JSON, COLMAP and
NeRF-synthetic loaders, Morton codes and subsample against the native
library, ``mark_visible``, the timer and the finite checks; the port's
``create`` at the golden settings against ``tests/golden/waterfall_golden.npz``
(the tolerances of tests/test_golden_pipeline.py), and the CLI end to end.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu import native
from luciddreamer_tpu import trajectory as jtraj
from luciddreamer_tpu.scene import Scene as JScene
from luciddreamer_tpu.scene import load_camera_json as j_load_camera_json
from luciddreamer_tpu.scene import colmap as jcolmap
from luciddreamer_tpu.scene import datasets as jdatasets
from luciddreamer_tpu.utils import mark_visible as j_mark_visible
from luciddreamer_tpu_torch import cli
from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.points.morton import morton_codes, morton_subsample
from luciddreamer_tpu_torch.scene import Scene, load_camera_json
from luciddreamer_tpu_torch.scene import colmap as tcolmap
from luciddreamer_tpu_torch.scene import datasets as tdatasets
from luciddreamer_tpu_torch.train.loop import Trainer
from luciddreamer_tpu_torch.utils import PhaseTimer, mark_visible
from luciddreamer_tpu_torch.utils.debug import (
    NonFiniteError, check_finite, find_nonfinite)
from luciddreamer_tpu_torch.utils.random import seed_everything
from tests import port_helpers
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import np_, one_torch_thread, port_camera, port_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "waterfall_golden.npz"
EXAMPLE = REPO / "examples" / "waterfall.png"
PROMPT = REPO / "examples" / "waterfall.txt"
CAMERA_ARRAYS = ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")


def _assert_same_camera(t, j, atol=1e-6):
    assert (t.height, t.width) == (j.height, j.width)
    for k in CAMERA_ARRAYS:
        np.testing.assert_allclose(np_(getattr(t, k)), np_(getattr(j, k)),
                                   atol=atol, rtol=0, err_msg=k)


def _traindata(rng, n_frames=3, H=16, W=16):
    poses = jtraj.get_pcdgen_poses("hemisphere", {"center_depth": 2.0})
    frames = [{
        "image": (rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8),
        "transform_matrix": jtraj.w2c_pose_to_c2w(p),
        "depth": rng.uniform(1, 3, size=(H, W)).astype(np.float32),
    } for p in poses[:n_frames]]
    frames[-1]["image"] = rng.uniform(size=(H, W, 4)).astype(np.float32)
    del frames[-1]["depth"]
    return {"camera_angle_x": 0.8279, "W": W, "H": H,
            "pcd_points": rng.normal(size=(3, 50)).astype(np.float32),
            "pcd_colors": rng.uniform(size=(50, 3)).astype(np.float32),
            "frames": frames}


def test_scene_matches_jax(rng):
    td = _traindata(rng)
    js, ts = JScene(td), Scene(td, device="cpu")
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    assert ts.cameras_extent > 0
    assert len(ts.get_train_views()) == len(js.get_train_views()) == 3
    for tv, jv in zip(ts.get_train_views(), js.get_train_views()):
        _assert_same_camera(tv.camera, jv.camera)
        np.testing.assert_array_equal(tv.image, jv.image)
        if jv.depth is None:
            assert tv.depth is None
        else:
            np.testing.assert_array_equal(tv.depth, jv.depth)
    assert set(ts.preset_cameras) == set(js.preset_cameras)
    for name in js.preset_cameras:
        tcams, jcams = ts.get_preset_cameras(name), js.get_preset_cameras(name)
        assert len(tcams) == len(jcams)
        for i in (0, len(jcams) // 2, len(jcams) - 1):
            _assert_same_camera(tcams[i], jcams[i])
    np.testing.assert_array_equal(ts.pcd_points, js.pcd_points)
    np.testing.assert_array_equal(ts.pcd_colors, js.pcd_colors)


def test_load_camera_json_matches_jax(tmp_path):
    poses = jtraj.get_pcdgen_poses("rotate360")
    path = tmp_path / "cams.json"
    path.write_text(json.dumps({
        "camera_angle_x": 0.69,
        "frames": [{"transform_matrix": jtraj.w2c_pose_to_c2w(p)[:3].tolist()}
                   for p in poses],
    }))
    tcams = load_camera_json(str(path), H=64, W=48, device="cpu")
    jcams = j_load_camera_json(str(path), H=64, W=48)
    assert len(tcams) == len(jcams) == 10
    for t, j in zip(tcams, jcams):
        _assert_same_camera(t, j)
    np.testing.assert_allclose(np_(tcams[0].viewmatrix), np.eye(4), atol=1e-6)


def test_qvec_rotmat_match_jax(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    q = q if q[0] >= 0 else -q
    R = tcolmap.qvec2rotmat(q)
    np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
    np.testing.assert_allclose(tcolmap.rotmat2qvec(R), q, atol=1e-8)


def _write_colmap_text(rng, root):
    """A PINHOLE camera, two images and three points, as COLMAP text, and
    16x16 images for the views."""
    from PIL import Image

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    cams = {1: tcolmap.ColmapCamera(1, "PINHOLE", 16, 16,
                                    np.array([20.0, 21.0, 8.0, 8.0]))}
    images = {}
    for i in (1, 2):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = tcolmap.ColmapImage(i, q, rng.normal(size=3), 1,
                                        f"im{i}.png", np.array([[1.0, 2.0]]),
                                        np.array([7]))
        Image.fromarray((rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8)
                        ).save(root / "images" / f"im{i}.png")
    tcolmap.write_cameras_text(cams, str(sparse / "cameras.txt"))
    tcolmap.write_images_text(images, str(sparse / "images.txt"))
    (sparse / "points3D.txt").write_text(
        "# pts\n1 0.5 0.6 0.7 10 20 30 0.1 1 0\n"
        "2 -0.5 0.1 1.7 40 50 60 0.2 1 0\n3 0.0 0.2 2.5 70 80 90 0.3 1 0\n")
    return images


def test_colmap_text_round_trip_and_scene(rng, tmp_path):
    images = _write_colmap_text(rng, tmp_path)
    sparse = str(tmp_path / "sparse" / "0")
    cams2, images2, (xyz, rgb, err) = tcolmap.read_model(sparse)
    assert cams2[1].model == "PINHOLE" and cams2[1].width == 16
    np.testing.assert_allclose(images2[2].qvec, images[2].qvec, atol=1e-12)
    np.testing.assert_allclose(xyz[1], [-0.5, 0.1, 1.7])
    assert (rgb[2] == [70, 80, 90]).all()
    j_cams, j_images, (j_xyz, _, _) = jcolmap.read_model(sparse)
    np.testing.assert_array_equal(xyz, j_xyz)

    ts = tdatasets.read_colmap_scene(str(tmp_path), device="cpu")
    js = jdatasets.read_colmap_scene(str(tmp_path))
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)
    for tv, jv in zip(ts.views, js.views, strict=True):
        _assert_same_camera(tv.camera, jv.camera)
        np.testing.assert_array_equal(tv.image, jv.image)
    assert tdatasets.SCENE_LOADERS["colmap"] is tdatasets.read_colmap_scene


def test_colmap_binary_model_matches_jax(rng, tmp_path):
    """cameras.bin, images.bin and points3D.bin in COLMAP's layout, read by
    both packages (the binary files win over text ones)."""
    import struct

    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    with open(tmp_path / "cameras.bin", "wb") as f:      # SIMPLE_PINHOLE
        f.write(struct.pack("<QiiQQ3d", 1, 3, 0, 24, 16, 30.0, 12.0, 8.0))
    with open(tmp_path / "images.bin", "wb") as f:
        f.write(struct.pack("<Qi4d3di", 1, 5, *q, *t, 3) + b"view.png\x00")
        f.write(struct.pack("<Q2dq2dq", 2, 1.5, 2.5, 7, 3.0, 4.0, -1))
    with open(tmp_path / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for i, xyz in enumerate(([0.5, 0.6, 0.7], [-1.0, 2.0, 3.5])):
            f.write(struct.pack("<Q3d3BdQ2i", i + 1, *xyz, 10, 20 + i, 30,
                                0.25, 1, 5, 0))
    (tmp_path / "cameras.txt").write_text("not read\n")
    tcams, timgs, (txyz, trgb, terr) = tcolmap.read_model(str(tmp_path))
    jcams, jimgs, (jxyz, jrgb, jerr) = jcolmap.read_model(str(tmp_path))
    assert tcams[3].model == jcams[3].model == "SIMPLE_PINHOLE"
    assert (tcams[3].width, tcams[3].height) == (24, 16)
    np.testing.assert_array_equal(tcams[3].params, [30.0, 12.0, 8.0])
    im = timgs[5]
    assert im.name == jimgs[5].name == "view.png" and im.camera_id == 3
    np.testing.assert_array_equal(im.qvec, q)
    np.testing.assert_array_equal(im.tvec, t)
    np.testing.assert_array_equal(im.xys, [[1.5, 2.5], [3.0, 4.0]])
    np.testing.assert_array_equal(im.xys, jimgs[5].xys)
    # the ids are int64 in the file; the JAX package reads them as doubles
    np.testing.assert_array_equal(im.point3D_ids, [7, -1])
    np.testing.assert_array_equal(txyz, [[0.5, 0.6, 0.7], [-1.0, 2.0, 3.5]])
    np.testing.assert_array_equal(trgb, [[10, 20, 30], [10, 21, 30]])
    for a, b in ((txyz, jxyz), (trgb, jrgb), (terr, jerr)):
        np.testing.assert_array_equal(a, b)


def test_nerf_synthetic_loader_matches_jax(rng, tmp_path):
    from PIL import Image

    (tmp_path / "imgs").mkdir()
    frames = []
    for i in range(2):
        arr = (rng.uniform(size=(16, 16, 4)) * 255).astype(np.uint8)
        Image.fromarray(arr, "RGBA").save(tmp_path / "imgs" / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[0, 3] = i * 0.5
        frames.append({"file_path": f"imgs/r_{i}",
                       "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.7, "frames": frames}))
    ts = tdatasets.SCENE_LOADERS["blender"](str(tmp_path),
                                            white_background=True, device="cpu")
    js = jdatasets.read_nerf_synthetic(str(tmp_path), white_background=True)
    assert len(ts.views) == 2 and ts.views[0].image.shape == (3, 16, 16)
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    assert ts.cameras_extent > 0
    for tv, jv in zip(ts.views, js.views):
        _assert_same_camera(tv.camera, jv.camera)
        np.testing.assert_array_equal(tv.image, jv.image)
    np.testing.assert_array_equal(ts.points, js.points)
    np.testing.assert_array_equal(ts.colors, js.colors)


def test_morton_codes_match_native(rng):
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_(morton_codes(torch.as_tensor(pts))),
                                  native.morton_codes(pts).astype(np.int64))
    two = torch.tensor([[0, 0, 0], [0, 0, 0], [1, 1, 1.0]])
    c = morton_codes(two)
    assert c[0] == c[1] == 0 and int(c[2]) == 2**63 - 1    # every bit of 63


@pytest.mark.parametrize("m", [1, 100, 2999, 3000, 5000])
def test_morton_subsample_matches_native(rng, m):
    """Distinct points (no equal codes): the same indices as the native
    library's unstable sort; m >= n keeps every point."""
    pts = rng.uniform(size=(3000, 3)).astype(np.float32)
    assert len(np.unique(native.morton_codes(pts))) == 3000
    idx = np_(morton_subsample(torch.as_tensor(pts), m))
    np.testing.assert_array_equal(idx, native.morton_subsample(pts, m))
    assert len(np.unique(idx)) == min(m, 3000)


def test_mark_visible_matches_jax(rng):
    jp = make_random_gaussians(40, rng, capacity=48)
    xyz = np.array(jp.xyz)
    xyz[0] = [0, 0, -5.0]          # behind the camera
    xyz[1] = [0, 0, 0.1]           # inside the near plane
    jp = jp.replace(xyz=jnp.asarray(xyz))
    jcam = make_test_camera(16, 16)
    vis = np_(mark_visible(port_params(jp), port_camera(jcam)))
    np.testing.assert_array_equal(vis, np.asarray(j_mark_visible(jp, jcam)))
    assert not vis[0] and not vis[1] and vis[2:40].all() and not vis[40:].any()


def test_phase_timer_and_trace(tmp_path):
    from luciddreamer_tpu_torch.utils import trace_to

    t = PhaseTimer()
    x = torch.ones(4)
    for _ in range(2):
        with t.phase("a", block_on={"x": [x]}):
            x = x * 2
    assert t.counts["a"] == 2 and t.totals["a"] >= 0
    assert "a" in t.summary()
    with trace_to(str(tmp_path)):
        torch.ones(8).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))


def test_check_finite_and_snapshot(tmp_path):
    good = {"a": torch.ones(3), "b": {"c": np.zeros(2)}}
    assert find_nonfinite(good) == []
    check_finite(good)
    bad = {"a": torch.tensor([1.0, float("nan")]), "ints": torch.arange(3),
           "b": [np.array([np.inf]), None]}
    assert find_nonfinite(bad) == ["['a']", "['b'][0]"]
    with pytest.raises(NonFiniteError) as ei:
        check_finite(bad, outdir=str(tmp_path), tag="t")
    assert ei.value.bad_leaves == ["['a']", "['b'][0]"]
    loaded = np.load(ei.value.snapshot_path)
    assert {"a", "ints"} <= set(loaded.files)


def test_seed_everything():
    g = seed_everything(7, device="cpu")
    a = torch.randn(3, generator=g)
    np_draw, torch_draw = np.random.rand(), torch.rand(1)
    g = seed_everything(7, device="cpu")
    assert torch.equal(a, torch.randn(3, generator=g))
    assert np.random.rand() == np_draw and torch.equal(torch.rand(1), torch_draw)


def _small_trainer(rng, cfg):
    from luciddreamer_tpu_torch.model.gaussians import create_from_pcd

    pts = torch.as_tensor(rng.normal(size=(40, 3)).astype(np.float32) * 0.3
                          + [0, 0, 3.0], dtype=torch.float32)
    params = create_from_pcd(pts, torch.full((40, 3), 0.5), capacity=48)
    cam = make_camera(np.eye(4), 0.8, 0.8, 16, 16, device="cpu")
    return Trainer(params, cfg, 1.0, chunk=32, device="cpu"), cam


def test_trainer_run_timer(rng):
    tr, cam = _small_trainer(rng, GSConfig(iterations=3, densify_from_iter=100))
    timer = PhaseTimer()
    tr.run([(cam, torch.full((3, 16, 16), 0.3))], timer=timer)
    assert timer.counts["train_step"] == 3 and int(tr.state.step) == 3


def test_trainer_debug_snapshot_on_nonfinite_loss(rng, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr, cam = _small_trainer(rng, GSConfig(iterations=3, debug=True,
                                           densify_from_iter=100))
    img = torch.full((3, 16, 16), 0.3)
    img[0, 0, 0] = float("nan")
    with pytest.raises(NonFiniteError) as ei:
        tr.run([(cam, img)])
    assert "['gt']" in ei.value.bad_leaves
    assert Path(ei.value.snapshot_path).parent.name == "debug_snapshots"
    assert "params/xyz" in np.load(ei.value.snapshot_path).files


def test_port_imports_no_image_or_video_library():
    """Pillow, imageio and matplotlib are imported only inside the
    functions that need them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import luciddreamer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'imageio', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_dream_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, rng,
                                                         tmp_path):
    from luciddreamer_tpu_torch.dream import generate_pcd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_pcd(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(_traindata(rng))
    with pytest.raises(RuntimeError, match="CUDA"):
        seed_everything(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--image", str(EXAMPLE)])
    assert not any(tmp_path.iterdir())      # the CLI wrote nothing first


# ---------------------------------------------------------------- golden

@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """The port's ``create`` at tests/test_golden_pipeline.py's settings on
    the CPU, its stages timed."""
    timer = PhaseTimer()
    stats, ply_path, ld = port_helpers.golden_run(
        "port", tmp_path_factory.mktemp("golden"), timer=timer)
    return stats, ply_path, ld, timer


def test_create_matches_golden(golden_run):
    """The golden statistics at tests/test_golden_pipeline.py's tolerances,
    but for the 8x8 block means: the golden pins the JAX package's noise
    stream (the inpainter's, sigma 0.02 a pass), and the JAX package itself
    run with dream seeds 2 to 6 misses 0.025 on 10.9-16.2% of the blocks,
    by up to 0.102 (tools/golden_noise_spread.py).  The port, whose noise
    is its own, must keep 80% of the blocks within 0.025 and all within
    0.15 (ROADMAP, Queue 3)."""
    stats, _, ld, _ = golden_run
    g = np.load(GOLDEN)
    assert ld.scene.pcd_points.shape[0] > 3000
    assert ld.trainer.state.params.capacity == 4500     # 1.5 x 3,000
    assert ld.trainer.pair_cap == 8 * 4500
    assert abs(stats["alive"] - g["alive"]) <= 0.1 * g["alive"] + 8
    np.testing.assert_allclose(stats["xyz_mean"], g["xyz_mean"], atol=0.05)
    d = np.abs(stats["blocks"] - g["blocks"])
    assert (d > 0.025).mean() <= 0.2 and d.max() <= 0.15, ((d > 0.025).mean(),
                                                           d.max())
    np.testing.assert_allclose(stats["depth_mean"], g["depth_mean"], rtol=0.05)
    np.testing.assert_allclose(stats["depth_posfrac"], g["depth_posfrac"],
                               atol=0.05)


def test_create_writes_ply_and_fits_its_views(golden_run):
    from luciddreamer_tpu_torch.model.ply import load_ply
    from luciddreamer_tpu_torch.render.tiled import render_tiled
    from luciddreamer_tpu_torch.train.losses import psnr

    stats, ply_path, ld, _ = golden_run
    assert int(load_ply(ply_path, device="cpu").num_alive) == stats["alive"]
    v = ld.scene.get_train_views()[0]
    with torch.no_grad():
        out = render_tiled(ld.params, v.camera, torch.zeros(3), backend="torch")
    assert float(psnr(out["render"], torch.as_tensor(v.image))) > 14.0


def test_create_times_its_stages(golden_run):
    _, _, ld, timer = golden_run
    assert {k: timer.counts[k] for k in ("dream", "scene", "bake_setup", "bake",
                                         "save_ply")} == dict.fromkeys(
        ("dream", "scene", "bake_setup", "bake", "save_ply"), 1)
    assert timer.counts["train_step"] == int(ld.trainer.state.step) == 80
    assert timer.totals["bake"] >= timer.totals["train_step"] > 0.0


@pytest.mark.parametrize("inpainter, model, error", [
    ("classic", "x.safetensors", ValueError),
    ("sd", "x.safetensors", NotImplementedError),
    ("sd", None, NotImplementedError),
])
def test_cli_rejects_an_unusable_inpainter_first(tmp_path, monkeypatch,
                                                 inpainter, model, error):
    """A bad --inpainter / --model_name fails before a checkpoint is
    converted or anything is written."""
    import luciddreamer_tpu_torch.dream as dream

    monkeypatch.setattr(dream, "resolve_sd_checkpoint", lambda *a, **k:
                        pytest.fail("the checkpoint was resolved first"))
    argv = ["--image", str(EXAMPLE), "--inpainter", inpainter,
            "--save_dir", str(tmp_path / "out")]
    if model:
        argv += ["--model_name", model]
    with pytest.raises(error):
        cli.main(argv, device="cpu")
    assert not any(tmp_path.iterdir())


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "out"
    cli.main([
        "--image", str(EXAMPLE),
        "--text", str(PROMPT),
        "--campath_gen", "rotate360",
        "--campath_render", "back_and_forth",
        "--seed", "3",
        "--diff_steps", "1",
        "--iterations", "4",
        "--image_size", "32",
        "--save_dir", str(out),
    ], device="cpu")
    assert (out / "gsplat.ply").exists()
    vids = [f for f in os.listdir(out) if f.endswith((".mp4", ".gif"))]
    assert any(f.startswith("back_and_forth") for f in vids)
    assert any(f.startswith("depth_back_and_forth") for f in vids)
