"""Port parity: the loss helpers (near_mean_map, sobel_edge_mask,
image2canny), TrainView.canny_mask, the leftover transforms and covariance
helpers, RenderConfig, camera-path export and checksummed download of
``luciddreamer_tpu_torch`` against ``luciddreamer_tpu`` on the same
numpy-seeded inputs (CPU, fp32)."""
import dataclasses
import hashlib
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import luciddreamer_tpu
import luciddreamer_tpu_torch
from luciddreamer_tpu import config as jconfig
from luciddreamer_tpu.core import covariance as jcov
from luciddreamer_tpu.core import transforms as jtr
from luciddreamer_tpu.scene.scene import TrainView as JTrainView
from luciddreamer_tpu.train import losses as jl
from luciddreamer_tpu.trajectory import export as jexport
from luciddreamer_tpu.utils import download as jdl
from luciddreamer_tpu_torch import config as tconfig
from luciddreamer_tpu_torch.core import covariance as tcov
from luciddreamer_tpu_torch.core import transforms as ttr
from luciddreamer_tpu_torch.scene.scene import TrainView as TTrainView
from luciddreamer_tpu_torch.train import losses as tl
from luciddreamer_tpu_torch.trajectory import export as texport
from luciddreamer_tpu_torch.utils import download as tdl
from tests.helpers import make_test_camera
from tests.port_helpers import REPO, np_, one_torch_thread, port_camera  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 37, 53


def _smooth_image(rng, channels, h=H, w=W):
    """(h, w, channels) in [0, 1]: low-frequency waves, hard-edged blocks and
    a little noise, so that Canny finds strong, weak and suppressed edges."""
    y, x = np.mgrid[0:h, 0:w] / np.float32(max(h, w))
    img = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * (rng.uniform(1, 3) * x
                                                    + rng.uniform(1, 3) * y
                                                    + rng.uniform()))
                    for _ in range(channels)], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y0:y0 + rng.integers(4, 12), x0:x0 + rng.integers(4, 16)] = (
            rng.uniform(0, 1, channels))
    img += rng.normal(0, 0.02, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def test_version_and_exports():
    assert luciddreamer_tpu_torch.__version__ == luciddreamer_tpu.__version__
    from luciddreamer_tpu_torch.train import near_mean_map

    assert near_mean_map is tl.near_mean_map


def test_near_mean_map_matches_jax(rng):
    arr = rng.normal(size=(H, W)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
    mask[0, :] = 0.0                      # zeros on the border
    mask[:, -1] = 0.0
    mask[10:14, 20:25] = 0.0              # and a hole with no neighbour
    got = tl.near_mean_map(torch.as_tensor(arr), torch.as_tensor(mask))
    ref = jl.near_mean_map(jnp.asarray(arr), jnp.asarray(mask))
    np.testing.assert_allclose(np_(got), np_(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("threshold, edge_is_one", [(0.2, True), (0.05, False)])
def test_sobel_edge_mask_matches_jax(rng, threshold, edge_is_one):
    img = _smooth_image(rng, 3).transpose(2, 0, 1)
    got = np_(tl.sobel_edge_mask(torch.as_tensor(img), threshold, edge_is_one))
    ref = np_(jl.sobel_edge_mask(jnp.asarray(img), threshold, edge_is_one))
    # the magnitude in float64, to find the pixels that sit on the threshold
    g = np.pad(img.astype(np.float64).mean(0), 1)
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    gx = sum(kx[i, j] * g[i:i + H, j:j + W] for i in range(3) for j in range(3))
    gy = sum(kx.T[i, j] * g[i:i + H, j:j + W] for i in range(3) for j in range(3))
    near = np.abs(np.hypot(gx, gy) - threshold) <= 1e-5
    edge = ref if edge_is_one else 1.0 - ref
    assert 0.02 < edge.mean() < 0.98            # both classes are present
    assert got.dtype == np.float32 and got.shape == (H, W)
    np.testing.assert_array_equal(got[~near], ref[~near])


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("is_edge1", [True, False])
def test_image2canny_bit_equal(rng, channels, is_edge1):
    img = _smooth_image(rng, channels)
    if channels == 1:
        img = img[..., 0]                   # a gray (H, W) image
    got = tl.image2canny(img, 50, 150, isEdge1=is_edge1)
    ref = jl.image2canny(img, 50, 150, isEdge1=is_edge1)
    assert got.dtype == ref.dtype == np.float32
    edges = got if is_edge1 else 1.0 - got
    assert 0.0 < edges.mean() < 0.5
    np.testing.assert_array_equal(got, ref)


def test_train_view_canny_mask_matches_jax(rng):
    img = _smooth_image(rng, 3).transpose(2, 0, 1)
    jcam = make_test_camera(W, H)
    jv = JTrainView(camera=jcam, image=img)
    tv = TTrainView(port_camera(jcam), img, None)      # positional as before
    assert tv.depth is None and tv._canny is None
    np.testing.assert_array_equal(tv.canny_mask, jv.canny_mask)
    assert tv.canny_mask is tv.canny_mask               # computed once


def test_homogeneous_transform_matches_jax(rng):
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    got = ttr.homogeneous_transform(torch.as_tensor(pts), torch.as_tensor(m))
    ref = jtr.homogeneous_transform(jnp.asarray(pts), jnp.asarray(m))
    assert got.shape == (5, 7, 4)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=0, atol=1e-6)


def test_camera_from_w2c_matches_jax(rng):
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = q, rng.normal(size=3)
    got = ttr.camera_from_w2c(w2c, 0.9, 0.7, 48, 32, 0.05, 50.0, device="cpu")
    ref = jtr.camera_from_w2c(w2c, 0.9, 0.7, 48, 32, 0.05, 50.0)
    for k in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy"):
        np.testing.assert_allclose(np_(getattr(got, k)), np_(getattr(ref, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert (got.width, got.height, got.znear, got.zfar) == (
        ref.width, ref.height, ref.znear, ref.zfar)
    assert got.viewmatrix.device.type == "cpu"


def test_cov2d_extent_radius_matches_jax(rng):
    a = rng.normal(size=(200, 2, 2)) * rng.uniform(0.1, 30, size=(200, 1, 1))
    cov = np.einsum("nij,nkj->nik", a, a)
    cov2d = np.stack([cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3],
                     -1).astype(np.float32)
    _, tdet = tcov.invert_cov2d(torch.as_tensor(cov2d))
    _, jdet = jcov.invert_cov2d(jnp.asarray(cov2d))
    got = tcov.cov2d_extent_radius(torch.as_tensor(cov2d), tdet)
    ref = jcov.cov2d_extent_radius(jnp.asarray(cov2d), jdet)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=0, atol=1e-6)


def test_render_config_matches_jax():
    got, ref = tconfig.RenderConfig(), jconfig.RenderConfig()
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


# ---------------------------------------------------------------- export

def test_export_all_matches_jax_and_the_shipped_presets(tmp_path):
    got = texport.export_all(str(tmp_path / "port"))
    ref = jexport.export_all(str(tmp_path / "jax"))
    names = [os.path.basename(p) for p in got]
    assert len(got) == 22 and names == [os.path.basename(p) for p in ref]
    assert (texport.FOV_X, texport.FOV_X_12) == (jexport.FOV_X, jexport.FOV_X_12)
    shipped = 0
    for name, g, r in zip(names, got, ref):
        with open(g) as f:
            gd = json.load(f)
        with open(r) as f:
            rd = json.load(f)
        assert gd["camera_angle_x"] == rd["camera_angle_x"], name
        gm = np.array([fr["transform_matrix"] for fr in gd["frames"]])
        rm = np.array([fr["transform_matrix"] for fr in rd["frames"]])
        assert gm.shape == rm.shape and gm.shape[1:] == (3, 4), name
        np.testing.assert_allclose(gm, rm, rtol=0, atol=1e-12, err_msg=name)
        path = os.path.join(REPO, "cameras", name)
        if os.path.exists(path):
            shipped += 1
            with open(path) as f:
                sd = json.load(f)
            sm = np.array([fr["transform_matrix"] for fr in sd["frames"]])
            assert abs(gd["camera_angle_x"] - sd["camera_angle_x"]) <= 1e-9, name
            np.testing.assert_allclose(gm, sm[:, :3], rtol=0, atol=1e-9,
                                       err_msg=name)
    assert shipped > 0


def test_export_camera_json_overrides_the_field_of_view(tmp_path):
    path = texport.export_camera_json("lookdown", str(tmp_path / "a" / "l.json"),
                                      camera_angle_x=1.25)
    with open(path) as f:
        d = json.load(f)
    assert d["camera_angle_x"] == 1.25 and len(d["frames"]) > 0


# ---------------------------------------------------------------- download

PKGS = {"jax": jdl, "port": tdl}


def _payload(tmp_path, data=b"checkpoint bytes " * 1000):
    src = tmp_path / "src.bin"
    src.write_bytes(data)
    return src, hashlib.md5(data).hexdigest()


def test_md5_of_matches_hashlib_and_jax(tmp_path, rng):
    path = tmp_path / "x.bin"
    data = rng.integers(0, 256, size=3 * (1 << 20) + 17, dtype=np.uint8).tobytes()
    path.write_bytes(data)
    assert tdl.md5_of(str(path)) == hashlib.md5(data).hexdigest()
    assert tdl.md5_of(str(path), chunk=4096) == jdl.md5_of(str(path))


@pytest.fixture
def fetches(monkeypatch):
    """Counts the calls of urllib.request.urlretrieve, which both packages
    reach through the urllib module."""
    calls = []
    real = urllib.request.urlretrieve

    def counted(url, dest):
        calls.append(url)
        return real(url, dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", counted)
    return calls


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fetch_checked_keeps_a_verified_cache(tmp_path, fetches, pkg):
    src, md5 = _payload(tmp_path)
    dest = tmp_path / "cache" / "model.bin"
    assert PKGS[pkg].fetch_checked(src.as_uri(), str(dest), md5) == str(dest)
    assert dest.read_bytes() == src.read_bytes() and len(fetches) == 1
    src.write_bytes(b"changed at the source")
    PKGS[pkg].fetch_checked(src.as_uri(), str(dest), md5)
    assert tdl.md5_of(str(dest)) == md5 and len(fetches) == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fetch_checked_replaces_a_corrupt_cache(tmp_path, fetches, pkg):
    src, md5 = _payload(tmp_path)
    dest = tmp_path / "model.bin"
    dest.write_bytes(b"truncated")
    PKGS[pkg].fetch_checked(src.as_uri(), str(dest), md5)
    assert tdl.md5_of(str(dest)) == md5 and len(fetches) == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fetch_checked_md5_mismatch_raises_and_leaves_no_file(tmp_path, fetches,
                                                              pkg):
    src, _ = _payload(tmp_path)
    dest = tmp_path / "model.bin"
    with pytest.raises(IOError, match="md5 mismatch"):
        PKGS[pkg].fetch_checked(src.as_uri(), str(dest), "0" * 32, retries=1)
    assert not dest.exists() and len(fetches) == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fetch_checked_missing_source_raises_after_its_retries(tmp_path,
                                                              fetches, pkg):
    dest = tmp_path / "model.bin"
    with pytest.raises(IOError, match="failed to fetch"):
        PKGS[pkg].fetch_checked((tmp_path / "absent.bin").as_uri(), str(dest),
                                retries=2)
    assert not dest.exists() and len(fetches) == 3
