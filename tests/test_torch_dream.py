"""Port parity of the dream stage: ``luciddreamer_tpu_torch.dream`` against
``luciddreamer_tpu.dream`` on the same numpy-seeded inputs (CPU).

Tolerances: projection, unprojection and the splat atol 1e-5 (the
scatter-add sums in another order); the window filters, edge blend, masks
and ``pad_mask`` exact; the IDW interpolation rtol 1e-5, with and without
distance ties; the noise-free inpainter and the radial depth 1e-6; the
depth scale rtol 1e-4; the border compensation's hole mask exact and its
points atol 1e-4.  A whole ``generate_pcd`` run agrees in point counts
within 0.1%, in its points within 1e-3 on all but 0.5% of the coordinates
(and 1e-2 on those), in its frames up to one grey level on at most 0.5% of
the pixels and in its depths within 1e-4 on all but 1% of the pixels (and
1e-2 on those): tie flips in the interpolation, see the test.
"""
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.config import CameraConfig as JCam
from luciddreamer_tpu.dream import maskops as jmask
from luciddreamer_tpu.dream import pipeline as jpipe
from luciddreamer_tpu.dream import protocols as jproto
from luciddreamer_tpu.dream import warp as jwarp
from luciddreamer_tpu_torch.config import CameraConfig
from luciddreamer_tpu_torch.dream import maskops as tmask
from luciddreamer_tpu_torch.dream import pipeline as tpipe
from luciddreamer_tpu_torch.dream import protocols as tproto
from luciddreamer_tpu_torch.dream import warp as twarp
from tests.port_helpers import (  # noqa: F401  (a fixture)
    np_, one_torch_thread, without_adapters)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H = W = 32


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _K(f, W, H):
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)


def _pose(rng):
    """A random rotation (det +1) and translation, float32."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32), (rng.normal(size=(3, 1)) * 0.3).astype(np.float32)


def _cloud(rng, n):
    """Points in front of a camera at the origin looking down +z, with
    colours, and their pose."""
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 4, n)]).astype(np.float32)
    return pts, rng.uniform(size=(n, 3)).astype(np.float32)


def test_unproject_and_project_match_jax(rng):
    K = _K(40.0, W, H)
    R, T = _pose(rng)
    depth = (1.0 + rng.uniform(size=(H, W))).astype(np.float32)
    jp = jwarp.unproject(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(R),
                         jnp.asarray(T))
    tp = twarp.unproject(_t(depth), _t(K), _t(R), _t(T))
    np.testing.assert_allclose(np_(tp), np_(jp), atol=1e-5, rtol=0)

    cam_pts, _ = _cloud(rng, 500)
    pts = (R.T @ (cam_pts - T)).astype(np.float32)     # in front of (R, T)
    jpix, jz, jvalid = jwarp.project(jnp.asarray(pts), jnp.asarray(K),
                                     jnp.asarray(R), jnp.asarray(T), H, W)
    tpix, tz, tvalid = twarp.project(_t(pts), _t(K), _t(R), _t(T), H, W)
    np.testing.assert_allclose(np_(tpix), np_(jpix), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(tz), np_(jz), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np_(tvalid), np_(jvalid))
    assert 0 < np_(tvalid).sum() < 500


@pytest.mark.parametrize("hole_share", [0.0, 0.3])
def test_splat_linear_matches_jax(rng, hole_share):
    n = 700
    xy = np.stack([rng.uniform(-1, W, n), rng.uniform(-1, H, n)]).astype(np.float32)
    vals = rng.uniform(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) >= hole_share
    jg, jw = jwarp.splat_linear(jnp.asarray(xy), jnp.asarray(vals),
                                jnp.asarray(valid), H, W, fill_iters=8)
    tg, tw = twarp.splat_linear(_t(xy), _t(vals), _t(valid), H, W, fill_iters=8)
    np.testing.assert_allclose(np_(tg), np_(jg), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(tw), np_(jw), atol=1e-5, rtol=0)
    # a grid with holes: some pixels only the fill reached
    assert (np_(jw) < 1.0).any() and np.isfinite(np_(tg)).all()


def _grid_points(rng):
    """Pixel-centred points with jitter; 60% valid, none in a 14 x 14
    square (a hole that the 9 x 9 dilation leaves open)."""
    x, y = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    xy = np.stack([x.ravel(), y.ravel()]).astype(np.float32)
    xy += rng.uniform(-0.45, 0.45, size=xy.shape).astype(np.float32)
    valid = rng.uniform(size=(H, W)) < 0.6
    valid[8:22, 8:22] = False
    return xy, valid.ravel()


@pytest.mark.parametrize("case", ["max9", "min11", "pad_mask3", "edge_blend2d",
                                  "edge_blend3d"])
def test_window_ops_exact(rng, case):
    x = rng.uniform(size=(H, W)).astype(np.float32)
    if case == "max9":
        j, t = jwarp.max_filter(jnp.asarray(x), 9), twarp.max_filter(_t(x), 9)
    elif case == "min11":
        j, t = jwarp.min_filter(jnp.asarray(x), 11), twarp.min_filter(_t(x), 11)
    elif case == "pad_mask3":
        m = (x > 0.97).astype(np.float32)
        j, t = jmask.pad_mask(m, 3), tmask.pad_mask(m, 3)
        assert 0 < np_(t).sum() < H * W
    elif case == "edge_blend2d":
        j, t = jwarp.edge_blend(jnp.asarray(x)), twarp.edge_blend(_t(x))
    else:
        x3 = rng.uniform(size=(H, W, 3)).astype(np.float32)
        j, t = jwarp.edge_blend(jnp.asarray(x3), 3), twarp.edge_blend(_t(x3), 3)
    np.testing.assert_array_equal(np_(t), np_(j))


def test_masks_exact(rng):
    xy, valid = _grid_points(rng)
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    jdot = jwarp.scatter_dot_mask(jnp.asarray(xy), jnp.asarray(valid), H, W)
    tdot = twarp.scatter_dot_mask(_t(xy), _t(valid), H, W)
    np.testing.assert_array_equal(np_(tdot), np_(jdot))
    jimg, jm2 = jwarp.warp_masks(jnp.asarray(xy), jnp.asarray(valid),
                                 jnp.asarray(img), H, W)
    timg, tm2 = twarp.warp_masks(_t(xy), _t(valid), _t(img), H, W)
    np.testing.assert_array_equal(np_(tm2), np_(jm2))
    np.testing.assert_array_equal(np_(timg), np_(jimg))
    assert 0 < np_(tm2).sum() < H * W          # the mask has an edge
    np.testing.assert_array_equal(np_(twarp.border_mask(tm2)),
                                  np_(jwarp.border_mask(jm2)))
    assert np_(twarp.border_mask(tm2)).any()


def test_controlnet_condition_matches_jax(rng):
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        np_(tmask.controlnet_inpaint_condition(img, mask)),
        np_(jmask.controlnet_inpaint_condition(img, mask)))


@pytest.mark.parametrize("ties", [False, True])
def test_idw_interpolate_matches_jax(rng, ties):
    """Random anchors; and anchors on integer pixels queried at integer
    pixels, where distances tie and the lower index must win."""
    anchors = rng.uniform(0, W - 1, size=(300, 2)).astype(np.float32)
    vals = rng.uniform(0.5, 2.0, size=300).astype(np.float32)  # no cancellation
    q = rng.uniform(0, W - 1, size=(1000, 2)).astype(np.float32)
    if ties:
        anchors, q = np.round(anchors), np.round(q)
    j = jwarp.idw_interpolate(jnp.asarray(anchors), jnp.asarray(vals),
                              jnp.asarray(q), query_block=128)
    t = twarp.idw_interpolate(_t(anchors), _t(vals), _t(q), query_block=128)
    np.testing.assert_allclose(np_(t), np_(j), rtol=1e-5, atol=0)


def test_inpainter_and_depth_match_jax(rng):
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), np.float32)
    mask[5:20, 8:30] = 1.0
    j = jproto.ClassicInpainter(noise_scale=0.0)(img, mask, steps=3)
    t = tproto.ClassicInpainter(noise_scale=0.0)(_t(img), _t(mask), steps=3)
    np.testing.assert_allclose(np_(t), np_(j), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np_(t)[mask == 0], img[mask == 0])
    np.testing.assert_allclose(np_(tproto.RadialDepth()(_t(img))),
                               np_(jproto.RadialDepth()(img)), atol=1e-6, rtol=0)
    # with noise: a seeded generator repeats, and stays in [0, 1]
    noisy = [tproto.ClassicInpainter()(_t(img), _t(mask), steps=2,
                                       rng=torch.Generator().manual_seed(4))
             for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1])
    assert 0.0 <= float(noisy[0].min()) and float(noisy[0].max()) <= 1.0


def test_registry_builds_adapters_lazily_and_refuses(monkeypatch):
    """The adapters register when first asked for: without their packages
    ``sd``, ``sd_controlnet`` and ``zoedepth`` raise ImportError, and
    ``lama`` (torch only) registers its factory."""
    without_adapters(monkeypatch, tproto)
    monkeypatch.setitem(sys.modules, "diffusers", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    for name in ("sd", "sd_controlnet"):
        with pytest.raises(ImportError):
            tproto.get_inpainter(name, device="cpu")
    with pytest.raises(ImportError):
        tproto.get_depth_estimator("zoedepth", device="cpu")
    assert tproto.inpainter_factory("lama").__name__ == "LamaInpainter"
    # zoedepth_flax is ported: the port's ZoeDepth, built where asked
    from luciddreamer_tpu_torch.models import ZoeDepthEstimator

    est = tproto.get_depth_estimator("zoedepth_flax", device="cpu")
    assert isinstance(est, ZoeDepthEstimator)
    assert {p.device.type for p in est.model.parameters()} == {"cpu"}
    with pytest.raises(KeyError):
        tproto.get_depth_estimator("no-such-backend")
    with pytest.raises(KeyError):
        tproto.get_inpainter("no-such-backend")
    with pytest.raises(ValueError, match="checkpoint"):
        tproto.get_inpainter("classic", model="some/model")
    assert isinstance(tproto.get_inpainter(), tproto.ClassicInpainter)
    assert tproto.resolve_sd_checkpoint("org/model") == "org/model"
    assert tproto.resolve_sd_checkpoint(None) is None


def _align_inputs(rng):
    Hs = Ws = 16
    K = _K(20.0, Ws, Hs)
    R, T = _pose(rng)
    depth = (2.0 + rng.uniform(size=(Hs, Ws))).astype(np.float32)
    true = np.asarray(jwarp.unproject(jnp.asarray(depth), jnp.asarray(K),
                                      jnp.asarray(R), jnp.asarray(T)))
    pts = true * 1.7 + rng.normal(size=true.shape).astype(np.float32) * 0.01
    pix, _, valid = jwarp.project(jnp.asarray(true), jnp.asarray(K),
                                  jnp.asarray(R), jnp.asarray(T), Hs, Ws)
    return pts, np.asarray(pix), np.asarray(valid), depth, K, R, T


@pytest.mark.parametrize("mode", ["closed_form", "adam", "reference"])
def test_align_scale_matches_jax(rng, mode):
    args = _align_inputs(rng)
    j = jpipe._align_scale(mode, *[jnp.asarray(a) for a in args])
    t = tpipe._align_scale(mode, *[_t(a) for a in args])
    np.testing.assert_allclose(float(t), float(j), rtol=1e-4)
    if mode == "closed_form":
        assert float(t) == pytest.approx(1.7, rel=1e-2)


def test_border_compensation_matches_jax(rng):
    """More valid border anchors than ANCHOR_CAP: the first ANCHOR_CAP in
    index order are kept."""
    Hs = Ws = 64
    n = 10_000
    K = _K(60.0, Ws, Hs)
    R, T = _pose(rng)
    pix = rng.uniform(0, Ws - 1, size=(2, n)).astype(np.float32)
    pts = (rng.normal(size=(3, n)) + [[0], [0], [3]]).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    border = rng.uniform(size=n) < 0.95
    assert (valid & border).sum() > tpipe.ANCHOR_CAP
    depth = (2.0 + rng.uniform(size=(Hs, Ws))).astype(np.float32)
    mask2 = (rng.uniform(size=(Hs, Ws)) < 0.5).astype(np.float32)
    z = np.ones(n, np.float32)
    jw, jh = jpipe._border_compensation(
        jnp.asarray(pts), jnp.asarray(pix), jnp.asarray(z), jnp.asarray(valid),
        jnp.asarray(border), jnp.asarray(depth), jnp.asarray(mask2),
        jnp.float32(1.3), jnp.asarray(K), jnp.asarray(R), jnp.asarray(T),
        Hs, Ws)
    tw, th = tpipe._border_compensation(
        _t(pts), _t(pix), _t(valid), _t(border), _t(depth), _t(mask2),
        torch.tensor(1.3), _t(K), _t(R), _t(T), Hs, Ws)
    np.testing.assert_array_equal(np_(th), np_(jh))
    np.testing.assert_allclose(np_(tw), np_(jw), atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(32, 32), (40, 36), (32, 64)])
def test_condition_input_matches_jax(rng, shape):
    """Crop without a resize, crop + resize, and outpainting of a wide
    image (a noise-free inpainter on both sides)."""
    img = rng.uniform(size=shape + (3,)).astype(np.float32)
    jcam = JCam(image_width=W, image_height=H, focal=(30.0, 30.0))
    tcam = CameraConfig(image_width=W, image_height=H, focal=(30.0, 30.0))
    j = jpipe._condition_input(img, jcam, jproto.ClassicInpainter(0.0), "",
                               "", 1, None)
    t = tpipe._condition_input(img, tcam, tproto.ClassicInpainter(0.0), "",
                               "", 1, None, torch.device("cpu"))
    np.testing.assert_allclose(np_(t), np_(j), atol=1e-6, rtol=0)


def test_dream_views_match_jax_on_the_same_inputs(rng):
    """The first three views of a 64x64 rotate360 dream, each stage of the
    port fed the JAX package's own inputs: the warp exact, the inpainter,
    depth and scale within rounding, the hole mask exact and the lifted
    points within 1e-5.  (A whole run, below, feeds each side its own
    output, and there rounding-level differences flip near-tied IDW
    anchors.)"""
    from luciddreamer_tpu.trajectory import get_pcdgen_poses

    size = 64
    cam = JCam(image_width=size, image_height=size, focal=(70.0, 70.0))
    K = jnp.asarray(cam.K)
    jinp, jdep = jproto.ClassicInpainter(0.0), jproto.RadialDepth()
    tinp, tdep = tproto.ClassicInpainter(0.0), tproto.RadialDepth()
    img = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
    image = np.asarray(jpipe._condition_input(jpipe._to_image01(img), cam,
                                              jinp, "", "", 2, None))
    poses = get_pcdgen_poses("rotate360").astype(np.float32)
    pts = np.asarray(jwarp.unproject(jdep(image), K, poses[0, :3, :3],
                                     poses[0, :3, 3:4]))
    cols = image.reshape(-1, 3)
    for i in (1, 2, 3):
        R, T = poses[i, :3, :3], poses[i, :3, 3:4]
        jv = jpipe._warp_view(jnp.asarray(pts), jnp.asarray(cols),
                              jnp.ones(pts.shape[1], bool), K, R, T,
                              size, size, 2)
        tv = tpipe._warp_view(_t(pts), _t(cols), _t(K), _t(R), _t(T),
                              size, size, 2)
        for name, j, t in zip(("image2", "mask2", "depth2", "mask_hf", "pix",
                               "z", "valid"), jv, tv):
            np.testing.assert_allclose(np_(t), np_(j), atol=1e-5, rtol=0,
                                       err_msg=f"view {i} {name}")
        image2, mask2, _, mask_hf, pix, _, valid = jv
        image = np.asarray(jinp(image2, 1.0 - mask2, steps=2))
        np.testing.assert_allclose(
            np_(tinp(_t(image2), 1.0 - _t(mask2), steps=2)), image, atol=1e-5)
        depth = jdep(image)
        np.testing.assert_allclose(np_(tdep(_t(image))), np_(depth), atol=1e-5)
        args = (pix, valid, depth, K, R, T)
        sc = jpipe._align_scale("closed_form", jnp.asarray(pts), *args)
        np.testing.assert_allclose(
            float(tpipe._align_scale("closed_form", _t(pts),
                                     *[_t(a) for a in args])),
            float(sc), rtol=1e-5)
        u = jnp.clip(jnp.round(pix[0]), 0, size - 1).astype(jnp.int32)
        v = jnp.clip(jnp.round(pix[1]), 0, size - 1).astype(jnp.int32)
        border = mask_hf[v, u] > 0.5
        jw, jh = jpipe._border_compensation(
            jnp.asarray(pts), pix, jv[5], valid, border, depth, mask2, sc,
            K, R, T, size, size)
        tw, th = tpipe._border_compensation(
            _t(pts), _t(pix), _t(valid), _t(border), _t(depth), _t(mask2),
            torch.tensor(float(sc)), _t(K), _t(R), _t(T), size, size)
        hole = np.asarray(jh)
        np.testing.assert_array_equal(np_(th), hole)
        assert hole.any()
        np.testing.assert_allclose(np_(tw)[:, hole], np.asarray(jw)[:, hole],
                                   atol=1e-5, rtol=0, err_msg=f"view {i}")
        pts = np.concatenate([pts, np.asarray(jw)[:, hole]], 1)
        cols = np.concatenate([cols, image.reshape(-1, 3)[hole]], 0)


def test_generate_pcd_matches_jax(rng):
    """A whole dream at 64x64 on rotate360 (10 poses, 50 frames) with a
    noise-free inpainter registered under one name on both sides."""
    jproto.register_inpainter("quiet", lambda: jproto.ClassicInpainter(0.0))
    tproto.register_inpainter("quiet", lambda: tproto.ClassicInpainter(0.0))
    size = 64
    img = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
    kw = dict(prompt="a test scene", pcdgenpath="rotate360", seed=1,
              diff_steps=2)
    jtd = jpipe.generate_pcd(
        img, cam=JCam(image_width=size, image_height=size, focal=(70.0, 70.0)),
        config=jpipe.DreamConfig(inpainter="quiet", fill_iters=2), **kw)
    ttd = tpipe.generate_pcd(
        img, cam=CameraConfig(image_width=size, image_height=size,
                              focal=(70.0, 70.0)),
        config=tpipe.DreamConfig(inpainter="quiet", fill_iters=2),
        device="cpu", **kw)
    jn, tn = jtd["pcd_points"].shape[1], ttd["pcd_points"].shape[1]
    assert tn > size * size and abs(tn - jn) <= 1e-3 * jn, (tn, jn)
    if tn == jn:
        # the border compensation's 4-NN anchors nearly tie in this
        # symmetric scene; differences of ~1e-6 carried from view to view
        # (the inpainter's sums, the scale) pick the other anchor for some
        # pixels, and a lifted point then moves by up to ~6e-3 (ROADMAP,
        # Queue 3); fed the same inputs, each view agrees within 1e-5 (the
        # test above)
        d = np.abs(ttd["pcd_points"] - jtd["pcd_points"])
        assert (d > 1e-3).mean() <= 5e-3 and d.max() <= 1e-2, (
            (d > 1e-3).mean(), d.max())
        np.testing.assert_allclose(ttd["pcd_colors"], jtd["pcd_colors"],
                                   atol=1e-3, rtol=0)
    assert ttd["camera_angle_x"] == pytest.approx(jtd["camera_angle_x"])
    assert len(ttd["frames"]) == len(jtd["frames"]) == 50
    for tf, jf in zip(ttd["frames"], jtd["frames"]):
        np.testing.assert_allclose(tf["transform_matrix"],
                                   jf["transform_matrix"], atol=1e-6)
        assert tf["image"].dtype == np.uint8
        diff = np.abs(tf["image"].astype(int) - jf["image"].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    # the depths see the moved points above: within 1e-4 on 99% of pixels
    dd = np.stack([np.abs(tf["depth"] - np.asarray(jf["depth"]))
                   for tf, jf in zip(ttd["frames"], jtd["frames"])])
    assert (dd > 1e-4).mean() <= 0.01 and dd.max() <= 1e-2, (
        (dd > 1e-4).mean(), dd.max())
