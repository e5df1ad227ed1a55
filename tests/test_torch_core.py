"""Port parity: core math and preprocess of ``luciddreamer_tpu_torch``
against ``luciddreamer_tpu`` on the same numpy-seeded inputs (CPU, fp32).

Float outputs agree to fp32 roundoff (the two frameworks may order or fuse
operations differently); integer outputs (radii, tile rects, tile counts,
visibility) must be equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.core import covariance as jcov
from luciddreamer_tpu.core import sh as jsh
from luciddreamer_tpu.core import transforms as jtr
from luciddreamer_tpu.render.preprocess import preprocess_gaussians as jpre
from luciddreamer_tpu_torch.core import covariance as tcov
from luciddreamer_tpu_torch.core import sh as tsh
from luciddreamer_tpu_torch.core import transforms as ttr
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians as tpre
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import np_, port_camera, port_params

F32 = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_gaussian_activations_match(rng):
    jp = make_random_gaussians(40, rng, capacity=48)
    # dead capacity rows padded the way load_ply pads them: zero quaternion
    jp = jp.replace(rotation=jp.rotation.at[40:].set(0.0))
    tp = port_params(jp)
    np.testing.assert_allclose(np_(tp.get_scaling()), np_(jp.get_scaling()), **F32)
    np.testing.assert_allclose(np_(tp.get_rotation()), np_(jp.get_rotation()), **F32)
    np.testing.assert_allclose(np_(tp.get_opacity()), np_(jp.get_opacity()), **F32)
    np.testing.assert_array_equal(np_(tp.get_features()), np_(jp.get_features()))
    assert np.isfinite(np_(tp.get_rotation())).all()
    assert tp.capacity == jp.capacity
    assert tp.max_sh_degree == jp.max_sh_degree
    assert int(tp.num_alive) == int(jp.num_alive)


def test_covariance_matches(rng):
    n = 64
    scale = np.exp(rng.uniform(-4, 0, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    mean = (rng.normal(size=(n, 3)) + [0, 0, 3]).astype(np.float32)
    jcam = make_test_camera(48, 32)
    tcam = port_camera(jcam)

    c3_j = jcov.build_cov3d(jnp.asarray(scale), jnp.asarray(q), 1.3)
    c3_t = tcov.build_cov3d(_t(scale), _t(q), 1.3)
    np.testing.assert_allclose(np_(c3_t), np_(c3_j), **F32)

    c2_j = jcov.project_cov3d_to_2d(
        jnp.asarray(mean), c3_j, jcam.viewmatrix, jcam.focal_x, jcam.focal_y,
        jcam.tanfovx, jcam.tanfovy)
    c2_t = tcov.project_cov3d_to_2d(
        _t(mean), c3_t, tcam.viewmatrix, tcam.focal_x, tcam.focal_y,
        tcam.tanfovx, tcam.tanfovy)
    np.testing.assert_allclose(np_(c2_t), np_(c2_j), rtol=1e-5, atol=1e-5)

    conic_j, det_j = jcov.invert_cov2d(c2_j)
    conic_t, det_t = tcov.invert_cov2d(c2_t)
    np.testing.assert_allclose(np_(conic_t), np_(conic_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np_(det_t), np_(det_j), rtol=1e-4)
    np.testing.assert_allclose(
        np_(tcov.cov2d_max_sigma(c2_t, det_t)),
        np_(jcov.cov2d_max_sigma(c2_j, det_j)), rtol=1e-5)


def test_invert_cov2d_singular():
    cov = np.array([[1.0, 1.0, 1.0], [2.0, 0.5, 1.0]], np.float32)
    conic_t, det_t = tcov.invert_cov2d(_t(cov))
    conic_j, det_j = jcov.invert_cov2d(jnp.asarray(cov))
    np.testing.assert_allclose(np_(conic_t), np_(conic_j), **F32)
    np.testing.assert_array_equal(np_(det_t), np_(det_j))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches(rng, deg):
    n = 32
    sh = rng.normal(size=(n, (deg + 1) ** 2, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tsh.eval_sh(deg, _t(sh), _t(d))),
        np_(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))), rtol=1e-5, atol=1e-6)


def test_sh_to_rgb_and_dc_conversions(rng):
    n = 32
    sh = (rng.normal(size=(n, 16, 3)) * 0.5).astype(np.float32)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    means[0] = 0.0                              # a mean on the camera centre
    campos = np.zeros(3, np.float32)
    out_t = tsh.sh_to_rgb_clamped(3, _t(sh), _t(means), _t(campos))
    out_j = jsh.sh_to_rgb_clamped(3, jnp.asarray(sh), jnp.asarray(means),
                                  jnp.asarray(campos))
    np.testing.assert_allclose(np_(out_t), np_(out_j), **F32)
    assert np_(out_t).min() >= 0.0
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(tsh.rgb2sh(_t(rgb))), np_(jsh.rgb2sh(jnp.asarray(rgb))), **F32)
    np.testing.assert_allclose(np_(tsh.sh2rgb(_t(rgb))), np_(jsh.sh2rgb(jnp.asarray(rgb))), **F32)


def test_make_camera_matches(rng):
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = rng.normal(size=3)
    jc = jtr.make_camera(c2w, 0.9, 0.7, 48, 32)
    tc = ttr.make_camera(c2w, 0.9, 0.7, 48, 32, device="cpu")
    for k in ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(np_(getattr(tc, k)), np_(getattr(jc, k)), err_msg=k)
    assert (tc.height, tc.width, tc.znear, tc.zfar) == (jc.height, jc.width, jc.znear, jc.zfar)
    np.testing.assert_allclose(np_(tc.focal_x), np_(jc.focal_x), rtol=1e-7)
    np.testing.assert_array_equal(ttr.projection_matrix(0.1, 50.0, 0.9, 0.7),
                                  jtr.projection_matrix(0.1, 50.0, 0.9, 0.7))
    R, t = c2w[:3, :3], rng.normal(size=3)
    np.testing.assert_array_equal(ttr.world2view(R, t, [0.1, 0.2, 0.3], 1.5),
                                  jtr.world2view(R, t, [0.1, 0.2, 0.3], 1.5))
    assert ttr.focal2fov(ttr.fov2focal(0.9, 48), 48) == jtr.focal2fov(jtr.fov2focal(0.9, 48), 48)


@pytest.mark.parametrize("deg", [1, 3])
def test_preprocess_matches(rng, deg):
    # spread 2.0 puts some Gaussians behind the near plane; capacity rows
    # past P are dead
    jp = make_random_gaussians(200, rng, sh_degree=3, spread=2.0,
                               scale_range=(-3.5, -1.0), capacity=220)
    jcam = make_test_camera(48, 32)
    jproc = jpre(jp, jcam, deg)
    tproc = tpre(port_params(jp), port_camera(jcam), deg)

    vis = np_(jproc.visible)
    assert 0 < vis.sum() < 200
    np.testing.assert_array_equal(np_(tproc.visible), vis)
    for k in ("radius", "tiles_touched"):
        np.testing.assert_array_equal(np_(getattr(tproc, k)), np_(getattr(jproc, k)), err_msg=k)
    # culled rows may hold out-of-range coordinates: rects compare where visible
    for k in ("rect_min", "rect_max"):
        np.testing.assert_array_equal(
            np_(getattr(tproc, k))[vis], np_(getattr(jproc, k))[vis], err_msg=k)
    np.testing.assert_allclose(np_(tproc.depth), np_(jproc.depth), **F32)
    np.testing.assert_allclose(np_(tproc.opacity), np_(jproc.opacity), **F32)
    np.testing.assert_allclose(np_(tproc.rgb), np_(jproc.rgb), **F32)
    np.testing.assert_allclose(np_(tproc.mean2d)[vis], np_(jproc.mean2d)[vis],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np_(tproc.conic)[vis], np_(jproc.conic)[vis],
                               rtol=1e-4, atol=1e-6)
