"""Port parity: ``render_tiled`` of ``luciddreamer_tpu_torch`` against the
JAX package's ``render_tiled`` with its XLA scan backend and with its
Pallas kernel K1 in interpret mode (CPU).

The cases and tolerances are those of tests/test_pallas_blend.py: render,
final_T and acc atol 1e-5, depth atol 1e-4; n_contrib, radii, num_pairs
and overflow equal.  On the CPU the port's ``cuda`` backend runs the plain
PyTorch version of K1.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.render.tiled import render_tiled as jrender
from luciddreamer_tpu_torch.render import blend_math, cuda_blend
from luciddreamer_tpu_torch.render.tiled import render_tiled as trender
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import np_, port_camera, port_params

KEYS_CLOSE = {"render": 1e-5, "final_T": 1e-5, "acc": 1e-5, "depth": 1e-4}
KEYS_EQUAL = ("n_contrib", "radii", "num_pairs", "overflow", "visibility_filter")


def _render_both(jp, jcam, bg, jax_backend, **kw):
    ref = jax.jit(
        lambda p: jrender(p, jcam, jnp.asarray(bg), backend=jax_backend, **kw)
    )(jp)
    with torch.no_grad():
        out = trender(port_params(jp), port_camera(jcam), torch.as_tensor(bg),
                      backend="cuda", **kw)
    return ref, out


def _assert_match(ref, out):
    for k, atol in KEYS_CLOSE.items():
        np.testing.assert_allclose(np_(out[k]), np_(ref[k]), atol=atol, err_msg=k)
    for k in KEYS_EQUAL:
        np.testing.assert_array_equal(np_(out[k]), np_(ref[k]), err_msg=k)
    np.testing.assert_allclose(np_(out["mean2d"]), np_(ref["mean2d"]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("jax_backend,P,W,H,deg", [
    ("xla", 80, 32, 32, 3),
    ("xla", 250, 48, 32, 1),
    ("pallas", 80, 32, 32, 3),
])
def test_render_tiled_matches_jax(rng, jax_backend, P, W, H, deg):
    jp = make_random_gaussians(P, rng, scale_range=(-3.5, -1.0))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref, out = _render_both(jp, make_test_camera(W, H), bg, jax_backend,
                            active_sh_degree=deg, chunk=32)
    assert not bool(out["overflow"])
    _assert_match(ref, out)


def test_render_tiled_early_termination_matches_jax(rng):
    """Dense opaque wall: the done latch decides most pixels."""
    P = 120
    jp = make_random_gaussians(P, rng, scale_range=(-2.5, -1.0), spread=0.3)
    jp = jp.replace(opacity=jnp.full((P, 1), 8.0))
    ref, out = _render_both(jp, make_test_camera(32, 32),
                            np.zeros(3, np.float32), "xla",
                            active_sh_degree=0, chunk=16)
    assert float(np_(out["final_T"]).min()) < blend_math.T_MIN * 10
    _assert_match(ref, out)


def test_render_tiled_overflow_matches_jax(rng):
    jp = make_random_gaussians(200, rng, scale_range=(-2.5, -1.0))
    ref, out = _render_both(jp, make_test_camera(32, 32),
                            np.zeros(3, np.float32), "xla",
                            pair_cap=32, chunk=16)
    assert bool(ref["overflow"]) and bool(out["overflow"])
    assert int(out["num_pairs"]) == int(ref["num_pairs"]) > 32


def test_torch_backend_is_the_plain_blend_on_cpu(rng):
    """On CPU tensors both backends run the plain version; the kernels'
    launch counters do not move."""
    jp = make_random_gaussians(60, rng, scale_range=(-3.0, -1.0))
    params, cam = port_params(jp), port_camera(make_test_camera(32, 32))
    bg = torch.tensor([0.3, 0.2, 0.1])
    before = (cuda_blend.blend_fwd.launches, cuda_blend.blend_bwd.launches)
    with torch.no_grad():
        a = trender(params, cam, bg, chunk=16, backend="cuda")
        b = trender(params, cam, bg, chunk=16, backend="torch")
    assert (cuda_blend.blend_fwd.launches,
            cuda_blend.blend_bwd.launches) == before
    for k in ("render", "depth", "acc", "final_T", "n_contrib"):
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError):
        trender(params, cam, bg, backend="xla")


def test_plain_blend_is_differentiable(rng):
    jp = make_random_gaussians(40, rng, scale_range=(-3.0, -1.0))
    params, cam = port_params(jp), port_camera(make_test_camera(32, 32))
    out = trender(params, cam, torch.zeros(3), chunk=16, backend="torch")
    (out["render"].sum() + out["depth"].sum()).backward()
    for name, p in params.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert params.xyz.grad.abs().sum() > 0


def test_pair_cap_alignment_matches_jax(rng):
    """pair_cap 1100 at chunk 64: the JAX package aligns to lcm(64, 1024),
    giving 2048 slots; aligning to the chunk alone would give 1152.  A scene
    with a pair count between the two must not overflow on either side."""
    jp = make_random_gaussians(250, rng, scale_range=(-2.0, -0.5))
    ref, out = _render_both(jp, make_test_camera(48, 48),
                            np.zeros(3, np.float32), "xla",
                            pair_cap=1100, chunk=64)
    assert 1152 < int(ref["num_pairs"]) < 2048
    assert int(out["num_pairs"]) == int(ref["num_pairs"])
    assert not bool(ref["overflow"]) and not bool(out["overflow"])
    _assert_match(ref, out)
