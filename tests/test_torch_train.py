"""Port parity and behaviour of the training loop: one ``Trainer._step`` of
``luciddreamer_tpu_torch`` against the JAX package's on the same state,
view and image (JAX with its Pallas kernels in interpret mode and with its
XLA scan), and ``Trainer.run`` on the CPU, mirroring
tests/test_train_loop.py.

Step tolerances: loss within 1e-5; gradients atol 5e-4 scaled by the
group's max (tests/test_pallas_blend.py); densify stats equal, the sums
of gradient norms at the gradient tolerance; new parameters within 1e-6
where the gradient exceeds 1e-3 of its group's max, since Adam's first
step moves every other entry by +-lr on the sign of a near-zero gradient
(a group with no gradient, the masked SH bands at step 1, stays as it
was).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.config import GSConfig as JConfig
from luciddreamer_tpu.train.loop import Trainer as JTrainer
from luciddreamer_tpu.train.loop import sh_band_mask as j_sh_mask
from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.model.gaussians import create_from_pcd
from luciddreamer_tpu_torch.model.optim import GROUPS
from luciddreamer_tpu_torch.render.tiled import render_tiled
from luciddreamer_tpu_torch.train.loop import Trainer
from luciddreamer_tpu_torch.core.types import GaussianParams
from tests.helpers import make_random_gaussians, make_test_camera
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    assert_scaled_close, np_, one_torch_thread, port_camera, port_params,
    port_state,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PORT_NAMES = dict(xyz="xyz", f_dc="features_dc", f_rest="features_rest",
                  scaling="scaling", rotation="rotation", opacity="opacity")


def _both_trainers(rng, jax_backend, pair_cap=None, lambda_depth=0.0):
    jp = make_random_gaussians(60, rng, scale_range=(-3.0, -1.5), capacity=64)
    kw = dict(lambda_depth=lambda_depth)
    jtr = JTrainer(jp, JConfig(**kw), 1.3, pair_cap=pair_cap,
                   backend=jax_backend, chunk=32)
    ttr = Trainer(port_params(jp), GSConfig(**kw), 1.3, pair_cap=pair_cap,
                  backend="cuda", chunk=32, device="cpu")
    return jtr, ttr


@pytest.mark.parametrize("jax_backend", ["pallas", "xla"])
def test_trainer_step_matches_jax(rng, jax_backend):
    jtr, ttr = _both_trainers(rng, jax_backend, lambda_depth=0.3)
    jcam = make_test_camera(32, 32)
    img = rng.uniform(size=(3, 32, 32)).astype(np.float32)
    depth = rng.uniform(2.0, 4.0, size=(32, 32)).astype(np.float32)
    jimg, jdepth = jnp.asarray(img), jnp.asarray(depth)
    js = jtr.state
    jnew, jloss, jovf = jax.jit(jtr._step)(js, jcam, jimg, jdepth)
    # the JAX step's gradients, as its _step takes them
    pd = js.params.param_pytree()
    offset = jnp.zeros_like(js.params.xyz[:, :2])
    (_, _), (jgrads, jg2d) = jax.jit(jax.value_and_grad(
        jtr._render_loss, argnums=(0, 1), has_aux=True),
        static_argnums=())(pd, offset, js.params.alive, jcam, jimg, jdepth,
                           j_sh_mask(0, 15))

    ts = port_state(js)
    cam, timg, tdepth = port_camera(jcam), torch.as_tensor(img), torch.as_tensor(depth)
    tloss, aux, tgrads, tg2d = ttr._loss_and_grads(ts, cam, timg, tdepth)
    tnew, tloss2, tovf = ttr._step(ts, cam, timg, tdepth)

    assert not bool(jovf) and not bool(tovf)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    assert float(tloss2) == float(tloss)
    for k in GROUPS:
        assert_scaled_close(tgrads[k], jgrads[k], 5e-4, err_msg=k)
    assert_scaled_close(tg2d, jg2d, 5e-4, err_msg="mean2d_offset")

    assert_scaled_close(tnew.stats.grad_accum, jnew.stats.grad_accum, 5e-4)
    np.testing.assert_array_equal(np_(tnew.stats.denom), np_(jnew.stats.denom))
    np.testing.assert_array_equal(np_(tnew.stats.max_radii2d),
                                  np_(jnew.stats.max_radii2d))
    for k in GROUPS:
        g = np.abs(np_(jgrads[k]))
        big = g > 1e-3 * g.max() if g.max() > 0 else np.ones(g.shape, bool)
        np.testing.assert_allclose(
            np_(getattr(tnew.params, PORT_NAMES[k]))[big],
            np_(getattr(jnew.params, PORT_NAMES[k]))[big], atol=1e-6, rtol=0,
            err_msg=k)
    assert int(tnew.step) == int(jnew.step) == 1
    assert int(tnew.adam.count) == int(jnew.adam.count) == 1


def test_trainer_step_overflow_changes_nothing(rng):
    jtr, ttr = _both_trainers(rng, "xla", pair_cap=16)
    jcam = make_test_camera(32, 32)
    img = rng.uniform(size=(3, 32, 32)).astype(np.float32)
    ts = port_state(jtr.state)
    new, loss, ovf = ttr._step(ts, port_camera(jcam), torch.as_tensor(img), None)
    _, _, jovf = jax.jit(jtr._step)(jtr.state, jcam, jnp.asarray(img), None)
    assert bool(ovf) and bool(jovf)
    assert int(new.step) == 0 and int(new.adam.count) == 0
    for k in PORT_NAMES.values():
        assert torch.equal(getattr(new.params, k), getattr(ts.params, k)), k
    for k in GROUPS:
        assert torch.equal(new.adam.mu[k], ts.adam.mu[k])
        assert torch.equal(new.adam.nu[k], ts.adam.nu[k])
    assert not new.stats.denom.any() and not new.stats.grad_accum.any()


def _target_scene(rng, W=32, H=32):
    """Ground-truth images rendered by the port from a random scene."""
    true = port_params(make_random_gaussians(40, rng, scale_range=(-3.0, -1.5)))
    views = []
    for dx in (-0.3, 0.0, 0.3):
        c2w = np.eye(4)
        c2w[0, 3] = dx
        cam = make_camera(c2w, 0.8279, 0.8279, W, H, device="cpu")
        with torch.no_grad():
            img = render_tiled(true, cam, torch.zeros(3), active_sh_degree=3)["render"]
        views.append((cam, img))
    return views


def _pcd_params(rng, n, capacity, spread, z):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * spread + [0, 0, z]
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return create_from_pcd(torch.as_tensor(pts, dtype=torch.float32),
                           torch.as_tensor(cols), capacity=capacity)


def test_training_reduces_loss(rng):
    views = _target_scene(rng)
    params = _pcd_params(rng, 60, 256, 0.8, 3.0)
    cfg = GSConfig(iterations=120, densification_interval=30,
                   densify_from_iter=30, position_lr_max_steps=120,
                   densify_grad_threshold=1e-5)
    tr = Trainer(params, cfg, cameras_extent=1.0, seed=0, device="cpu")
    losses = []
    tr.run(views, callback=lambda it, st, l: losses.append(float(l)))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < 0.7 * first, (first, last)
    assert np.isfinite(losses).all()
    assert int(tr.state.params.num_alive) != 60     # densify changed it
    assert int(tr.state.step) == 120


def test_training_with_depth_loss(rng):
    views = [(c, img, torch.full((32, 32), 2.5)) for c, img in _target_scene(rng)]
    params = _pcd_params(rng, 30, 64, 0.5, 2.5)
    cfg = GSConfig(iterations=20, lambda_depth=0.5, densify_from_iter=1000)
    state = Trainer(params, cfg, cameras_extent=1.0, seed=0, device="cpu").run(views)
    assert int(state.step) == 20
    assert torch.isfinite(state.params.xyz).all()


def test_trainer_grows_pair_capacity_on_overflow(rng):
    views = _target_scene(rng)
    params = _pcd_params(rng, 40, 64, 0.5, 3.0)
    cfg = GSConfig(iterations=3, densify_from_iter=1000)
    tr = Trainer(params, cfg, cameras_extent=1.0, pair_cap=16, chunk=64,
                 seed=0, device="cpu")
    state = tr.run(views)
    assert tr.last_overflow
    assert tr.pair_cap >= 32
    assert int(state.step) == 3                     # overflowed steps re-run


def test_trainer_needs_cuda_unless_told_cpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = port_params(make_random_gaussians(8, rng))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(params, GSConfig(), 1.0)
    assert isinstance(Trainer(params, GSConfig(), 1.0, device="cpu").state.params,
                      GaussianParams)
