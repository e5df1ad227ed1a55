"""Port parity, training building blocks: losses, Adam and the learning
rates, the SH band mask, knn, the Gaussian-model ops and checkpoints of
``luciddreamer_tpu_torch`` against ``luciddreamer_tpu`` (CPU).

Float results agree within 1e-6 (knn: rtol 2e-4, as
tests/test_points_model.py, for the |r|^2 + |c|^2 - 2 r.c cancellation);
masks, counts and integer fields are equal.  Densify gets the JAX package's
own normal draws.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.config import GSConfig as JConfig
from luciddreamer_tpu.model import gaussians as jg
from luciddreamer_tpu.model import optim as jopt
from luciddreamer_tpu.points.knn import knn_sq_dists as jknn
from luciddreamer_tpu.train import losses as jloss
from luciddreamer_tpu.train.loop import sh_band_mask as j_sh_mask
from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.model import gaussians as tg
from luciddreamer_tpu_torch.model import optim as topt
from luciddreamer_tpu_torch.points.knn import knn_sq_dists as tknn
from luciddreamer_tpu_torch.train import losses as tloss
from luciddreamer_tpu_torch.train.checkpoint import (
    load_checkpoint, save_checkpoint, state_to_dict,
)
from luciddreamer_tpu_torch.train.loop import TrainState, sh_band_mask
from tests.helpers import make_random_gaussians
from tests.port_helpers import np_, one_torch_thread, port_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GROUPS = topt.GROUPS
T = torch.as_tensor


def _close(a, b, atol=1e-6, rtol=1e-6, msg=""):
    np.testing.assert_allclose(np_(a), np_(b), atol=atol, rtol=rtol, err_msg=msg)


def test_losses_match_jax(rng):
    a = rng.uniform(size=(3, 40, 36)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    for name in ("l1_loss", "l2_loss", "mse", "psnr"):
        _close(getattr(tloss, name)(T(a), T(b)),
               getattr(jloss, name)(jnp.asarray(a), jnp.asarray(b)),
               rtol=2e-6, msg=name)
    _close(tloss.ssim(T(a), T(b)), jloss.ssim(jnp.asarray(a), jnp.asarray(b)))
    _close(tloss.ssim(T(a), T(b), size_average=False),
           jloss.ssim(jnp.asarray(a), jnp.asarray(b), size_average=False))
    # the SSIM gradient too: the loss of a training step goes through it
    ta = T(a).requires_grad_()
    tloss.ssim(ta, T(b)).backward()
    ga = jax.grad(lambda x: jloss.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    _close(ta.grad, ga, atol=1e-7, rtol=1e-4)


def _param_dicts(rng, P=20):
    shapes = dict(xyz=(P, 3), f_dc=(P, 1, 3), f_rest=(P, 15, 3), scaling=(P, 3),
                  rotation=(P, 4), opacity=(P, 1))
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_adam_and_learning_rates_match_jax(rng):
    cfg, jcfg = GSConfig(), JConfig()
    p = _param_dicts(rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: T(v) for k, v in p.items()}
    jst, tst = jopt.adam_init(jp), topt.adam_init(tp)
    for step in (0, 1, 700, 2990, 5000):
        j_lr = jopt.learning_rates(jcfg, 2.5, jnp.int32(step))
        t_lr = topt.learning_rates(cfg, 2.5, torch.tensor(step, dtype=torch.int32))
        for k in GROUPS:
            _close(t_lr[k], j_lr[k], rtol=1e-6, atol=0, msg=f"lr {k} @ {step}")
    for step in range(3):
        g = _param_dicts(rng)
        lrs = topt.learning_rates(cfg, 2.5, step)
        jp, jst = jopt.adam_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                   jst, jopt.learning_rates(jcfg, 2.5, step))
        tp, tst = topt.adam_update(tp, {k: T(v) for k, v in g.items()}, tst, lrs)
    assert int(tst.count) == int(jst.count) == 3
    for k in GROUPS:
        _close(tp[k], jp[k], msg=k)
        _close(tst.mu[k], jst.mu[k], msg=k)
        _close(tst.nu[k], jst.nu[k], msg=k)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_band_mask_matches_jax(degree):
    np.testing.assert_array_equal(np_(sh_band_mask(degree, 15)),
                                  np_(j_sh_mask(degree, 15)))
    np.testing.assert_array_equal(
        np_(sh_band_mask(torch.tensor(degree, dtype=torch.int32), 15)),
        np_(j_sh_mask(jnp.int32(degree), 15)))


def test_knn_matches_jax(rng):
    P = 300
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    alive = rng.uniform(size=P) > 0.2
    ref = np.asarray(jknn(jnp.asarray(pts), jnp.asarray(alive), row_block=64,
                          col_block=128))
    for rb, cb in ((64, 128), (4096, 16384)):
        out = tknn(T(pts), T(alive), row_block=rb, col_block=cb)
        np.testing.assert_allclose(np_(out), ref, rtol=2e-4, atol=1e-6)
    assert not np_(out)[~alive].any()
    # fewer than 3 alive points: the missing neighbours are 0
    few = np.zeros(8, bool)
    few[[1, 5]] = True
    ref = np.asarray(jknn(jnp.asarray(pts[:8]), jnp.asarray(few)))
    out = tknn(T(pts[:8]), T(few))
    np.testing.assert_allclose(np_(out), ref, rtol=2e-4, atol=1e-6)
    assert (np_(out)[few][:, 1:] == 0).all()


def test_create_from_pcd_matches_jax(rng):
    pts = (rng.normal(size=(90, 3)) + [0, 0, 3]).astype(np.float32)
    cols = rng.uniform(size=(90, 3)).astype(np.float32)
    ref = jg.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), capacity=128)
    out = tg.create_from_pcd(T(pts), T(cols), capacity=128)
    for k in ("xyz", "features_dc", "features_rest", "rotation", "opacity"):
        _close(getattr(out, k), getattr(ref, k), msg=k)
    _close(out.scaling, ref.scaling, rtol=1e-4, atol=1e-5)   # knn rounding
    np.testing.assert_array_equal(np_(out.alive), np_(ref.alive))
    with pytest.raises(ValueError):
        tg.create_from_pcd(T(pts), T(cols), capacity=10)


def _states(rng, P=12, capacity=32):
    jp = make_random_gaussians(P, rng, capacity=capacity)
    jadam = jopt.adam_init(jp.param_pytree())
    jadam = jadam.replace(
        mu={k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
            for k, v in jadam.mu.items()},
        nu={k: jnp.asarray(rng.uniform(size=v.shape), jnp.float32)
            for k, v in jadam.nu.items()})
    tp = port_params(jp)
    tadam = topt.AdamState(count=T(np.array(jadam.count)),
                           mu={k: T(np.array(v)) for k, v in jadam.mu.items()},
                           nu={k: T(np.array(v)) for k, v in jadam.nu.items()})
    return jp, jadam, tp, tadam


def _assert_params(tp, jp):
    for k in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        _close(getattr(tp, k), getattr(jp, k), msg=k)
    np.testing.assert_array_equal(np_(tp.alive), np_(jp.alive))


def _assert_adam(ta, ja):
    for k in GROUPS:
        _close(ta.mu[k], ja.mu[k], msg=k)
        _close(ta.nu[k], ja.nu[k], msg=k)


def test_stats_reset_opacity_and_grow_capacity_match_jax(rng):
    jp, jadam, tp, tadam = _states(rng)
    g2d = rng.normal(size=(32, 2)).astype(np.float32)
    radii = rng.integers(-1, 6, 32).astype(np.int32)
    jst = jg.add_densification_stats(jg.DensifyStats.zero(32), jnp.asarray(g2d),
                                     jnp.asarray(radii))
    jst = jg.add_densification_stats(jst, jnp.asarray(g2d[::-1].copy()),
                                     jnp.asarray(radii[::-1].copy()))
    tst = tg.add_densification_stats(tg.DensifyStats.zero(32), T(g2d), T(radii))
    tst = tg.add_densification_stats(tst, T(g2d[::-1].copy()),
                                     T(radii[::-1].copy()))
    _close(tst.grad_accum, jst.grad_accum)
    np.testing.assert_array_equal(np_(tst.denom), np_(jst.denom))
    np.testing.assert_array_equal(np_(tst.max_radii2d), np_(jst.max_radii2d))

    jp2, jadam2 = jg.reset_opacity(jp, jadam)
    tp2, tadam2 = tg.reset_opacity(tp, tadam)
    _assert_params(tp2, jp2)
    _assert_adam(tadam2, jadam2)

    jp3, jadam3, jst3 = jg.grow_capacity(jp2, jadam2, jst, 48)
    tp3, tadam3, tst3 = tg.grow_capacity(tp2, tadam2, tst, 48)
    _assert_params(tp3, jp3)
    _assert_adam(tadam3, jadam3)
    np.testing.assert_array_equal(np_(tst3.max_radii2d), np_(jst3.max_radii2d))
    _close(tst3.grad_accum, jst3.grad_accum)


@pytest.mark.parametrize("case", ["clone_split_prune", "overflow"])
def test_densify_and_prune_matches_jax(rng, case):
    P, capacity = (12, 48) if case == "clone_split_prune" else (28, 32)
    jp, jadam, tp, tadam = _states(rng, P, capacity)
    g2d = np.abs(rng.normal(size=(capacity, 2))).astype(np.float32) * 1e-3
    g2d[::3] = 0.0                                    # some stay cold
    radii = rng.integers(0, 30, capacity).astype(np.int32)
    jst = jg.add_densification_stats(jg.DensifyStats.zero(capacity),
                                     jnp.asarray(g2d), jnp.asarray(radii))
    tst = tg.add_densification_stats(tg.DensifyStats.zero(capacity), T(g2d),
                                     T(radii))
    key = jax.random.PRNGKey(3)
    noise = (np.array(jax.random.normal(key, (capacity, 3))),
             np.array(jax.random.normal(jax.random.fold_in(key, 1),
                                        (capacity, 3))))
    kw = dict(grad_threshold=2e-4, min_opacity=0.2, extent=3.0,
              max_screen_size=20, percent_dense=0.02)
    jout = jg.densify_and_prune(jp, jadam, jst, key, **kw)
    tout = tg.densify_and_prune(tp, tadam, tst, noise=tuple(map(T, noise)), **kw)
    _assert_params(tout[0], jout[0])
    _assert_adam(tout[1], jout[1])
    assert not np_(tout[2].grad_accum).any() and not np_(tout[2].denom).any()
    assert bool(tout[3]) == bool(jout[3]) == (case == "overflow")
    assert int(tout[0].num_alive) != P


def test_checkpoint_round_trip(rng, tmp_path):
    jp, _, tp, tadam = _states(rng)
    st = tg.add_densification_stats(
        tg.DensifyStats.zero(32), T(rng.normal(size=(32, 2)).astype(np.float32)),
        T(rng.integers(0, 5, 32).astype(np.int32)))
    state = TrainState(tp, tadam, st, torch.tensor(17, dtype=torch.int32))
    path = save_checkpoint(state, str(tmp_path / "state.pt"))
    back = load_checkpoint(path, device="cpu")
    a, b = state_to_dict(state), state_to_dict(back)

    def check(x, y, where):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for k in x:
                check(x[k], y[k], f"{where}.{k}")
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), where

    check(a, b, "state")
