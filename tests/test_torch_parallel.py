"""Port parity of ``luciddreamer_tpu_torch.parallel`` (torch.distributed)
against ``luciddreamer_tpu.parallel`` (shard_map) on the same numpy-seeded
inputs, on the CPU.

The port runs in gloo worlds of CPU processes, started once for the module:
a world of 4 holds the (1, 4) and (2, 2) meshes, a world of 2 the (1, 2)
and (2, 1) ones.  Each worker is a script that imports neither JAX nor the
JAX package; it runs every case and writes its results to an npz.  The JAX
side runs in the test process on conftest's 8-device virtual mesh with the
same (data, tiles) shape, while the workers run.

Tolerances: render atol 1e-5, depth 1e-4, radii and overflow equal
(tests/test_parallel.py); gradients atol 3e-4 of each group's max
(test_parallel.py:56-85); one training step: loss atol 1e-5, Adam's first
moments (0.1 x the reduced gradients) atol 5e-4 of each group's max, the
new parameters within 1e-6 where the gradient exceeds 1e-3 of its group's
max (elsewhere Adam's first step moves an entry by +-lr on the sign of a
near-zero gradient; tests/test_torch_train.py), densification counts
equal; the overlapped step against the batch step atol 2e-5 and loss rel
1e-5 (test_parallel.py:235-246); ShardedTrainer against Trainer xyz atol
2e-4 (test_parallel.py:88-132).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.config import GSConfig as JConfig
from luciddreamer_tpu.core.transforms import make_camera as jmake_camera
from luciddreamer_tpu.core.types import GaussianParams as JParams
from luciddreamer_tpu.model.gaussians import DensifyStats as JStats
from luciddreamer_tpu.model.optim import adam_init as jadam_init
from luciddreamer_tpu.parallel import make_mesh as jmake_mesh
from luciddreamer_tpu.parallel import render_sharded as jrender_sharded
from luciddreamer_tpu.parallel import sharded_train_step_batch as jstep_batch
from luciddreamer_tpu.parallel.overlap import (
    sharded_train_step_overlapped as jstep_overlapped,
)
from luciddreamer_tpu.train.loop import TrainState as JState
from luciddreamer_tpu_torch import convert
from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.model.gaussians import create_from_pcd
from luciddreamer_tpu_torch.model.optim import GROUPS
from luciddreamer_tpu_torch.parallel import ShardedTrainer, make_mesh
from luciddreamer_tpu_torch.parallel import multihost
from luciddreamer_tpu_torch.parallel.sharded import all_reduce, gather_replicated
from luciddreamer_tpu_torch.render.tiled import render_tiled
from luciddreamer_tpu_torch.train.loop import Trainer
from tests.helpers import make_random_gaussians
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    REPO, GlooWorld, assert_scaled_close, one_torch_thread,
)
from tests.port_helpers import port_camera as _port_cam
from tests.port_helpers import port_params as _port_params

pytestmark = [
    pytest.mark.usefixtures("one_torch_thread"),
    pytest.mark.skipif(len(jax.devices()) < 8,
                       reason="needs the 8-device virtual mesh"),
]

JAX_GROUPS = {"xyz": "xyz", "f_dc": "f_dc", "f_rest": "f_rest",
              "scaling": "scaling", "rotation": "rotation",
              "opacity": "opacity"}
TRAIN_CFG = dict(iterations=40, densification_interval=10,
                 densify_from_iter=10, position_lr_max_steps=40,
                 densify_grad_threshold=1e-5)

# The ranks' script.  argv: rank, world size, port, inputs npz, output dir.
WORKER = r"""
import os, sys
import numpy as np
import torch

rank, world, port, inputs, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)

from luciddreamer_tpu_torch import convert
from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.model.gaussians import DensifyStats, create_from_pcd
from luciddreamer_tpu_torch.model.optim import GROUPS, adam_init
from luciddreamer_tpu_torch.parallel import (
    ShardedTrainer, make_mesh, multihost, render_sharded, ring_all_reduce,
    sharded_train_step_batch, sharded_train_step_overlapped)
from luciddreamer_tpu_torch.parallel.dryrun import dryrun_multichip
from luciddreamer_tpu_torch.parallel.overlap import _finish, _ring_all_reduce_2d
from luciddreamer_tpu_torch.parallel.sharded import all_reduce_flat
from luciddreamer_tpu_torch.train.loop import TrainState

z = dict(np.load(inputs))
res = {{}}
res["init"] = multihost.initialize(f"127.0.0.1:{{port}}", world, rank,
                                   device="cpu")
res["main"] = multihost.is_main_process()
res["shard"] = multihost.local_shard(list(range(10)))
res["global_mesh"] = list(multihost.global_mesh(data=1, device="cpu")
                          .shape.values())


def params(p):
    return convert.gaussian_params(
        {{k: z[p + k] for k in convert.GAUSSIAN_FIELDS}}, device="cpu")


def cam(p):
    return convert.camera({{k: z[p + k] for k in convert.CAMERA_ARRAYS}},
                          int(z[p + "height"]), int(z[p + "width"]),
                          device="cpu")


def state(p):
    ps = params(p)
    return TrainState(ps, adam_init(ps.param_dict()),
                      DensifyStats.zero(ps.capacity),
                      torch.zeros((), dtype=torch.int32))


def put(tag, st, loss, ovf):
    pd = st.params.param_dict()
    for k in GROUPS:
        res[f"{{tag}}_{{k}}"] = pd[k].numpy()
        res[f"{{tag}}_mu_{{k}}"] = st.adam.mu[k].numpy()
    res[f"{{tag}}_grad_accum"] = st.stats.grad_accum.numpy()
    res[f"{{tag}}_denom"] = st.stats.denom.numpy()
    res[f"{{tag}}_max_radii2d"] = st.stats.max_radii2d.numpy()
    res[f"{{tag}}_step"] = int(st.step)
    res[f"{{tag}}_loss"] = float(loss)
    res[f"{{tag}}_ovf"] = bool(ovf)


def render_case(mesh, tag):
    out = render_sharded(params("r_"), cam("r_"), torch.as_tensor(z["r_bg"]),
                         mesh, chunk=64)
    for k in ("render", "depth", "radii", "overflow"):
        res[f"{{tag}}_{{k}}"] = out[k].detach().numpy()


if world == 4:
    m14 = make_mesh(1, 4, device="cpu")
    m22 = make_mesh(2, 2, device="cpu")
    render_case(m14, "r14")

    # gradients of a weighted sum of the sharded render, summed over ranks
    g = params("g_")
    out = render_sharded(g, cam("g_"), torch.zeros(3), m14, chunk=64)
    loss = torch.sum(out["render"] * torch.as_tensor(z["g_w"]))
    grads = all_reduce_flat(list(torch.autograd.grad(
        loss, [g.xyz, g.features_dc, g.features_rest, g.scaling, g.rotation,
               g.opacity])), m14.world_group)
    for k, v in zip(GROUPS, grads):
        res["grad_" + k] = v.numpy()

    # one batch step and one overlapped step at 2 x 2, without and with depth
    cams = [cam("s0_"), cam("s1_")]
    gt = torch.as_tensor(z["s_gt"])
    for depth in (0, 1):
        cfg = GSConfig(lambda_depth=0.3 if depth else 0.0)
        gtd = torch.as_tensor(z["s_gtd"]) if depth else None
        put(f"batch{{depth}}", *sharded_train_step_batch(
            state("s_"), cams, gt, torch.zeros(3), m22, cfg, 1.0,
            gt_depth_batch=gtd, chunk=32))
        put(f"ovl{{depth}}", *sharded_train_step_overlapped(
            state("s_"), cams, gt, torch.zeros(3), m22, cfg, 1.0, chunk=32,
            gt_depth_batch=gtd))
    # a per-band budget too small for the scene
    start = state("s_")
    tight, _, ovf = sharded_train_step_batch(
        start, cams, gt, torch.zeros(3), m22, GSConfig(), 1.0, chunk=32,
        pair_cap=64)
    put("tight", tight, 0.0, ovf)

    x = torch.as_tensor(z["ring_x"])
    res["ring_world"] = ring_all_reduce(x[rank], m14.world_group, 4).numpy()
    res["ring_2d"] = _finish(_ring_all_reduce_2d(x[rank], m22)).numpy()

    # ShardedTrainer over 1 x 4
    pcd = create_from_pcd(torch.as_tensor(z["t_pts"]),
                          torch.as_tensor(z["t_cols"]), capacity=128)
    views = [(cam(f"t{{i}}_"), torch.as_tensor(z["t_img"][i]))
             for i in range(3)]
    tr = ShardedTrainer(pcd, GSConfig(**{train_cfg!r}), 1.0, m14, seed=0,
                        pair_cap=4096, chunk=64, device="cpu")
    st = tr.run(views)
    res["trainer_xyz"] = st.params.xyz.detach().numpy()
    res["trainer_alive"] = st.params.alive.numpy()
    res["trainer_step"] = int(st.step)
    res["trainer_pair_cap"] = tr.pair_cap
else:
    m12 = make_mesh(1, 2, device="cpu")
    render_case(m12, "r12")
    res.update({{"dry_" + k: np.asarray(v) for k, v in
                dryrun_multichip(2, device="cpu").items() if k != "mesh"}})

np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"), **res)
"""


def _cam(W, H, dx=0.0):
    c2w = np.eye(4)
    c2w[0, 3] = dx
    return jmake_camera(c2w, 0.8279, 0.8279, W, H)


def _pack(z, prefix, jparams=None, jcam=None):
    if jparams is not None:
        for k in convert.GAUSSIAN_FIELDS:
            z[prefix + k] = np.asarray(getattr(jparams, k))
    if jcam is not None:
        for k in convert.CAMERA_ARRAYS:
            z[prefix + k] = np.asarray(getattr(jcam, k))
        z[prefix + "height"], z[prefix + "width"] = jcam.height, jcam.width


def _jstate(p):
    return JState(params=jax.tree.map(jnp.copy, p),
                  adam=jadam_init(p.param_pytree()),
                  stats=JStats.zero(p.capacity),
                  step=jnp.zeros((), jnp.int32))


class Case:
    """The module's inputs (the JAX objects and the gloo worlds that run the
    port on them)."""


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    c, z = Case(), {}
    c.render_params = make_random_gaussians(120, rng, scale_range=(-3.5, -1.0))
    c.render_cam = _cam(64, 128)
    c.bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    _pack(z, "r_", c.render_params, c.render_cam)
    z["r_bg"] = c.bg

    c.grad_params = make_random_gaussians(80, rng, scale_range=(-3.0, -1.0))
    c.w = rng.normal(size=(3, 128, 64)).astype(np.float32)
    _pack(z, "g_", c.grad_params, c.render_cam)
    z["g_w"] = c.w

    c.step_params = make_random_gaussians(60, rng, scale_range=(-3.0, -1.5))
    c.step_cams = [_cam(64, 64, dx) for dx in (-0.2, 0.2)]
    step_params = _port_params(c.step_params)
    with torch.no_grad():
        rendered = [render_tiled(step_params, _port_cam(cm), torch.zeros(3))
                    for cm in c.step_cams]
    c.gt = np.stack([r["render"].numpy() for r in rendered])
    # the targets' own depth, moved, so that the depth term has a gradient;
    # zeros in a corner reach the gt > 0 half of its mask
    c.gtd = np.stack([r["depth"].numpy() * 1.1 for r in rendered])
    c.gtd[:, :8, :8] = 0.0
    _pack(z, "s_", c.step_params)
    for i, cm in enumerate(c.step_cams):
        _pack(z, f"s{i}_", jcam=cm)
    z["s_gt"], z["s_gtd"] = c.gt, c.gtd
    c.ring_x = rng.normal(size=(4, 37)).astype(np.float32)    # 37: padded
    z["ring_x"] = c.ring_x

    pts = (rng.normal(size=(48, 3)) * 0.5 + [0, 0, 3.0]).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(48, 3)).astype(np.float32)
    target = _port_params(make_random_gaussians(60, rng,
                                                scale_range=(-3.0, -1.5)))
    c.train_views = []
    for i, dx in enumerate((-0.2, 0.0, 0.2)):
        cm = _port_cam(_cam(64, 128, dx))
        with torch.no_grad():
            img = render_tiled(target, cm, torch.zeros(3),
                               active_sh_degree=3)["render"]
        c.train_views.append((cm, img))
        _pack(z, f"t{i}_", jcam=_cam(64, 128, dx))
    z["t_pts"], z["t_cols"] = pts, cols
    z["t_img"] = np.stack([v[1].numpy() for v in c.train_views])
    c.pts, c.cols = pts, cols

    tmp = tmp_path_factory.mktemp("torch_parallel")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    src = WORKER.format(repo=REPO, train_cfg=TRAIN_CFG)
    c.world4 = GlooWorld(src, 4, tmp / "world4", (inputs, tmp / "world4"),
                         timeout=400)
    c.world2 = GlooWorld(src, 2, tmp / "world2", (inputs, tmp / "world2"),
                         timeout=400)
    yield c
    for w in (c.world4, c.world2):
        for p in w.procs:
            if p.poll() is None:
                p.kill()


def _same_on_every_rank(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key], err_msg=key)
    return results[0][key]


def test_multihost_initialize_and_helpers(case, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False      # one process
    assert multihost.is_main_process()
    assert multihost.local_shard([1, 2, 3]) == [1, 2, 3]
    assert multihost.local_shard(list(range(7)), 3, 1) == [1, 4]
    for world in (case.world4, case.world2):
        res = world.wait()
        n = len(res)
        for rank, r in enumerate(res):
            assert bool(r["init"]) and bool(r["main"]) == (rank == 0)
            assert list(r["shard"]) == list(range(10))[rank::n]
            assert list(r["global_mesh"]) == [1, n]


def test_mesh_of_one_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "tiles": 1} and mesh.rank == 0
    x = torch.arange(6.0).view(2, 3)
    assert all_reduce(x, mesh.world_group) is x
    assert gather_replicated(x, mesh.tiles_group, 1, 0, 0) is x
    with pytest.raises(ValueError):
        make_mesh(data=2, device="cpu")


@pytest.mark.parametrize("tiles", [4, 2])
def test_render_sharded_matches_jax(case, tiles):
    res = (case.world4 if tiles == 4 else case.world2).wait()
    tag = f"r1{tiles}"
    jmesh = jmake_mesh(jax.devices()[:tiles], data=1, tiles=tiles)
    with jmesh:
        ref = jax.jit(lambda p: jrender_sharded(
            p, case.render_cam, jnp.asarray(case.bg), jmesh, chunk=64))(
                case.render_params)
    assert not bool(ref["overflow"])
    render = _same_on_every_rank(res, tag + "_render")
    np.testing.assert_allclose(render, np.asarray(ref["render"]), atol=1e-5)
    np.testing.assert_allclose(_same_on_every_rank(res, tag + "_depth"),
                               np.asarray(ref["depth"]), atol=1e-4)
    np.testing.assert_array_equal(_same_on_every_rank(res, tag + "_radii"),
                                  np.asarray(ref["radii"]))
    assert not bool(_same_on_every_rank(res, tag + "_overflow"))


def test_sharded_grads_match_jax(case):
    res = case.world4.wait()
    jmesh = jmake_mesh(jax.devices()[:4], data=1, tiles=4)
    w = jnp.asarray(case.w)
    alive = case.grad_params.alive

    def loss(pdict):
        p = JParams.from_param_pytree(pdict, alive)
        return jnp.sum(jrender_sharded(p, case.render_cam, jnp.zeros(3), jmesh,
                                       chunk=64)["render"] * w)

    with jmesh:
        ref = jax.jit(jax.grad(loss))(case.grad_params.param_pytree())
    for k in GROUPS:
        assert_scaled_close(_same_on_every_rank(res, "grad_" + k), ref[k],
                            3e-4, err_msg=k)


def _jax_step(case, fn, cfg, depth, **kw):
    jmesh = jmake_mesh(jax.devices()[:4], data=2, tiles=2)
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *case.step_cams)
    gtd = jnp.asarray(case.gtd) if depth else None
    with jmesh:
        return jax.jit(lambda s: fn(
            s, cam_batch, jnp.asarray(case.gt), jnp.zeros(3), jmesh, cfg,
            extent=1.0, chunk=32, gt_depth_batch=gtd, **kw))(
                _jstate(case.step_params))


def _assert_step_matches(res, tag, jnew, jloss):
    """One step of the port (every rank) against the JAX step."""
    assert not bool(_same_on_every_rank(res, tag + "_ovf"))
    np.testing.assert_allclose(float(_same_on_every_rank(res, tag + "_loss")),
                               float(jloss), atol=1e-5)
    jp = jnew.params.param_pytree()
    for k in GROUPS:
        mu = _same_on_every_rank(res, f"{tag}_mu_{k}")
        jmu = np.asarray(jnew.adam.mu[JAX_GROUPS[k]])
        assert_scaled_close(mu, jmu, 5e-4, err_msg=k)
        g = np.abs(jmu)
        big = g > 1e-3 * g.max() if g.max() > 0 else np.ones(g.shape, bool)
        np.testing.assert_allclose(_same_on_every_rank(res, f"{tag}_{k}")[big],
                                   np.asarray(jp[k])[big], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert_scaled_close(_same_on_every_rank(res, tag + "_grad_accum"),
                        jnew.stats.grad_accum, 5e-4)
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(_same_on_every_rank(res, f"{tag}_{k}"),
                                      np.asarray(getattr(jnew.stats, k)))
    assert int(_same_on_every_rank(res, tag + "_step")) == int(jnew.step) == 1


@pytest.mark.parametrize("depth", [0, 1])
def test_sharded_train_step_batch_matches_jax(case, depth):
    cfg = JConfig(lambda_depth=0.3 if depth else 0.0)
    jnew, jloss, jovf = _jax_step(case, jstep_batch, cfg, depth)
    assert not bool(jovf)
    _assert_step_matches(case.world4.wait(), f"batch{depth}", jnew, jloss)


def test_tight_pair_cap_overflows_and_changes_nothing(case):
    jnew, _, jovf = _jax_step(case, jstep_batch, JConfig(), 0, pair_cap=64)
    assert bool(jovf) and int(jnew.step) == 0
    res = case.world4.wait()
    assert bool(_same_on_every_rank(res, "tight_ovf"))
    assert int(_same_on_every_rank(res, "tight_step")) == 0
    start = case.step_params.param_pytree()
    for k in GROUPS:
        np.testing.assert_array_equal(_same_on_every_rank(res, "tight_" + k),
                                      np.asarray(start[k]), err_msg=k)
        assert not _same_on_every_rank(res, f"tight_mu_{k}").any()
    assert not _same_on_every_rank(res, "tight_denom").any()


def test_ring_all_reduce_is_bit_equal_on_every_rank(case):
    res = case.world4.wait()
    for key in ("ring_world", "ring_2d"):
        got = _same_on_every_rank(res, key)
        assert got.shape == (37,)
        np.testing.assert_allclose(got, case.ring_x.sum(0), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("depth", [0, 1])
def test_overlapped_step_matches_batch_step(case, depth):
    res = case.world4.wait()
    assert not bool(_same_on_every_rank(res, f"ovl{depth}_ovf"))
    assert float(_same_on_every_rank(res, f"ovl{depth}_loss")) == pytest.approx(
        float(res[0][f"batch{depth}_loss"]), rel=1e-5)
    for k in GROUPS:
        np.testing.assert_allclose(_same_on_every_rank(res, f"ovl{depth}_{k}"),
                                   res[0][f"batch{depth}_{k}"], atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        _same_on_every_rank(res, f"ovl{depth}_grad_accum"),
        res[0][f"batch{depth}_grad_accum"], atol=1e-6)
    assert int(_same_on_every_rank(res, f"ovl{depth}_step")) == 1


def test_overlapped_step_with_depth_matches_jax(case):
    jnew, jloss, jovf = _jax_step(case, jstep_overlapped,
                                  JConfig(lambda_depth=0.3), 1)
    assert not bool(jovf)
    _assert_step_matches(case.world4.wait(), "ovl1", jnew, jloss)


def test_sharded_trainer_tracks_trainer(case):
    """1 x 4 ShardedTrainer against the port's single-device Trainer on the
    same seed: the same camera draws and densify noise; only the order of
    the bands' sums differs."""
    pcd = create_from_pcd(torch.as_tensor(case.pts), torch.as_tensor(case.cols),
                          capacity=128)
    ref = Trainer(pcd, GSConfig(**TRAIN_CFG), 1.0, seed=0, pair_cap=4096,
                  chunk=64, device="cpu")
    st = ref.run(case.train_views)
    res = case.world4.wait()
    assert int(_same_on_every_rank(res, "trainer_step")) == int(st.step) == 40
    assert int(_same_on_every_rank(res, "trainer_pair_cap")) == ref.pair_cap == 4096
    np.testing.assert_array_equal(_same_on_every_rank(res, "trainer_alive"),
                                  st.params.alive.numpy())
    # every rank holds the same bits
    np.testing.assert_allclose(_same_on_every_rank(res, "trainer_xyz"),
                               st.params.xyz.detach().numpy(), atol=2e-4)


def test_sharded_trainer_refuses_another_device():
    with pytest.raises(ValueError):
        ShardedTrainer(create_from_pcd(torch.zeros((4, 3)) + 3.0,
                                       torch.full((4, 3), 0.5), capacity=8),
                       GSConfig(), 1.0, make_mesh(device="cpu"),
                       device=torch.device("meta"))


def test_dryrun_multichip_world_of_two(case):
    res = case.world2.wait()
    assert bool(_same_on_every_rank(res, "dry_tight_overflow"))
    for k in ("dry_loss", "dry_overlapped_loss"):
        assert np.isfinite(_same_on_every_rank(res, k))
