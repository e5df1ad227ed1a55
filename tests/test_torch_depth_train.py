"""Port parity of the ZoeDepth training stack: ``luciddreamer_tpu_torch.
models`` (depth_losses, depth_eval, depth_data, depth_trainer) against
``luciddreamer_tpu.models`` on numpy-seeded inputs (CPU).

The trainers start from the same parameters: the JAX tree is flax's
initial values plus seeded noise (``port_helpers.jax_tree``; the JAX
trainer's own ``init`` is replaced by it, which also spares flax's slow
init) carried across with ``convert.zoedepth_state_dict``.

Tolerances: losses rtol 1e-5 (atol 1e-6); metrics, augmentation and the
loaders exactly equal (both are numpy); the one-cycle schedule rtol 1e-6
plus 2 float32 epsilons of the peak learning rate (optax evaluates it in
float32, where cos(pi pct) + 1 loses digits near the end of each leg; the
port in float64); trainer losses rtol 1e-5; parameters after 1 and 3 steps
compared as updates in units of the learning rate: within 0.05 lr on all
but 0.1% of entries (Adam moves an entry whose gradient is at rounding
level by +-lr on its sign, so such an entry may flip) and within 2.1 lr
everywhere; data parallel against one process as
tests/test_models.py:131-162 (loss rtol 1e-5, parameters atol 5e-5).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from luciddreamer_tpu.models import depth_data as jdata
from luciddreamer_tpu.models import depth_losses as JL
from luciddreamer_tpu.models import depth_trainer as jtrainer
from luciddreamer_tpu.models.depth_eval import compute_metrics as jmetrics
from luciddreamer_tpu.models.zoedepth import FlaxZoeDepth
from luciddreamer_tpu.models.zoedepth import ZoeDepthConfig as JZoeCfg
from luciddreamer_tpu_torch import convert
from luciddreamer_tpu_torch.models import depth_data as tdata
from luciddreamer_tpu_torch.models import depth_losses as TL
from luciddreamer_tpu_torch.models.depth_eval import compute_metrics
from luciddreamer_tpu_torch.models.depth_trainer import (
    DepthTrainConfig, DepthTrainer, onecycle_schedule,
)
from luciddreamer_tpu_torch.models.zoedepth import ZoeDepthConfig
from luciddreamer_tpu_torch.parallel import make_mesh
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    REPO, GlooWorld, jax_tree, np_, one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAIN = dict(lr=1e-4, epochs=1, steps_per_epoch=10)


# ------------------------------------------------------------------ losses

def _loss_inputs(rng):
    pred = (0.5 + 3 * rng.uniform(size=(2, 12, 16))).astype(np.float32)
    gt = (0.5 + 3 * rng.uniform(size=(2, 12, 16))).astype(np.float32)
    mask = rng.uniform(size=(2, 12, 16)) > 0.3
    probs = rng.uniform(0.01, 1.0, size=(2, 12, 16, 8)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    return pred, gt, mask, probs


LOSSES = {
    "silog": lambda L, p, g, m, q, e, c: L.silog_loss(p, g, m),
    "grad_l1": lambda L, p, g, m, q, e, c: L.grad_l1_loss(p, g, m),
    "ssi": lambda L, p, g, m, q, e, c: L.scale_and_shift_invariant_loss(p, g, m),
    "ordinal": lambda L, p, g, m, q, e, c: L.ordinal_regression_loss(q, g, m, e),
    "nll": lambda L, p, g, m, q, e, c: L.discrete_nll_loss(q, g, m, c),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_depth_loss_matches_jax(rng, name):
    pred, gt, mask, probs = _loss_inputs(rng)
    edges = np.linspace(0.0, 4.0, 9).astype(np.float32)
    centers = np.linspace(0.5, 3.5, 8).astype(np.float32)
    ref = LOSSES[name](JL, *map(jnp.asarray, (pred, gt, mask, probs, edges,
                                              centers)))
    t = [torch.as_tensor(x) for x in (pred, gt, mask, probs, edges, centers)]
    got = LOSSES[name](TL, *t)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ metrics and data

@pytest.mark.parametrize("crop", [None, "garg", "eigen"])
def test_compute_metrics_matches_jax(rng, crop):
    gt = 0.5 + 8 * rng.uniform(size=(24, 32))
    gt[rng.uniform(size=gt.shape) < 0.1] = 0.0
    pred = gt * rng.uniform(0.7, 1.4, size=gt.shape)
    pred[0, :3] = [np.nan, np.inf, -1.0]
    assert compute_metrics(gt, pred, crop=crop) == jmetrics(gt, pred, crop=crop)
    nothing = compute_metrics(np.zeros((4, 4)), np.ones((4, 4)))
    assert all(np.isnan(v) for v in nothing.values())


def test_augment_batched_and_round_robin_match_jax(rng):
    img = rng.uniform(size=(30, 40, 3)).astype(np.float32)
    dep = (1 + 4 * rng.uniform(size=(30, 40))).astype(np.float32)
    for cfg in (tdata.AugmentConfig(crop_h=24, crop_w=32),
                tdata.AugmentConfig(crop_h=24, crop_w=32, rotate_deg=0.0)):
        jcfg = jdata.AugmentConfig(**vars(cfg))
        got = tdata.augment_sample(img, dep, np.random.default_rng(3), cfg)
        ref = jdata.augment_sample(img, dep, np.random.default_rng(3), jcfg)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    items = [(img, dep)] * 5
    cfg = tdata.AugmentConfig(crop_h=24, crop_w=32)
    got = list(tdata.batched(items, 2, np.random.default_rng(4), cfg,
                             repeat=False))
    ref = list(jdata.batched(items, 2, np.random.default_rng(4),
                             jdata.AugmentConfig(**vars(cfg)), repeat=False))
    assert len(got) == len(ref) == 2
    for (a, b), (c, d) in zip(got, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    rr = tdata.round_robin(iter([1, 2, 3]), iter(["a", "b", "c"]))
    assert [next(rr) for _ in range(4)] == [1, "a", 2, "b"]


def _rgb(rng, path, h=16, w=20):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)).save(path)


def _u16(rng, path, h=16, w=20, hi=9000):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, hi, size=(h, w)).astype(np.uint16)).save(path)


def _layout(name, rng, root):
    """A tiny folder of dataset ``name``'s layout with two samples."""
    j = os.path.join
    for i in range(2):
        s = f"{i:05d}"
        if name == "nyu":
            _rgb(rng, j(root, "scene", f"rgb_{s}.jpg"))
            _u16(rng, j(root, "scene", f"sync_depth_{s}.png"))
        elif name == "kitti":
            _rgb(rng, j(root, "drive", "image_02", "data", f"{s}.png"))
            _u16(rng, j(root, "drive", "proj_depth", "groundtruth", "image_02",
                        f"{s}.png"))
        elif name == "diode":
            d = j(root, "scene_0", "scan_0")
            _rgb(rng, j(d, f"{s}.png"))
            np.save(j(d, f"{s}_depth.npy"),
                    rng.uniform(1, 5, size=(16, 20, 1)).astype(np.float32))
            np.save(j(d, f"{s}_depth_mask.npy"), rng.uniform(size=(16, 20)) > 0.2)
        elif name == "ddad":
            _rgb(rng, j(root, f"{s}_rgb.png"))
            np.save(j(root, f"{s}_depth.npy"),
                    rng.uniform(1, 50, size=(16, 20)).astype(np.float32))
        elif name == "sunrgbd":
            _rgb(rng, j(root, "rgb", "rgb", f"{s}.jpg"))
            _u16(rng, j(root, "gt", "gt", f"{s}.png"), hi=12000)
        elif name == "diml_indoor":
            _rgb(rng, j(root, "LR", "s", "color", f"{s}_c.png"))
            _u16(rng, j(root, "LR", "s", "depth_filled", f"{s}_depth_filled.png"))
        elif name == "diml_outdoor":
            _rgb(rng, j(root, "s", "outleft", f"{s}.png"))
            _u16(rng, j(root, "s", "depthmap", f"{s}.png"))
        elif name == "ibims":
            _rgb(rng, j(root, "rgb", f"im{i}.png"))
            _u16(rng, j(root, "depth", f"im{i}.png"), hi=65535)
            _u16(rng, j(root, "mask_invalid", f"im{i}.png"), hi=2)
            _u16(rng, j(root, "mask_transp", f"im{i}.png"), hi=2)
            with open(j(root, "imagelist.txt"), "a") as f:
                f.write(f"im{i}\n")
        elif name == "vkitti2":
            tail = ("Scene01", "clone", "frames")
            _rgb(rng, j(root, "rgb", *tail, "rgb", "Camera_0", f"rgb_{s}.jpg"))
            _u16(rng, j(root, "depth", *tail, "depth", "Camera_0",
                        f"depth_{s}.png"), hi=30000)
        elif name == "hypersim":
            import h5py

            base = j(root, "ai_001", "images")
            _rgb(rng, j(base, "scene_cam_00_final_preview",
                        f"frame.{s}.tonemap.jpg"))
            hd = j(base, "scene_cam_00_geometry_hdf5")
            os.makedirs(hd, exist_ok=True)
            with h5py.File(j(hd, f"frame.{s}.depth_meters.hdf5"), "w") as f:
                f["dataset"] = rng.uniform(1, 9, size=(16, 20)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(tdata.DATASETS))
def test_depth_dataset_loader_matches_jax(rng, tmp_path, name):
    if name == "hypersim":
        pytest.importorskip("h5py")
    _layout(name, rng, str(tmp_path))
    got = list(tdata.get_depth_dataset(name, str(tmp_path)))
    ref = list(jdata.get_depth_dataset(name, str(tmp_path)))
    # KITTI's walk also takes the depth folder's files as images (both
    # packages do): 4 pairs from 2 samples
    assert len(got) == len(ref) == (4 if name == "kitti" else 2)
    for (a, b), (c, d) in zip(got, ref):
        assert a.shape == (16, 20, 3) and b.shape == (16, 20)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert len(list(tdata.get_depth_dataset(name, str(tmp_path), 1))) == 1


def test_dataset_registry_and_hypersim_depth():
    assert sorted(tdata.DATASETS) == sorted(jdata.DATASETS)
    with pytest.raises(KeyError):
        tdata.get_depth_dataset("nope", ".")
    dist = np.random.default_rng(1).uniform(1, 9, (8, 10)).astype(np.float32)
    np.testing.assert_array_equal(tdata.hypersim_distance_to_depth(dist),
                                  jdata.hypersim_distance_to_depth(dist))


# -------------------------------------------------------------- training

@pytest.mark.parametrize("kw", [dict(epochs=1, steps_per_epoch=50,
                                     pct_start=0.3),
                                dict(epochs=2, steps_per_epoch=20,
                                     div_factor=25.0)])
def test_onecycle_schedule_matches_optax(kw):
    ref = jtrainer.onecycle_schedule(jtrainer.DepthTrainConfig(**kw))
    cfg = DepthTrainConfig(**kw)
    got = onecycle_schedule(cfg)
    total = cfg.epochs * cfg.steps_per_epoch
    eps32 = float(np.finfo(np.float32).eps)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=2 * eps32 * cfg.lr, err_msg=str(step))


def _jax_trainer(monkeypatch, tree):
    """The JAX DepthTrainer on the tiny configuration, its parameters
    ``tree`` (its own constructor, with flax's init replaced)."""
    monkeypatch.setattr(FlaxZoeDepth, "init", lambda self, key, x: tree)
    return jtrainer.DepthTrainer(JZoeCfg.tiny(),
                                 jtrainer.DepthTrainConfig(**TRAIN), seed=0)


def _port_trainer(tree, **kw):
    tr = DepthTrainer(ZoeDepthConfig.tiny(), DepthTrainConfig(**TRAIN),
                      seed=0, device="cpu", **kw)
    tr.model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                              convert.zoedepth_state_dict(tree).items()})
    return tr


def _batch(rng, n=2):
    img = rng.uniform(size=(n, 64, 64, 3)).astype(np.float32)
    depth = (1.0 + rng.uniform(size=(n, 64, 64))).astype(np.float32)
    depth[:, :4, :4] = 0.0          # outside the default mask
    return img, depth


@pytest.fixture(scope="module")
def trained():
    """Both trainers from the same parameters, after 1 and after 3 steps on
    the same batches: {steps: (port state dict, JAX state dict, losses)}."""
    mp = pytest.MonkeyPatch()
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tree = jax_tree(FlaxZoeDepth(JZoeCfg.tiny()), (1, 64, 64, 3), seed=7)
        jt = _jax_trainer(mp, tree)
        pt = _port_trainer(tree)
        rng = np.random.default_rng(8)
        out, losses = {}, []
        for step in range(1, 4):
            img, depth = _batch(rng)
            losses.append((pt.train_batch(img, depth),
                           jt.train_batch(img, depth)))
            if step in (1, 3):
                jsd = convert.zoedepth_state_dict(jax.tree.map(np.asarray,
                                                               jt.params))
                out[step] = ({k: v.clone() for k, v in
                              pt.model.state_dict().items()},
                             jsd, list(losses), jt.step, pt.step)
        out["start"] = convert.zoedepth_state_dict(tree)
        out["lrs"] = [pt.schedule(i) for i in range(3)]
        return out
    finally:
        mp.undo()
        torch.set_num_threads(torch_threads)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_batch_matches_jax(trained, steps):
    psd, jsd, losses, jsteps, psteps = trained[steps]
    assert psteps == jsteps == steps
    for lp, lj in losses:
        assert np.isfinite(lp)
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
    lr = max(trained["lrs"])
    start = trained["start"]
    drift, flips, total = 0.0, 0, 0
    for k, ref in jsd.items():
        d_port = (psd[k].numpy() - np.asarray(start[k])) / lr
        d_jax = (np.asarray(ref) - np.asarray(start[k])) / lr
        diff = np.abs(d_port - d_jax)
        assert diff.max() <= 2.1 * steps, k
        flips += int((diff > 0.05).sum())
        total += diff.size
        drift = max(drift, float(diff.max()))
    assert flips <= 1e-3 * total, (flips, total, drift)


def test_nan_depth_commits_nothing(rng):
    tr = DepthTrainer(ZoeDepthConfig.tiny(), DepthTrainConfig(**TRAIN),
                      seed=1, device="cpu")
    img, depth = _batch(rng)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    bad = depth.copy()
    bad[0, 10, 10] = np.nan
    assert not np.isfinite(tr.train_batch(img, bad))
    assert tr.step == 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(m.any() for m in tr.mu) and not any(v.any() for v in tr.nu)
    assert np.isfinite(tr.train_batch(img, depth)) and tr.step == 1
    assert not torch.equal(tr.model.state_dict()["conv2.weight"],
                           before["conv2.weight"])


def test_validate_keeps_the_best_weights_on_the_cpu(rng):
    tr = DepthTrainer(ZoeDepthConfig.tiny(),
                      DepthTrainConfig(**TRAIN, validate_every=2),
                      seed=2, device="cpu")
    img, depth = _batch(rng)
    logs = []
    tr.fit([(img, depth)] * 2, val_data=[(img, depth)], log_fn=logs.append)
    assert tr.step == 2 and len(logs) == 1 and "abs_rel" in logs[0]
    m = tr.validate([(img, torch.as_tensor(depth))])
    assert set(m) == {"a1", "a2", "a3", "abs_rel", "sq_rel", "rmse",
                      "rmse_log", "log_10", "silog"}
    assert np.isfinite(m["abs_rel"]) and tr.best_metric <= m["abs_rel"]
    assert all(v.device.type == "cpu" for v in tr.best_params.values())
    with pytest.raises(ValueError):
        DepthTrainer(mesh=make_mesh(device="cpu"), device=torch.device("meta"))


DP_WORKER = r"""
import os, sys
import numpy as np
import torch

rank, world, port, inputs, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from luciddreamer_tpu_torch.models.depth_trainer import (
    DepthTrainConfig, DepthTrainer)
from luciddreamer_tpu_torch.models.zoedepth import ZoeDepthConfig
from luciddreamer_tpu_torch.parallel import make_mesh, multihost

multihost.initialize(f"127.0.0.1:{{port}}", world, rank, device="cpu")
z = np.load(inputs)
tr = DepthTrainer(ZoeDepthConfig.tiny(), DepthTrainConfig(**{train!r}),
                  seed=0, mesh=make_mesh(data=world, device="cpu"),
                  device="cpu")
res = {{"loss": [tr.train_batch(z["img"], z["depth"]) for _ in range(3)]}}
res.update({{k: v.numpy() for k, v in tr.model.state_dict().items()}})
np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"), **res)
"""


def test_data_parallel_matches_one_process(rng, tmp_path):
    """A gloo world of 2 splits a batch of 4 over its data ranks; the loss
    and the update are the whole batch's, as in one process."""
    img, depth = _batch(rng, n=4)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, img=img, depth=depth)
    world = GlooWorld(DP_WORKER.format(repo=REPO, train=TRAIN), 2,
                      tmp_path / "world", (inputs, tmp_path / "world"),
                      timeout=300)
    try:
        ref = DepthTrainer(ZoeDepthConfig.tiny(), DepthTrainConfig(**TRAIN),
                           seed=0, device="cpu")
        losses = [ref.train_batch(img, depth) for _ in range(3)]
        res = world.wait()
    finally:
        for p in world.procs:
            if p.poll() is None:
                p.kill()
    for r in res:
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-5)
    for k, v in ref.model.state_dict().items():
        np.testing.assert_array_equal(res[1][k], res[0][k], err_msg=k)
        np.testing.assert_allclose(res[0][k], np_(v), atol=5e-5, err_msg=k)
