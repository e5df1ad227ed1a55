"""Port parity of the ZoeDepth stack: ``luciddreamer_tpu_torch.models``
against ``luciddreamer_tpu.models`` on numpy-seeded inputs (CPU).

Every leaf of each JAX parameter tree is flax's initial value (ones for
norm scales and layer scales, lecun-normal kernels, zeros elsewhere) plus
seeded numpy noise, so that biases, rel-pos tables, the cls token and the
heads' seeds are all exercised; the k third of each ViT qkv bias is zero
(the reference layout has no k bias).  The tree is carried across by
``luciddreamer_tpu_torch.convert.zoedepth_state_dict``.

Tolerances: rel_depth atol 2e-4 / rtol 1e-3 and metric_depth atol 5e-4 /
rtol 1e-3 (tests/test_zoe_convert.py's), the DPT hooks within 1e-5 of
each hook's max |ref|, the NK router's logits atol 1e-4, parameter round
trips and the rel-pos resize exact.  ``generate_pcd`` with
``depth_estimator="zoedepth_flax"`` is held at the tolerances of
tests/test_torch_dream.py::test_generate_pcd_matches_jax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luciddreamer_tpu.config import CameraConfig as JCam
from luciddreamer_tpu.dream import pipeline as jpipe
from luciddreamer_tpu.dream import protocols as jproto
from luciddreamer_tpu.models import convert as jconvert
from luciddreamer_tpu.models import model_io as jio
from luciddreamer_tpu.models.backbone import DPT as JDPT
from luciddreamer_tpu.models.backbone import ViTConfig as JViT
from luciddreamer_tpu.models.zoedepth import (
    FlaxZoeDepth,
    FlaxZoeDepthEstimator,
    ZoeDepthConfig as JZoeCfg,
)
from luciddreamer_tpu.models.zoedepth_nk import FlaxZoeDepthNK
from luciddreamer_tpu_torch import convert
from luciddreamer_tpu_torch.config import CameraConfig
from luciddreamer_tpu_torch.dream import pipeline as tpipe
from luciddreamer_tpu_torch.dream import protocols as tproto
from luciddreamer_tpu_torch.models import convert as tconvert
from luciddreamer_tpu_torch.models import model_io as tio
from luciddreamer_tpu_torch.models.backbone import DPT, ViTConfig
from luciddreamer_tpu_torch.models.zoedepth import (
    ZoeDepth,
    ZoeDepthConfig,
    ZoeDepthEstimator,
)
from luciddreamer_tpu_torch.models.zoedepth_nk import ZoeDepthNK
from tests.port_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    jax_tree, np_, one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# the project-readout ViT of tests/test_zoe_convert.py, and a deeper one
# with hooks past block 3 on a non-square grid
PROJECT_VIT = dict(patch_size=16, embed_dim=64, depth=4, num_heads=2,
                   hooks=(0, 1, 2, 3), readout="project")
DEEP_VIT = dict(patch_size=16, embed_dim=64, depth=6, num_heads=2,
                hooks=(1, 3, 4, 5), readout="project")


def configs(name):
    """(JAX config, port config) pairs by name."""
    if name == "tiny":
        return JZoeCfg.tiny(), ZoeDepthConfig.tiny()
    if name == "kitti_tiny":
        return JZoeCfg.kitti_tiny(), ZoeDepthConfig.kitti_tiny()
    vit, size = {"project": (PROJECT_VIT, (64, 64)),
                 "deep": (DEEP_VIT, (64, 96))}[name]
    return (dataclasses.replace(JZoeCfg.tiny(), vit=JViT(**vit), img_size=size),
            dataclasses.replace(ZoeDepthConfig.tiny(), vit=ViTConfig(**vit),
                                img_size=size))


def images(rng, n, h, w):
    return rng.uniform(size=(n, h, w, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_depths(out_t, out_j):
    np.testing.assert_allclose(np_(out_t["rel_depth"]), np_(out_j["rel_depth"]),
                               atol=2e-4, rtol=1e-3)
    d = np_(out_t["metric_depth"])
    assert np.isfinite(d).all()
    np.testing.assert_allclose(d, np_(out_j["metric_depth"]), atol=5e-4,
                               rtol=1e-3)


def port_model(cls, cfg, tree, kind="zoedepth"):
    m = cls(cfg).eval()
    m.load_state_dict(convert.zoedepth_state_dict(tree, kind))
    return m


# ------------------------------------------------------------ the modules

def test_dpt_hooks_match_jax(rng):
    """The DPT alone, deep project-readout ViT on a 4x6 token grid: the
    relative depth and all six hooks."""
    jcfg, tcfg = configs("deep")
    jm = JDPT(jcfg.vit, features=32, out_channels=(16, 32, 64, 64))
    x = images(rng, 2, 64, 96)
    tree = jax_tree(jm, x.shape, seed=1)
    rel_j, hooks_j = jax.jit(jm.apply)(tree, x)
    tm = DPT(tcfg.vit, (64, 96), features=32, out_channels=(16, 32, 64, 64))
    tm.load_state_dict(convert.dpt_state_dict(tree["params"]))
    with torch.no_grad():
        rel_t, hooks_t = tm.eval()(nchw(x))
    np.testing.assert_allclose(np_(rel_t), np_(rel_j), atol=2e-4, rtol=1e-3)
    for name, t, j in zip(("out_conv", "l4_rn", "r4", "r3", "r2", "r1"),
                          hooks_t, hooks_j):
        j = np_(j).transpose(0, 3, 1, 2)
        assert t.shape == j.shape, name
        scale = np.abs(j).max()
        np.testing.assert_allclose(np_(t) / scale, j / scale, atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("name", ["tiny", "deep"])
def test_zoed_n_matches_jax(rng, name):
    jcfg, tcfg = configs(name)
    h, w = tcfg.img_size
    x = images(rng, 2, h, w)
    jm = FlaxZoeDepth(jcfg)
    tree = jax_tree(jm, x.shape, seed=2)
    out_j = jax.jit(jm.apply)(tree, x)
    with torch.no_grad():
        out_t = port_model(ZoeDepth, tcfg, tree)(nchw(x))
    assert_depths(out_t, out_j)
    np.testing.assert_allclose(np_(out_t["bin_centers"]),
                               np_(out_j["bin_centers"]).transpose(0, 3, 1, 2),
                               atol=5e-4, rtol=1e-3)


def test_zoed_k_matches_jax(rng):
    """ZoeD_K's normed bin centres: seed normalisation, attractor point
    pairs, sort and clip."""
    jcfg, tcfg = configs("kitti_tiny")
    x = images(rng, 2, 64, 64)
    jm = FlaxZoeDepth(jcfg)
    tree = jax_tree(jm, x.shape, seed=3)
    out_j = jax.jit(jm.apply)(tree, x)
    with torch.no_grad():
        out_t = port_model(ZoeDepth, tcfg, tree)(nchw(x))
    assert_depths(out_t, out_j)
    d = np_(out_t["metric_depth"])
    # a convex combination of centres clipped to (min_depth, max_depth),
    # up to float32 rounding of the sum
    assert d.min() >= tcfg.min_depth and d.max() <= tcfg.max_depth * (1 + 1e-6)


def test_zoed_nk_matches_jax(rng):
    """Both heads, the router's logits and the per-image routing."""
    jcfg, tcfg = configs("tiny")
    x = images(rng, 3, 64, 64)
    jm = FlaxZoeDepthNK(jcfg)
    tree = jax_tree(jm, x.shape, seed=4)
    out_j = jax.jit(jm.apply)(tree, x)
    with torch.no_grad():
        out_t = port_model(ZoeDepthNK, tcfg, tree, "zoedepth_nk")(nchw(x))
    assert_depths(out_t, out_j)
    np.testing.assert_allclose(np_(out_t["domain_logits"]),
                               np_(out_j["domain_logits"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np_(out_t["per_domain_depth"]),
                               np_(out_j["per_domain_depth"]), atol=5e-4,
                               rtol=1e-3)


def test_estimator_matches_jax(rng):
    """Reflect pad, antialiased resize, flip average, bicubic back, crop:
    ``ZoeDepthEstimator`` against ``FlaxZoeDepthEstimator.infer`` at
    48x56 (the tiny config, ignore readout)."""
    jcfg, tcfg = configs("tiny")
    tree = jax_tree(FlaxZoeDepth(jcfg), (1, 64, 64, 3), seed=5)
    x = images(rng, 2, 48, 56)
    d_j = FlaxZoeDepthEstimator(jcfg, params=tree).infer(jnp.asarray(x))
    est = ZoeDepthEstimator(tcfg, convert.zoedepth_state_dict(tree),
                            device="cpu")
    d_t = est.infer(torch.from_numpy(x))
    assert d_t.shape == (2, 48, 56)
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np_(est(torch.from_numpy(x[1]))), np_(d_j)[1],
                               atol=5e-4, rtol=1e-3)


# ----------------------------------------------------- weights and files

@pytest.mark.parametrize("name, kind", [("project", "zoedepth"),
                                        ("kitti_tiny", "zoedepth"),
                                        ("tiny", "zoedepth_nk")])
def test_params_round_trip_through_jax(name, kind):
    """JAX -> port -> JAX: the port's state dict through the JAX package's
    own converter gives the tree back exactly."""
    jcfg, tcfg = configs(name)
    nk = kind == "zoedepth_nk"
    jm = (FlaxZoeDepthNK if nk else FlaxZoeDepth)(jcfg)
    tree = jax_tree(jm, (1, *tcfg.img_size, 3), seed=6)
    m = port_model(ZoeDepthNK if nk else ZoeDepth, tcfg, tree, kind)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    back = (jconvert.convert_zoedepth_nk_state_dict if nk
            else jconvert.convert_zoedepth_state_dict)(sd, jcfg)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(tree), flat(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_rel_pos_resize_and_prefixes_match_jax(rng):
    table = rng.normal(size=(9 * 9 + 3, 4)).astype(np.float32)
    for grid in ((4, 6), (5, 5), (3, 2)):
        np.testing.assert_array_equal(
            tconvert._resize_rel_pos_table(table, grid),
            jconvert._resize_rel_pos_table(table, grid))
    with pytest.raises(ValueError, match="cannot resize"):
        tconvert._resize_rel_pos_table(table[:-1], (4, 6))
    sd = {"model": {"module.a.weight": 1, "b": 2}}
    assert tconvert.strip_prefixes(sd) == jconvert.strip_prefixes(sd)


@pytest.mark.parametrize("twin_name, size", [("TwinZoe", 64), ("TwinZoe", 96),
                                             ("TwinZoeNK", 64)])
def test_reference_checkpoint_through_both_registries(rng, tmp_path,
                                                      twin_name, size):
    """A reference-named .pt (tests/test_zoe_convert.py's torch twin, its
    rel-pos index buffers included; at 96 px its tables are resized to the
    64 px grid) built by both packages' ``build_depth_model``."""
    from tests import test_zoe_convert as twins

    nk = twin_name == "TwinZoeNK"
    name = "zoedepth_nk_tiny" if nk else "zoedepth_tiny"
    twin = getattr(twins, twin_name)(
        dataclasses.replace(JZoeCfg.tiny(), img_size=(size, size)))
    twins._rand_init(twin, torch.Generator().manual_seed(7))
    path = str(tmp_path / "zoe.pt")
    torch.save({"model": twin.state_dict()}, path)
    x = images(rng, 1, 48, 56)[0]
    d_j = jio.build_depth_model(name, pretrained=path)(x)
    est = tio.build_depth_model(name, pretrained=path, device="cpu")
    assert isinstance(est.model, ZoeDepthNK if nk else ZoeDepth)
    d_t = est(torch.from_numpy(x))
    assert np.isfinite(np_(d_t)).all()
    np.testing.assert_allclose(np_(d_t), np_(d_j), atol=5e-4, rtol=1e-3)


def test_own_files_and_registry(tmp_path, monkeypatch):
    """The registry's names are the JAX package's; ``save_params`` and a
    non-.pt ``pretrained`` give the same model back; bad paths and names
    raise."""
    monkeypatch.delenv("LDT_ZOE_CKPT", raising=False)
    assert tio.available_depth_models() == jio.available_depth_models()
    est = tio.build_depth_model("zoedepth_k_tiny", device="cpu", seed=3)
    assert est.cfg.bin_centers_type == "normed"
    path = tio.save_params(est.model.state_dict(), str(tmp_path / "k.bin"))
    again = tio.build_depth_model("zoedepth_k_tiny", pretrained=path,
                                  device="cpu")
    for k, v in est.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    monkeypatch.setenv("LDT_ZOE_CKPT", path)
    assert torch.equal(tio.build_depth_model("zoedepth_k_tiny", device="cpu")
                       .model.conv2.weight, est.model.conv2.weight)
    with pytest.raises(FileNotFoundError):
        tio.build_depth_model("zoedepth_tiny", pretrained="/no/such.pt",
                              device="cpu")
    with pytest.raises(KeyError, match="unknown depth model"):
        tio.build_depth_model("no-such-model", device="cpu")


@pytest.mark.parametrize("name", ["zoedepth", "zoedepth_k", "zoedepth_nk"])
def test_full_size_models_need_weights(monkeypatch, name):
    monkeypatch.delenv("LDT_ZOE_CKPT", raising=False)
    with pytest.raises(RuntimeError, match="needs pretrained weights"):
        jio.build_depth_model(name)
    with pytest.raises(RuntimeError, match="needs pretrained weights"):
        tio.build_depth_model(name, device="cpu")


def test_random_init_is_seeded():
    a = ZoeDepthEstimator(seed=1, device="cpu").model.state_dict()
    b = ZoeDepthEstimator(seed=1, device="cpu").model.state_dict()
    c = ZoeDepthEstimator(seed=2, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv2.weight"], c["conv2.weight"])
    assert torch.equal(a["core.core.pretrained.model.blocks.0.gamma_1"],
                       torch.ones(64))


def test_estimator_refuses_input_on_another_device():
    """No silent move: the estimator takes images on its weights' device
    only."""
    est = ZoeDepthEstimator(device="cpu")
    with pytest.raises(ValueError, match="depth model is on cpu"):
        est.infer(torch.empty(1, 48, 56, 3, device="meta"))


@pytest.mark.parametrize("name", ["tiny", "deep"])
def test_chip_smoke_flops_count_every_matmul(name):
    """``chip_smoke.zoe_forward_flops`` (phase 10's FLOPs from the
    configuration) equals a count of every linear, convolution and
    attention product that one forward runs."""
    import chip_smoke
    from luciddreamer_tpu_torch.models.backbone import Attention

    cfg = configs(name)[1]
    model, total = ZoeDepth(cfg).eval(), []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Linear):
            total.append(2 * out.numel() * m.in_features)
        elif isinstance(m, torch.nn.Conv2d):
            total.append(2 * out.numel() * inp[0].shape[1] * m.weight[0, 0].numel())
        elif isinstance(m, torch.nn.ConvTranspose2d):
            total.append(2 * inp[0].numel() * m.weight[0].numel())
        elif isinstance(m, Attention):              # qkv and the two products
            B, N, C = inp[0].shape
            total.append(B * (2 * N * C * 3 * C + 4 * N * N * C))

    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.rand(1, 3, *cfg.img_size))
    assert sum(chip_smoke.zoe_forward_flops(cfg).values()) == sum(total)


# ------------------------------------------------------- the slice whole

def test_generate_pcd_with_zoedepth_flax_matches_jax(rng, monkeypatch):
    """A whole 64x64 rotate360 dream with ``depth_estimator="zoedepth_flax"``
    on both sides and a noise-free inpainter.  The JAX side's estimator is
    the one its registry builds (``FlaxZoeDepthEstimator()``: the tiny
    config, seed 0; initialised under jit, which gives the eager init's
    values in a third of the time), and its parameters are carried into
    the port's.

    Tolerances as in test_torch_dream.py::test_generate_pcd_matches_jax,
    but for the warped depths: within 1e-4 on all but 2% of the pixels
    (that test: 1%) and 1e-2 on those.  The mechanism is the same (fed the
    same inputs, the estimator agrees at rounding level, test above, and so
    does every other stage, test_dream_views_match_jax_on_the_same_inputs);
    carried from view to view, rounding flips near-tied border anchors,
    and with this estimator 1.66% of the depth pixels differ by more than
    1e-4 (max 7.1e-3) while the points keep that test's allowance
    (ROADMAP, Queue 3)."""
    jcfg = JZoeCfg.tiny()
    h, w = jcfg.img_size
    params = jax.jit(FlaxZoeDepth(jcfg).init)(jax.random.PRNGKey(0),
                                              jnp.zeros((1, h, w, 3)))
    jest = FlaxZoeDepthEstimator(params=params)
    sd = convert.zoedepth_state_dict(jax.tree.map(np.asarray, params))
    monkeypatch.setitem(jproto._DEPTH, "zoedepth_flax", lambda: jest)
    monkeypatch.setitem(
        tproto._DEPTH, "zoedepth_flax",
        lambda device=None: ZoeDepthEstimator(state_dict=sd, device=device))
    monkeypatch.setitem(jproto._INPAINTERS, "quiet",
                        lambda: jproto.ClassicInpainter(0.0))
    monkeypatch.setitem(tproto._INPAINTERS, "quiet",
                        lambda: tproto.ClassicInpainter(0.0))
    size = 64
    img = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
    kw = dict(prompt="a test scene", pcdgenpath="rotate360", seed=1,
              diff_steps=2)
    jtd = jpipe.generate_pcd(
        img, cam=JCam(image_width=size, image_height=size, focal=(70.0, 70.0)),
        config=jpipe.DreamConfig(inpainter="quiet", fill_iters=2,
                                 depth_estimator="zoedepth_flax"), **kw)
    ttd = tpipe.generate_pcd(
        img, cam=CameraConfig(image_width=size, image_height=size,
                              focal=(70.0, 70.0)),
        config=tpipe.DreamConfig(inpainter="quiet", fill_iters=2,
                                 depth_estimator="zoedepth_flax"),
        device="cpu", **kw)
    jn, tn = jtd["pcd_points"].shape[1], ttd["pcd_points"].shape[1]
    assert tn > size * size and abs(tn - jn) <= 1e-3 * jn, (tn, jn)
    if tn == jn:
        d = np.abs(ttd["pcd_points"] - jtd["pcd_points"])
        assert (d > 1e-3).mean() <= 5e-3 and d.max() <= 1e-2, (
            (d > 1e-3).mean(), d.max())
        np.testing.assert_allclose(ttd["pcd_colors"], jtd["pcd_colors"],
                                   atol=1e-3, rtol=0)
    assert len(ttd["frames"]) == len(jtd["frames"]) == 50
    for tf, jf in zip(ttd["frames"], jtd["frames"]):
        np.testing.assert_allclose(tf["transform_matrix"],
                                   jf["transform_matrix"], atol=1e-6)
        diff = np.abs(tf["image"].astype(int) - jf["image"].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    dd = np.stack([np.abs(tf["depth"] - np.asarray(jf["depth"]))
                   for tf, jf in zip(ttd["frames"], jtd["frames"])])
    assert (dd > 1e-4).mean() <= 0.02 and dd.max() <= 1e-2, (
        (dd > 1e-4).mean(), dd.max())
