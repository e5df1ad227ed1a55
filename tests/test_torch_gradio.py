"""Port parity: the Gradio UI (``luciddreamer_tpu_torch.app_gradio``)
against ``luciddreamer_tpu.app_gradio``, through the stand-in ``gradio``
module that ``chip_smoke.py`` phase 14 installs (gradio is not installed
here), and that phase's stand-ins for imageio and matplotlib against the
real modules."""
import functools
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import luciddreamer_tpu.app_gradio as jag
import luciddreamer_tpu_torch.app as app_mod
import luciddreamer_tpu_torch.app_gradio as tag
import luciddreamer_tpu_torch.scene.scene as scene_mod
from luciddreamer_tpu_torch import video as videolib
from luciddreamer_tpu_torch.config import CameraConfig, GSConfig
from tests.helpers import make_random_gaussians
from tests.port_helpers import (  # noqa: F401
    EXAMPLE, PROMPT, one_torch_thread, port_params, without_adapters)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
BACKENDS = ("classic", "radial", "SD1.5 (default)")


def _demo(monkeypatch, module, **kw):
    """build_demo under a fresh stand-in gradio; -> (gr, its record)."""
    gr, record = chip_smoke.gradio_stub()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    module.build_demo(**kw)
    return gr, record


def _describe(record):
    """The recorded UI as plain data: components as (class, args, keywords)
    with components named by their index, buttons as (label, bound
    function's name, input indices, output indices)."""
    comps = record["components"]

    def plain(x):
        for i, c in enumerate(comps):
            if x is c:
                return ("component", i)
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return x

    return ([(type(c).__name__, plain(list(c.args)), plain(c.kw)) for c in comps],
            [(b.args[0], b.bound[0].__name__, plain(b.bound[1]),
              plain(b.bound[2])) for b in record["buttons"]])


def _bound(record, label):
    return {b.args[0]: b.bound[0] for b in record["buttons"]}[label]


def test_build_demo_matches_jax(monkeypatch, tmp_path):
    _, port = _demo(monkeypatch, tag, save_dir=str(tmp_path), device="cpu")
    _, ref = _demo(monkeypatch, jag, save_dir=str(tmp_path))
    comps, buttons = _describe(port)
    assert (comps, buttons) == _describe(ref)
    assert [b[:2] for b in buttons] == [("Run all", "run_all"),
                                        ("Create scene", "create_only"),
                                        ("Render video", "render_only")]
    assert all(ins and outs for _, _, ins, outs in buttons)
    examples = [kw["examples"] for kind, _, kw in comps if kind == "Examples"]
    assert len(examples) == 1 and len(examples[0]) >= 20
    assert (tag.INPAINTER_CHOICES, tag.DEPTH_CHOICES, tag.SD_CHECKPOINTS) == (
        jag.INPAINTER_CHOICES, jag.DEPTH_CHOICES, jag.SD_CHECKPOINTS)


def test_find_examples_matches_jax(tmp_path):
    assert tag.find_examples() == jag.find_examples()
    (tmp_path / "a.jpg").write_bytes(b"")
    (tmp_path / "a.txt").write_text("a prompt\nsecond line\n")
    (tmp_path / "b.png").write_bytes(b"")
    (tmp_path / "b_negative.txt").write_text("blurry\n")
    assert tag.find_examples(str(tmp_path)) == jag.find_examples(str(tmp_path))
    assert [e[1:] for e in tag.find_examples(str(tmp_path))] == [
        ("a prompt", ""), ("", "blurry")]


def test_build_demo_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _demo(monkeypatch, tag, save_dir=str(tmp_path))


def test_render_only_without_a_scene_raises(monkeypatch, tmp_path):
    gr, record = _demo(monkeypatch, tag, save_dir=str(tmp_path), device="cpu")
    with pytest.raises(gr.Error, match="Create scene"):
        _bound(record, "Render video")("llff", *BACKENDS)


@pytest.mark.parametrize("inpainter, depth", [
    ("sd", "radial"), ("sd_controlnet", "radial"), ("lama", "radial"),
    ("classic", "zoedepth")])
def test_adapter_backends_when_run(monkeypatch, tmp_path, inpainter, depth):
    """Without diffusers, "Create scene" with sd or sd_controlnet raises
    ImportError before anything is written; lama and zoedepth under
    chip_smoke.py phase 15's stand-ins (a scripted LaMa, a transformers
    depth pipeline) bake a 32x32 scene and write its PLY."""
    from luciddreamer_tpu_torch.dream import protocols
    from luciddreamer_tpu_torch.utils import download

    without_adapters(monkeypatch, protocols)
    monkeypatch.setitem(sys.modules, "diffusers", None)
    lama = chip_smoke.scripted_lama(tmp_path / "big-lama.pt")
    monkeypatch.setattr(download, "fetch_checked",
                        lambda url, dest, md5=None: str(lama))
    monkeypatch.setitem(sys.modules, "transformers",
                        chip_smoke.transformers_stub((24, 40))[0])
    _tiny_app(monkeypatch)
    out = tmp_path / "out"
    _, record = _demo(monkeypatch, tag, save_dir=str(out), device="cpu")
    image = Image.open(EXAMPLE).convert("RGB")
    create = functools.partial(_bound(record, "Create scene"), image, "", "",
                               "rotate360", 1, 1, inpainter, depth,
                               "SD1.5 (default)")
    if inpainter.startswith("sd"):
        with pytest.raises(ImportError):
            create()
        assert not out.exists()
    else:
        assert create() == str(out / "gsplat.ply")
        assert os.path.getsize(out / "gsplat.ply") > 0


def _tiny_app(monkeypatch, size=32):
    """The app's defaults cut as tests/test_torch_app.py cuts the CLI: a
    32x32 camera, 4 bake steps, 12 frames of each render path."""
    focal = 5.8269e02 * size / 512.0
    monkeypatch.setattr(app_mod, "GSConfig", functools.partial(
        GSConfig, iterations=4, position_lr_max_steps=4))
    monkeypatch.setattr(app_mod, "CameraConfig", functools.partial(
        CameraConfig, image_width=size, image_height=size, focal=(focal, focal)))
    for mod in (scene_mod, app_mod):
        paths = mod.get_camera_paths
        monkeypatch.setattr(mod, "get_camera_paths", lambda paths=paths: {
            k: {**v, "frames": v["frames"][:12]} for k, v in paths().items()})


def test_run_all_on_the_cpu(monkeypatch, tmp_path):
    _tiny_app(monkeypatch)
    out = tmp_path / "out"
    gr, record = _demo(monkeypatch, tag, save_dir=str(out), device="cpu")
    with open(PROMPT) as f:
        prompt = f.readline().strip()
    image = Image.open(EXAMPLE).convert("RGB")
    rgb, depth = _bound(record, "Run all")(image, prompt, "", "rotate360",
                                           "back_and_forth", 3, 1, *BACKENDS)
    rgb2, depth2 = _bound(record, "Render video")("llff", *BACKENDS)
    files = [rgb, depth, rgb2, depth2, str(out / "gsplat.ply")]
    assert all(os.path.getsize(f) > 0 for f in files)
    assert [os.path.basename(f).split(".")[0] for f in files[:4]] == [
        "back_and_forth", "depth_back_and_forth", "llff", "depth_llff"]
    with pytest.raises(gr.Error):      # a changed dropdown drops the scene
        _bound(record, "Render video")("llff", "classic", "zoedepth_flax",
                                       "SD1.5 (default)")


def test_render_video_accepts_a_progress_callback(monkeypatch, tmp_path, rng):
    _tiny_app(monkeypatch)
    ld = app_mod.LucidDreamerTPU(save_dir=str(tmp_path), device="cpu")
    ld.params = port_params(make_random_gaussians(40, rng))
    calls = []
    rgb, depth = ld.render_video("back_and_forth",
                                 progress_callback=lambda *a: calls.append(a))
    assert os.path.getsize(rgb) > 0 and os.path.getsize(depth) > 0
    assert calls == []                 # accepted and not called, as in JAX


def test_video_stand_ins_match_the_real_modules(monkeypatch, tmp_path, rng):
    import matplotlib

    stand_in = chip_smoke.video_stand_ins()
    x = np.concatenate([[0.0, 1.0, 0.5, 1 / 256, 255 / 256],
                        rng.uniform(size=5000)])
    for dtype in (np.float32, np.float64):
        got = stand_in["matplotlib"].colormaps["jet"](x.astype(dtype), bytes=True)
        ref = matplotlib.colormaps["jet"](x.astype(dtype), bytes=True)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        stand_in["matplotlib"].colormaps["jet"](x),
        matplotlib.colormaps["jet"](x))
    depth = rng.uniform(0.5, 4.0, size=(16, 24)).astype(np.float32)
    depth[:3] = 0.0
    ref = videolib.colorize_depth(depth)
    monkeypatch.setitem(sys.modules, "matplotlib", stand_in["matplotlib"])
    np.testing.assert_array_equal(videolib.colorize_depth(depth), ref)

    frames = [rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8)
              for _ in range(5)]
    path = tmp_path / "v.mp4"
    stand_in["imageio"].mimwrite(str(path), frames, fps=60, quality=8)
    assert path.stat().st_size > 0
    with pytest.raises(ValueError, match="mp4 only"):
        stand_in["imageio"].mimwrite(str(tmp_path / "v.gif"), frames)
