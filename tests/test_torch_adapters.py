"""Port parity of the model adapters: ``sd``, ``lama``, ``sd_controlnet``
and ``zoedepth`` of ``luciddreamer_tpu_torch.dream.protocols`` against the
JAX package's on the same numpy-seeded inputs (CPU), under the stand-ins of
``chip_smoke.py`` phase 15, since neither the packages' weights nor
``diffusers`` are here: a ``diffusers`` whose pipelines record their
kwargs (``diffusers_stub``), one scripted TorchScript LaMa that both
packages load through the real ``torch.jit.load`` with ``fetch_checked``
replaced (``scripted_lama``), and a ``transformers`` whose depth pipeline
returns a map of another size than the image (``transformers_stub``).
Each stand-in is installed with ``monkeypatch``, and the four adapters
leave both packages' registries for each test.

Tolerances: the pipes' kwargs equal (prompt, steps, sizes, the 8-bit
images, the seed); outputs within 1e-6 (the same float32 values through
numpy and through torch); ``zoedepth``'s bilinear resize on the device
against the JAX adapter's ``cv2.resize`` within 1e-6 of the depth's max
(the same half-pixel-centre weights summed in another order: <= 2e-7 of
the max at these and the card's sizes).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import luciddreamer_tpu.utils.download as jdownload
import luciddreamer_tpu_torch.utils.download as tdownload
from luciddreamer_tpu.dream import protocols as jproto
from luciddreamer_tpu_torch.dream import protocols as tproto
from tests.port_helpers import (  # noqa: F401
    REPO, np_, one_torch_thread, without_adapters)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "registries")
ADAPTERS = chip_smoke.ADAPTERS
PACKAGE = {"sd": "diffusers", "sd_controlnet": "diffusers",
           "zoedepth": "transformers"}


@pytest.fixture
def registries(monkeypatch):
    without_adapters(monkeypatch, jproto, tproto)


@pytest.fixture
def diffusers(monkeypatch):
    mod, record = chip_smoke.diffusers_stub()
    monkeypatch.setitem(sys.modules, "diffusers", mod)
    return record


@pytest.fixture
def lama(monkeypatch, tmp_path):
    """The scripted stand-in at the cache path both adapters ask for
    (``HOME`` points into tmp_path), and a ``fetch_checked`` in both
    packages that checks the request and returns the path unfetched."""
    monkeypatch.setenv("HOME", str(tmp_path))
    path = tmp_path / ".cache" / "luciddreamer_tpu" / "big-lama.pt"
    path.parent.mkdir(parents=True)
    chip_smoke.scripted_lama(path)
    fetched = []

    def fetch(url, dest, md5=None):
        fetched.append((url, dest, md5))
        assert dest == str(path) and path.exists()
        return dest

    for dl in (jdownload, tdownload):
        monkeypatch.setattr(dl, "fetch_checked", fetch)
    return fetched


def _depth(monkeypatch, hw):
    mod, record = chip_smoke.transformers_stub(hw)
    monkeypatch.setitem(sys.modules, "transformers", mod)
    return record


def _t(x):
    return torch.as_tensor(np.array(x))


def _plain(kw):
    """A pipe call's kwargs as comparable data: images as arrays, the
    generator as (device type, seed), tensors as arrays."""
    out = {}
    for k, v in kw.items():
        if k == "generator":
            v = (v.device.type, v.initial_seed())
        elif isinstance(v, torch.Tensor):
            v = ("tensor", v.device.type, tuple(v.shape), v.numpy().tobytes())
        elif hasattr(v, "size") and hasattr(v, "mode"):     # a PIL image
            v = ("image", v.mode, v.size, np.asarray(v).tobytes())
        out[k] = v
    return out


def _image(rng, h, w):
    return rng.uniform(size=(h, w, 3)).astype(np.float32)


def test_sd_matches_jax(diffusers, rng):
    img = _image(rng, 32, 40)
    mask = np.zeros((32, 40), np.float32)
    mask[8:16, 8:16] = 1.0
    kw = dict(prompt="a cat", negative_prompt="bad", steps=7)
    j = np.asarray(jproto.get_inpainter("sd")(img, mask, **kw))
    inp = tproto.get_inpainter("sd", device="cpu")
    t = inp(_t(img), _t(mask), **kw)
    jk, tk = diffusers["sd"]
    assert _plain(tk) == _plain(jk)
    assert tk["generator"].initial_seed() == 0 and tk["num_inference_steps"] == 7
    m = np.asarray(tk["mask_image"])
    assert m[12, 12] == 255 and m[0, 0] == 0
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert t.shape == (32, 40, 3)
    np.testing.assert_allclose(np_(t), j, atol=1e-6, rtol=0)
    # the seed is drawn from the dream's generator, and the pipe's
    # generator lives on the pipe's device
    inp(_t(img), _t(mask), rng=torch.Generator().manual_seed(5), **kw)
    want = int(torch.randint(0, 2**31 - 1, (),
                             generator=torch.Generator().manual_seed(5)))
    assert diffusers["sd"][-1]["generator"].initial_seed() == want
    assert inp.pipe.device.type == "cpu"


def test_sd_checkpoint_swap_and_refusal(diffusers):
    """--model_name reaches from_pretrained; a backend without a ``model``
    parameter refuses a checkpoint, with the JAX package's message."""
    j = jproto.get_inpainter("sd", model="someone/custom-inpaint")
    t = tproto.get_inpainter("sd", model="someone/custom-inpaint", device="cpu")
    assert t.pipe.model == j.pipe.model == "someone/custom-inpaint"
    errors = []
    for mod in (jproto, tproto):
        mod.register_inpainter("nockpt", lambda: mod.ClassicInpainter())
        with pytest.raises(ValueError, match="does not accept a checkpoint") as e:
            mod.get_inpainter("nockpt", model="x")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_lama_matches_jax(lama, rng):
    img = rng.uniform(0.4, 0.6, size=(30, 41, 3)).astype(np.float32)
    mask = np.zeros((30, 41), np.float32)
    mask[5:10, 5:10] = 1.0
    mask[28:, 38:] = 0.7                 # above 0.5: a hole at the padded edge
    shapes = {}
    outs = []
    for tag, inp, x, m in (
            ("jax", jproto.get_inpainter("lama"), img, mask),
            ("port", tproto.get_inpainter("lama", device="cpu"), _t(img),
             _t(mask))):
        model = inp.model
        inp.model = lambda ti, tm, tag=tag, model=model: (
            shapes.setdefault(tag, (tuple(ti.shape), tuple(tm.shape)))
            and model(ti, tm))
        outs.append(np_(inp(x, m)))
    assert shapes["jax"] == shapes["port"] == ((1, 3, 32, 48), (1, 1, 32, 48))
    assert [f[0] for f in lama] == [jproto.LAMA_URL] * 2 == [tproto.LAMA_URL] * 2
    assert [f[2] for f in lama] == [jproto.LAMA_MD5] * 2 == [tproto.LAMA_MD5] * 2
    j, t = outs
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t[mask <= 0.5], img[mask <= 0.5])
    assert np.abs(t[7, 7] - img[7, 7]).max() > 1e-3     # filled by the model


def test_controlnet_matches_jax(diffusers, lama, rng):
    """The holes (the mask, and an all-black pixel) padded by 3 px, LaMa's
    fill as the init image and the condition at -1: the same pipe inputs
    from both packages, LaMa chained through each package's own adapter."""
    img = rng.uniform(0.3, 0.9, size=(24, 24, 3)).astype(np.float32)
    mask = np.zeros((24, 24), np.float32)
    mask[10:14, 10:14] = 1.0
    img[2, 2] = 0.0
    j = np.asarray(jproto.get_inpainter("sd_controlnet")(
        img, mask, prompt="p", steps=4))
    t = tproto.get_inpainter("sd_controlnet", device="cpu")(
        _t(img), _t(mask), prompt="p", steps=4)
    jk, tk = diffusers["sd_controlnet"]
    cond_j, cond_t = jk.pop("control_image"), tk.pop("control_image")
    assert _plain(tk) == _plain(jk)
    assert tk["strength"] == 0.9 and (tk["height"], tk["width"]) == (24, 24)
    np.testing.assert_allclose(np_(cond_t), np_(cond_j), atol=1e-6, rtol=0)
    assert cond_t.shape == (1, 3, 24, 24) and cond_t.device.type == "cpu"
    m = np.asarray(tk["mask_image"]) / 255.0
    assert m[12, 12] == 1.0 and m[7, 12] == 1.0 and m[3, 12] == 0.0
    assert m[5, 5] == 1.0 and m[6, 6] == 0.0         # the black pixel, padded
    c = np_(cond_t)[0]
    assert (c[:, 12, 12] == -1.0).all() and (c[:, 2, 2] == -1.0).all()
    init = np.asarray(tk["image"]) / 255.0
    np.testing.assert_allclose(init[20, 20], img[20, 20], atol=0.5 / 255)
    np.testing.assert_allclose(np_(t), j, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(48, 52), (20, 24)],
                         ids=["larger", "smaller"])
def test_zoedepth_matches_jax(monkeypatch, rng, hw):
    record = _depth(monkeypatch, hw)
    img = _image(rng, 32, 40)
    j = np.asarray(jproto.get_depth_estimator("zoedepth")(img))
    t = tproto.get_depth_estimator("zoedepth", device="cpu")(_t(img))
    assert [(m, d.type) for m, d in record["pipelines"]] == [
        ("Intel/zoedepth-nyu", "cpu")] * 2
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert t.shape == j.shape == (32, 40)
    assert np.abs(np_(t) - j).max() <= 1e-6 * np.abs(j).max()


@pytest.mark.parametrize("name", ADAPTERS)
def test_adapters_need_cuda_unless_cpu_is_asked(monkeypatch, diffusers, lama,
                                                name):
    _depth(monkeypatch, (16, 16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = (tproto.get_depth_estimator if name == "zoedepth"
             else tproto.get_inpainter)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(name)
    adapter = build(name, device="cpu")
    assert adapter.device == torch.device("cpu")
    if name in ("lama", "sd_controlnet"):
        lama_model = (adapter if name == "lama" else adapter.lama).model
        assert {p.device.type for p in lama_model.parameters()} == {"cpu"}
    if name in ("sd", "sd_controlnet"):
        assert adapter.pipe.device == torch.device("cpu")


def test_adapters_default_to_the_cuda_device(monkeypatch, diffusers):
    """Without a device the adapters are built on CUDA (here only where no
    tensor has to move: the stand-in pipes record the device)."""
    record = _depth(monkeypatch, (16, 16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tproto.get_inpainter("sd").pipe.device == torch.device("cuda")
    assert tproto.get_depth_estimator("zoedepth").device.type == "cuda"
    assert [d.type for _, d in record["pipelines"]] == ["cuda"]


@pytest.mark.parametrize("name", ["sd", "sd_controlnet", "zoedepth"])
def test_a_missing_package_raises_import_error(monkeypatch, name):
    monkeypatch.setitem(sys.modules, PACKAGE[name], None)
    for mod in (jproto, tproto):
        with pytest.raises(ImportError):
            if name == "zoedepth":
                mod.get_depth_estimator(name)
            else:
                mod.get_inpainter(name)
    check = (tproto.depth_estimator_factory if name == "zoedepth"
             else tproto.inpainter_factory)
    with pytest.raises(ImportError):
        check(name)


def test_importing_the_port_imports_neither_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    diffusers and transformers unimported: the adapters import them when
    they register."""
    code = ("import importlib, pkgutil, sys\n"
            "import luciddreamer_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'diffusers', 'transformers'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
