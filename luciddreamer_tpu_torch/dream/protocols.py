"""Generative-model interfaces of the dreaming loop (the twins of
``luciddreamer_tpu/dream/protocols.py``).

* ``Inpainter``      - (image (H, W, 3) in [0, 1], mask (H, W) 1 = hole,
                       prompt, negative_prompt, steps, generator) -> image
* ``DepthEstimator`` - (image (H, W, 3) in [0, 1]) -> metric depth (H, W)

Both take and return tensors.  The defaults are weight-free stand-ins
(``ClassicInpainter``, ``RadialDepth``) that exercise the whole geometry
pipeline and run on the device of their input.  ``zoedepth_flax`` is the
port's ZoeDepth (``models/``) at its tiny test scale with seeded random
weights, as the JAX package's name of it builds.  The adapters for real
checkpoints register lazily, when first asked for, so that importing this
module imports neither ``diffusers`` nor ``transformers``; a missing
package raises ``ImportError`` then.  Each is built on a device (None: the
CUDA device) and returns its result there:

* ``sd``            - Stable Diffusion inpainting through ``diffusers``;
* ``lama``          - the big-LaMa TorchScript inpainter (md5-checked fetch);
* ``sd_controlnet`` - ControlNet inpainting, its init image filled by LaMa;
* ``zoedepth``      - ZoeDepth through ``transformers``' depth pipeline.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Protocol

import numpy as np
import torch
import torch.nn.functional as F

from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.dream.warp import edge_pad


class Inpainter(Protocol):
    def __call__(self, image, mask, prompt: str = "",
                 negative_prompt: str = "", steps: int = 30,
                 rng: Optional[torch.Generator] = None):
        ...


class DepthEstimator(Protocol):
    def __call__(self, image):
        ...


class ClassicInpainter:
    """Weight-free diffusion-style hole filling: iterative masked neighbour
    averaging with per-step noise.  Fills holes smoothly from the boundary
    colours (no semantic hallucination, by construction).  The noise comes
    from ``rng``, a ``torch.Generator`` on the image's device."""

    def __init__(self, noise_scale: float = 0.02):
        self.noise_scale = noise_scale

    def __call__(self, image, mask, prompt: str = "",
                 negative_prompt: str = "", steps: int = 30,
                 rng: Optional[torch.Generator] = None):
        image = torch.as_tensor(image, dtype=torch.float32)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=image.device)
        if rng is None:
            rng = torch.Generator(device=image.device).manual_seed(0)
        steps = max(int(steps), 1) * 8     # neighbour fill needs more passes
        hole = (mask > 0.5)[..., None]
        # seed the holes with the image mean so the diffusion starts plausibly
        keep = 1 - mask
        mean = torch.sum(image * keep[..., None], (0, 1)) / torch.clamp_min(
            torch.sum(keep), 1.0)
        img = torch.where(hole, mean, image)
        for _ in range(steps):
            p = edge_pad(img, 1, 1)
            neigh = (
                p[:-2, 1:-1] + p[2:, 1:-1]
                + p[1:-1, :-2] + p[1:-1, 2:]
                + p[:-2, :-2] + p[:-2, 2:]
                + p[2:, :-2] + p[2:, 2:]
            ) / 8.0
            noise = torch.randn(img.shape, generator=rng,
                                device=img.device) * self.noise_scale
            img = torch.where(hole, torch.clamp(neigh + noise, 0.0, 1.0), img)
        return img


class RadialDepth:
    """Weight-free monodepth stand-in: a brightness-modulated radial depth
    field (darker and peripheral pixels farther), smooth and positive."""

    def __init__(self, base: float = 2.0, amplitude: float = 1.0):
        self.base = base
        self.amplitude = amplitude

    def __call__(self, image):
        image = torch.as_tensor(image, dtype=torch.float32)
        H, W, _ = image.shape
        dev = image.device
        lum = torch.mean(image, -1)
        y, x = torch.meshgrid(torch.linspace(-1, 1, H, device=dev),
                              torch.linspace(-1, 1, W, device=dev),
                              indexing="ij")
        r = torch.sqrt(x * x + y * y)
        depth = self.base + self.amplitude * (0.5 * r + 0.5 * (1.0 - lum))
        p = edge_pad(depth, 1, 1)            # light smoothing
        return (
            p[1:-1, 1:-1] * 4 + p[:-2, 1:-1] + p[2:, 1:-1]
            + p[1:-1, :-2] + p[1:-1, 2:]
        ) / 8.0


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_INPAINTERS: dict[str, Callable[..., Inpainter]] = {
    "classic": lambda: ClassicInpainter(),
}


def _zoedepth_flax(device=None):
    """What the JAX package's ``FlaxZoeDepthEstimator()`` is: the tiny
    config with random weights from seed 0 (not the same draws)."""
    from luciddreamer_tpu_torch.models.zoedepth import ZoeDepthEstimator

    return ZoeDepthEstimator(device=device)


_DEPTH: dict[str, Callable[..., DepthEstimator]] = {
    "radial": lambda device=None: RadialDepth(),
    "zoedepth_flax": _zoedepth_flax,
}


def register_inpainter(name: str, factory):
    """Register ``factory()``, or ``factory(device=None)`` to have the
    inpainter built on the device the dream runs on (None: the CUDA
    device)."""
    _INPAINTERS[name] = factory


def register_depth_estimator(name: str, factory):
    """Register ``factory(device=None)``: it builds the estimator on
    ``device`` (None: the CUDA device), the device the dream runs on."""
    _DEPTH[name] = factory


def _takes(factory, param: str) -> bool:
    import inspect

    try:
        return param in inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False


def inpainter_factory(name: str = "classic", model: str | None = None):
    """The factory of ``name``, registering an adapter first (which raises
    ``ImportError`` where its package is missing); checked before anything
    is built: raises ``KeyError`` for an unknown name and ``ValueError``
    for a ``model`` given to a factory without a ``model`` parameter."""
    if name not in _INPAINTERS and name in _INPAINTER_ADAPTERS:
        _INPAINTER_ADAPTERS[name]()
    factory = _INPAINTERS[name]
    if model is not None and not _takes(factory, "model"):
        raise ValueError(
            f"inpainter {name!r} does not accept a checkpoint; "
            "use 'sd' or 'sd_controlnet' (or a factory with a "
            "'model' parameter) with --model_name"
        )
    return factory


def get_inpainter(name: str = "classic", model: str | None = None,
                  device=None) -> Inpainter:
    """Build a registered inpainter; ``model`` selects the checkpoint of a
    factory that takes a ``model`` parameter, and ``device`` (None: the
    CUDA device) is passed to a factory that takes a ``device``
    parameter."""
    factory = inpainter_factory(name, model)
    kw = {} if model is None else {"model": model}
    if _takes(factory, "device"):
        kw["device"] = device
    return factory(**kw)


def depth_estimator_factory(name: str = "radial"):
    """The factory of ``name``, registering an adapter first (which raises
    ``ImportError`` where its package is missing); raises ``KeyError`` for
    an unknown name."""
    if name not in _DEPTH and name in _DEPTH_ADAPTERS:
        _DEPTH_ADAPTERS[name]()
    return _DEPTH[name]


def get_depth_estimator(name: str = "radial", device=None) -> DepthEstimator:
    """Build a registered depth estimator on ``device`` (None: the CUDA
    device), so that the model lives where the dream runs."""
    return depth_estimator_factory(name)(device=device)


def resolve_sd_checkpoint(model_name: str | None,
                          out_root: str = "./stablediffusion") -> str | None:
    """Normalise a Stable Diffusion checkpoint argument.

    A ``.safetensors`` file is converted once into a diffusers directory
    under ``out_root`` (through ``from_single_file``, which needs the
    ``diffusers`` package) and the directory is returned; anything else (a
    hub id, a local diffusers directory, None) passes through unchanged.
    """
    if model_name is None or not model_name.endswith("safetensors"):
        return model_name
    out_dir = os.path.join(
        out_root, os.path.splitext(os.path.basename(model_name))[0]
    )
    if not os.path.exists(os.path.join(out_dir, "model_index.json")):
        from diffusers import StableDiffusionInpaintPipeline

        pipe = StableDiffusionInpaintPipeline.from_single_file(model_name)
        pipe.save_pretrained(out_dir)
    return out_dir


# ---------------------------------------------------------------------------
# adapters for real checkpoints (the twins of the JAX package's)
# ---------------------------------------------------------------------------

def _pil(x, rounded: bool = False):
    """An array in [0, 1] as an 8-bit PIL image, converted on the host as
    the JAX adapters do: ``(x * 255)`` truncated, or rounded."""
    from PIL import Image as PILImage

    a = np.asarray(torch.as_tensor(x).cpu(), np.float32) * 255
    return PILImage.fromarray((np.round(a) if rounded else a).astype(np.uint8))


def _seed(rng: Optional[torch.Generator]) -> int:
    """A 31-bit seed drawn from the dream's generator (0 without one)."""
    if rng is None:
        return 0
    return int(torch.randint(0, 2**31 - 1, (), generator=rng,
                             device=rng.device))


def _register_sd():
    """Stable Diffusion inpainting through ``diffusers`` (the twin of the
    JAX ``SDInpainter``); raises ImportError without ``diffusers``."""
    from diffusers import StableDiffusionInpaintPipeline

    class SDInpainter:
        def __init__(self, model="runwayml/stable-diffusion-inpainting",
                     device=None):
            self.device = resolve_device(device)
            self.pipe = StableDiffusionInpaintPipeline.from_pretrained(
                model).to(self.device)

        def __call__(self, image, mask, prompt="", negative_prompt="",
                     steps=30, rng=None):
            gen = torch.Generator(device=self.device).manual_seed(_seed(rng))
            out = self.pipe(
                prompt=prompt, image=_pil(image), mask_image=_pil(mask),
                negative_prompt=negative_prompt,
                num_inference_steps=steps, generator=gen,
            ).images[0]
            return torch.as_tensor(np.array(out), dtype=torch.float32,
                                   device=self.device) / 255.0

    register_inpainter("sd", SDInpainter)


LAMA_URL = "https://github.com/Sanster/models/releases/download/add_big_lama/big-lama.pt"
LAMA_MD5 = "e3aa4aaa15225a33ec84f9f4bc47e500"


def _register_lama():
    """The big-LaMa TorchScript inpainter (the twin of the JAX
    ``LamaInpainter``): md5-checked fetch of big-lama.pt (the model is
    loaded from the path the fetch returns), reflect pad to a multiple of
    8, composite by the mask."""
    from luciddreamer_tpu_torch.utils.download import fetch_checked

    class LamaInpainter:
        def __init__(self, cache_dir: str = "~/.cache/luciddreamer_tpu",
                     device=None):
            self.device = resolve_device(device)
            path = fetch_checked(
                LAMA_URL,
                os.path.join(os.path.expanduser(cache_dir), "big-lama.pt"),
                md5=LAMA_MD5)
            # load on the CPU, then move: a traced TorchScript file can hold
            # constants tied to the device it was traced on, which loading
            # straight onto another device does not move
            self.model = torch.jit.load(path, map_location="cpu").to(
                self.device).eval()

        def __call__(self, image, mask, prompt="", negative_prompt="",
                     steps=30, rng=None):
            img = torch.as_tensor(image, dtype=torch.float32,
                                  device=self.device)
            m = (torch.as_tensor(mask, dtype=torch.float32, device=self.device)
                 > 0.5).to(torch.float32)
            h, w = img.shape[:2]
            ph, pw = (8 - h % 8) % 8, (8 - w % 8) % 8
            # reflect as numpy's: valid while each pad is below its side
            ti = F.pad(img.permute(2, 0, 1)[None], (0, pw, 0, ph),
                       mode="reflect")
            tm = F.pad(m[None, None], (0, pw, 0, ph), mode="reflect")
            with torch.no_grad():
                out = self.model(ti, tm)[0].permute(1, 2, 0)[:h, :w]
            res = img * (1 - m[..., None]) + out * m[..., None]
            return torch.clamp(res, 0.0, 1.0)

    register_inpainter("lama", LamaInpainter)


def _register_sd_controlnet():
    """ControlNet inpainting seeded by LaMa (the twin of the JAX
    ``ControlNetInpainter``): the holes (the mask or all-black pixels)
    padded by 3 px, LaMa's fill as the init image, the condition at -1 in
    the holes, strength 0.9.  Raises ImportError without ``diffusers``."""
    from diffusers import (
        ControlNetModel,
        StableDiffusionControlNetInpaintPipeline,
    )

    from luciddreamer_tpu_torch.dream.maskops import (
        controlnet_inpaint_condition,
        pad_mask,
    )

    class ControlNetInpainter:
        def __init__(self, model="runwayml/stable-diffusion-inpainting",
                     controlnet="lllyasviel/control_v11p_sd15_inpaint",
                     use_lama: bool = True, device=None):
            self.device = resolve_device(device)
            cn = ControlNetModel.from_pretrained(controlnet)
            self.pipe = StableDiffusionControlNetInpaintPipeline.from_pretrained(
                model, controlnet=cn, safety_checker=None,
            ).to(self.device)
            self.lama = (get_inpainter("lama", device=self.device)
                         if use_lama else None)

        def __call__(self, image, mask, prompt="", negative_prompt="",
                     steps=30, rng=None):
            img = torch.as_tensor(image, dtype=torch.float32,
                                  device=self.device)
            m = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
            holes = torch.clamp((img.prod(-1) == 0).to(torch.float32) + m, 0, 1)
            padded = pad_mask(holes, 3).to(torch.float32)
            init = img
            if self.lama is not None:
                init = self.lama(img * (1.0 - padded[..., None]), padded)
            gen = torch.Generator(device=self.device).manual_seed(_seed(rng))
            out = self.pipe(
                prompt=prompt,
                negative_prompt=negative_prompt,
                image=_pil(init, rounded=True),
                mask_image=_pil(padded),
                control_image=controlnet_inpaint_condition(init, padded),
                strength=0.9,
                num_inference_steps=steps,
                generator=gen,
                height=img.shape[0],
                width=img.shape[1],
            ).images[0]
            return torch.as_tensor(np.array(out), dtype=torch.float32,
                                   device=self.device) / 255.0

    register_inpainter("sd_controlnet", ControlNetInpainter)


def _register_zoedepth():
    """ZoeDepth through ``transformers``' depth-estimation pipeline (the
    twin of the JAX ``HFZoeDepth``); raises ImportError without
    ``transformers``.  A depth map of another size than the image is
    resized bilinearly on the device, as ``cv2.resize`` does on the host
    (half-pixel centres, no antialiasing)."""
    from transformers import pipeline as hf_pipeline

    class HFZoeDepth:
        def __init__(self, model="Intel/zoedepth-nyu", device=None):
            self.device = resolve_device(device)
            self.pipe = hf_pipeline("depth-estimation", model=model,
                                    device=self.device)

        def __call__(self, image):
            out = self.pipe(_pil(image))["predicted_depth"]
            d = torch.as_tensor(out, dtype=torch.float32,
                                device=self.device).squeeze()
            hw = tuple(image.shape[:2])
            if tuple(d.shape) != hw:
                d = F.interpolate(d[None, None], size=hw, mode="bilinear",
                                  align_corners=False, antialias=False)[0, 0]
            return d

    register_depth_estimator("zoedepth", HFZoeDepth)


_INPAINTER_ADAPTERS = {"sd": _register_sd, "lama": _register_lama,
                       "sd_controlnet": _register_sd_controlnet}
_DEPTH_ADAPTERS = {"zoedepth": _register_zoedepth}
