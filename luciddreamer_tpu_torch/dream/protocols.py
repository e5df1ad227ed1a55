"""Generative-model interfaces of the dreaming loop (the twins of
``luciddreamer_tpu/dream/protocols.py``).

* ``Inpainter``      - (image (H, W, 3) in [0, 1], mask (H, W) 1 = hole,
                       prompt, negative_prompt, steps, generator) -> image
* ``DepthEstimator`` - (image (H, W, 3) in [0, 1]) -> metric depth (H, W)

Both take and return tensors and run on the device of their input.  The
defaults are weight-free stand-ins (``ClassicInpainter``, ``RadialDepth``)
that exercise the whole geometry pipeline.  The adapters for real
checkpoints (Stable Diffusion, LaMa, ControlNet, ZoeDepth) are not ported
yet: asking for one raises.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Protocol

import torch

from luciddreamer_tpu_torch.dream.warp import edge_pad

# the JAX package's gated adapters, which need checkpoints to port against
UNPORTED_INPAINTERS = ("sd", "lama", "sd_controlnet")
UNPORTED_DEPTH = ("zoedepth", "zoedepth_flax")


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
_DEPTH: dict[str, Callable[[], DepthEstimator]] = {
    "radial": lambda: RadialDepth(),
}


def register_inpainter(name: str, factory):
    _INPAINTERS[name] = factory


def register_depth_estimator(name: str, factory):
    _DEPTH[name] = factory


def _not_ported(kind: str, name: str):
    return NotImplementedError(
        f"the {name!r} {kind} adapter is not ported to luciddreamer_tpu_torch "
        "yet (it waits for its checkpoints; ROADMAP, Queue 1); use a "
        "weight-free default or register your own factory"
    )


def inpainter_factory(name: str = "classic", model: str | None = None):
    """The registered factory of ``name``, checked before anything is built:
    raises for an adapter that is not ported, and for a ``model`` given to
    a factory without a ``model`` parameter."""
    if name in UNPORTED_INPAINTERS and name not in _INPAINTERS:
        raise _not_ported("inpainter", name)
    factory = _INPAINTERS[name]
    if model is not None:
        import inspect

        try:
            takes_model = "model" in inspect.signature(factory).parameters
        except (TypeError, ValueError):
            takes_model = False
        if not takes_model:
            raise ValueError(
                f"inpainter {name!r} does not accept a checkpoint; "
                "use a factory with a 'model' parameter with --model_name"
            )
    return factory


def get_inpainter(name: str = "classic", model: str | None = None) -> Inpainter:
    """Build a registered inpainter; ``model`` selects the checkpoint of a
    factory that takes a ``model`` parameter."""
    factory = inpainter_factory(name, model)
    return factory(model=model) if model is not None else factory()


def get_depth_estimator(name: str = "radial") -> DepthEstimator:
    if name in UNPORTED_DEPTH and name not in _DEPTH:
        raise _not_ported("depth estimator", name)
    return _DEPTH[name]()


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
