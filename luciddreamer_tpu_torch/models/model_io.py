"""Depth-model registry, builder and weight files (the twin of
``luciddreamer_tpu/models/model_io.py``).

- ``build_depth_model(name, ...)`` resolves a registered architecture to a
  ``ZoeDepthEstimator`` on ``device``, with weights where given;
- ``save_params`` / ``load_params`` write and read the port's own state
  dict with ``torch.save`` / ``torch.load`` (weights only);
- ``load_pretrained`` reads a reference .pt/.pth checkpoint through
  ``models/convert.py``, and any other file as the port's own.

The JAX package's flax msgpack files are not read here: carry a JAX
parameter tree across with ``luciddreamer_tpu_torch.convert.
zoedepth_state_dict``.
"""
from __future__ import annotations

import os
from typing import Callable

import torch

from luciddreamer_tpu_torch.models.zoedepth import (
    ZoeDepthConfig,
    ZoeDepthEstimator,
)

_REGISTRY: dict[str, tuple[Callable[[], ZoeDepthConfig], str]] = {}

# names of full-size entries that refuse to build random-initialised
_FULL_SIZE = frozenset({"zoedepth", "zoedepth_k", "zoedepth_nk"})


def register_depth_model(name: str, cfg_factory: Callable[[], ZoeDepthConfig],
                         kind: str = "zoedepth"):
    """``kind`` selects the architecture: 'zoedepth' (single-head N/K) or
    'zoedepth_nk' (two heads and a router)."""
    _REGISTRY[name] = (cfg_factory, kind)


register_depth_model("zoedepth", ZoeDepthConfig)          # ZoeD_N geometry
register_depth_model("zoedepth_tiny", ZoeDepthConfig.tiny)
register_depth_model("zoedepth_k", ZoeDepthConfig.kitti)  # ZoeD_K (normed)
register_depth_model("zoedepth_k_tiny", ZoeDepthConfig.kitti_tiny)
register_depth_model("zoedepth_nk", ZoeDepthConfig, kind="zoedepth_nk")
register_depth_model("zoedepth_nk_tiny", ZoeDepthConfig.tiny,
                     kind="zoedepth_nk")


def available_depth_models() -> list[str]:
    return sorted(_REGISTRY)


def save_params(state_dict: dict, path: str) -> str:
    """Write a model's state dict (moved to the CPU) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return path


def load_params(path: str) -> dict:
    """Read a state dict written by ``save_params``."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrained(path: str, cfg: ZoeDepthConfig, kind: str = "zoedepth"):
    """The port's state dict from ``path``: a reference checkpoint for
    .pt/.pth files, the port's own file otherwise."""
    if path.endswith((".pt", ".pth")):
        from luciddreamer_tpu_torch.models import convert

        sd = convert.load_torch_state_dict(path)
        if kind == "zoedepth_nk":
            return convert.convert_zoedepth_nk_state_dict(sd, cfg)
        return convert.convert_zoedepth_state_dict(sd, cfg)
    return load_params(path)


def build_depth_model(name: str = "zoedepth", pretrained: str | None = None,
                      cfg: ZoeDepthConfig | None = None, device=None,
                      **estimator_kw) -> ZoeDepthEstimator:
    """The registry's entry point: ZoeD_N ('zoedepth'), ZoeD_K
    ('zoedepth_k') and ZoeD_NK ('zoedepth_nk') and their tiny test-scale
    twins, on ``device`` (default: the CUDA device).

    ``pretrained`` is a checkpoint path; when omitted, the environment
    variable ``LDT_ZOE_CKPT`` is read.  A full-size model without weights
    raises: random weights make no metric depth model.
    """
    kind = "zoedepth"
    if name in _REGISTRY:
        factory, kind = _REGISTRY[name]
        if cfg is None:
            cfg = factory()
    elif cfg is None:
        raise KeyError(
            f"unknown depth model {name!r}; have {available_depth_models()}"
        )
    pretrained = pretrained or os.environ.get("LDT_ZOE_CKPT") or None
    state_dict = None
    if pretrained:
        if not os.path.exists(pretrained):
            raise FileNotFoundError(
                f"depth checkpoint {pretrained!r} does not exist"
            )
        state_dict = load_pretrained(pretrained, cfg, kind)
    elif name in _FULL_SIZE:
        raise RuntimeError(
            f"build_depth_model({name!r}) needs pretrained weights: pass "
            "pretrained=<path to a reference .pt or a file of save_params> "
            f"or set LDT_ZOE_CKPT. Use name='{name}_tiny' for a random-init "
            "test-scale model."
        )
    if kind == "zoedepth_nk":
        from luciddreamer_tpu_torch.models.zoedepth_nk import ZoeDepthNK

        estimator_kw.setdefault("model_cls", ZoeDepthNK)
    return ZoeDepthEstimator(cfg=cfg, state_dict=state_dict, device=device,
                             **estimator_kw)
