"""Twins of the two entry points of ``__graft_entry__.py``:
``entry()``, the flagship forward call (the tiled differentiable 3DGS
render, RGB and depth, of 2,048 Gaussians at 256x256), and
``dryrun_multichip``, the sharded training step's dry run
(``parallel/dryrun.py``)."""
from __future__ import annotations

import numpy as np
import torch

from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.parallel.dryrun import dryrun_multichip, dryrun_scene
from luciddreamer_tpu_torch.render.tiled import render_tiled

__all__ = ["dryrun_multichip", "entry"]


def entry(device=None):
    """``(fn, (params, camera, bg))``: ``fn`` renders ``params`` through
    ``render_tiled`` with the CUDA blend (its plain version for tensors on
    the CPU) at chunk 64 and returns ``(render (3, 256, 256), depth (256,
    256))``; the arguments are ``__graft_entry__._scene(P=2048)``'s
    Gaussians, the origin camera and a black background on ``device``
    (None: the CUDA device; raises without one)."""
    dev = resolve_device(device)
    params = dryrun_scene(P=2048, capacity=2048, seed=0, device=dev)
    camera = make_camera(np.eye(4), 0.8279, 0.8279, 256, 256, device=dev)
    bg = torch.zeros(3, device=dev)

    def fn(params, camera, bg):
        out = render_tiled(params, camera, bg, active_sh_degree=3, chunk=64,
                           backend="cuda")
        return out["render"], out["depth"]

    return fn, (params, camera, bg)
