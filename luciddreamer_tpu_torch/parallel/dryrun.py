"""A dry run of the data x tiles training step at production-like sizes,
the twin of ``__graft_entry__.py::dryrun_multichip``: P = 10,000 Gaussians
in a capacity of 16,384, 128x128 images, a data x tiles split of the
world, and the overflow protocol under sharding (a deliberately tight
per-band pair budget must flag overflow and leave the state as it was)."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model.gaussians import DensifyStats
from luciddreamer_tpu_torch.model.optim import adam_init
from luciddreamer_tpu_torch.parallel.overlap import sharded_train_step_overlapped
from luciddreamer_tpu_torch.parallel.sharded import (
    make_mesh, sharded_train_step_batch,
)
from luciddreamer_tpu_torch.train.loop import TrainState

SIZE = 128                  # an 8 x 8 tile grid


def dryrun_scene(P: int = 10_000, capacity: int = 16_384, seed: int = 0,
                 device=None) -> GaussianParams:
    """``__graft_entry__.py::_scene``'s Gaussians: P live rows of a blob 3
    units ahead of the camera, padded with dead rows to ``capacity``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pad = lambda x: np.pad(x, [(0, capacity - P)] + [(0, 0)] * (x.ndim - 1))
    rot = pad(rng.normal(size=(P, 4)).astype(np.float32))
    rot[P:, 0] = 1.0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return GaussianParams(
        xyz=f32(pad(rng.normal(size=(P, 3)) * 1.0 + [0, 0, 3.0])),
        features_dc=f32(pad(rng.normal(size=(P, 1, 3)) * 0.5)),
        features_rest=f32(pad(rng.normal(size=(P, 15, 3)) * 0.1)),
        scaling=f32(pad(rng.uniform(-4.5, -2.5, size=(P, 3)))),
        rotation=f32(rot),
        opacity=f32(pad(rng.uniform(-2.0, 3.0, size=(P, 1)))),
        alive=torch.as_tensor(np.arange(capacity) < P, device=dev),
    )


def _check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the sharded step on a mesh over the ``n_devices`` processes of
    the current world (a world of one without a process group): one step
    with an adequate per-band budget (65,536) that must commit and move the
    Gaussians, one with a tight budget (128) that must overflow and change
    nothing, then the overlapped step with the depth term.  Every rank
    calls it.  Raises on any failure; returns the losses and flags."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of {world}")
    data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(data=data, tiles=n_devices // data, device=dev)
    params = dryrun_scene(device=dev)
    cams = []
    for b in range(data):
        c2w = np.eye(4)
        c2w[0, 3] = 0.1 * b
        cams.append(make_camera(c2w, 0.8279, 0.8279, SIZE, SIZE, device=dev))
    gt = torch.zeros((data, 3, SIZE, SIZE), device=dev)
    bg = torch.zeros(3, device=dev)
    cfg = GSConfig()
    state = TrainState(
        params=params, adam=adam_init(params.param_dict()),
        stats=DensifyStats.zero(params.capacity, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )
    step = lambda s, cap: sharded_train_step_batch(
        s, cams, gt, bg, mesh, cfg, extent=1.0, chunk=32, pair_cap=cap)

    new, loss, ovf = step(state, 65_536)
    _check(bool(torch.isfinite(loss)), f"loss {float(loss)}")
    _check(not bool(ovf), "an adequate pair budget overflowed")
    _check(int(new.step) == 1, "the step was not committed")
    _check(bool((new.params.xyz != params.xyz).any()), "nothing moved")

    tight, _, ovf2 = step(new, 128)
    _check(bool(ovf2), "a tight pair budget did not overflow")
    _check(int(tight.step) == 1, "an overflowed step was committed")
    _check(torch.equal(tight.params.xyz, new.params.xyz)
           and torch.equal(tight.adam.mu["xyz"], new.adam.mu["xyz"])
           and torch.equal(tight.stats.denom, new.stats.denom),
           "an overflowed update was not voided")

    gt_depth = torch.full((data, SIZE, SIZE), 2.0, device=dev)
    ovl, ovl_loss, ovl_ovf = sharded_train_step_overlapped(
        new, cams, gt, bg, mesh, GSConfig(lambda_depth=0.3), extent=1.0,
        chunk=32, pair_cap=65_536, gt_depth_batch=gt_depth)
    _check(bool(torch.isfinite(ovl_loss)) and not bool(ovl_ovf),
           "the overlapped step failed")
    _check(int(ovl.step) == 2, "the overlapped step was not committed")
    return {"mesh": mesh.shape, "loss": float(loss),
            "tight_overflow": bool(ovf2), "overlapped_loss": float(ovl_loss)}
