"""Whole training-state checkpoints: params with the alive mask, Adam
count and moments, densification stats and step, as one ``torch.save``
file of plain tensors (the port's own format; the JAX package writes an
orbax directory with the same tree, ``luciddreamer_tpu/train/checkpoint.py``).
"""
from __future__ import annotations

import os

import torch

from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model.gaussians import DensifyStats
from luciddreamer_tpu_torch.model.optim import AdamState
from luciddreamer_tpu_torch.train.loop import TrainState


def state_to_dict(state: TrainState) -> dict:
    """The state as a nested dict of tensors, in the JAX package's tree."""
    return {
        "params": dict(state.params.param_dict(), alive=state.params.alive),
        "adam": {"count": state.adam.count, "mu": state.adam.mu,
                 "nu": state.adam.nu},
        "stats": {
            "grad_accum": state.stats.grad_accum,
            "denom": state.stats.denom,
            "max_radii2d": state.stats.max_radii2d,
        },
        "step": state.step,
    }


def state_from_dict(t: dict) -> TrainState:
    p = dict(t["params"])
    alive = p.pop("alive")
    return TrainState(
        params=GaussianParams.from_param_dict(p, alive),
        adam=AdamState(count=t["adam"]["count"], mu=dict(t["adam"]["mu"]),
                       nu=dict(t["adam"]["nu"])),
        stats=DensifyStats(**t["stats"]),
        step=t["step"],
    )


def save_checkpoint(state: TrainState, path: str) -> str:
    """Write the whole TrainState to the file ``path``."""
    path = os.path.abspath(path)
    torch.save(state_to_dict(state), path)
    return path


def load_checkpoint(path: str, device=None) -> TrainState:
    """Read a file written by ``save_checkpoint`` onto ``device`` (None
    means the CUDA device)."""
    t = torch.load(os.path.abspath(path), map_location=resolve_device(device),
                   weights_only=True)
    return state_from_dict(t)
