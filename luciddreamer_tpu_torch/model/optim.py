"""Per-group Adam and the exp-decay xyz learning-rate schedule (the twins of
``luciddreamer_tpu/model/optim.py``).

Adam with betas 0.9/0.999, eps 1e-15 and torch.optim.Adam's bias
correction, per parameter group keyed by the JAX names ``xyz, f_dc,
f_rest, scaling, rotation, opacity``; learning rates
  xyz      position_lr_init * spatial_lr_scale, exp-decayed to final
  f_dc     feature_lr            f_rest   feature_lr / 20
  opacity  opacity_lr            scaling  scaling_lr      rotation rotation_lr

Plain tensor functions, not ``torch.optim.Adam``: densification zeroes the
moments at re-populated capacity slots, and the training step selects the
old or the new state on the device when a render overflowed.  The update
returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from luciddreamer_tpu_torch.config import GSConfig

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15
GROUPS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor      # () int32, number of updates taken
    mu: dict                 # group name -> first moment
    nu: dict                 # group name -> second moment


def adam_init(params: dict) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=some.device),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def adam_update(params: dict, grads: dict, state: AdamState, lrs: dict):
    """One Adam step.  ``lrs``: name -> lr, a float or a 0-d tensor."""
    count = state.count + 1
    c1, c2 = bias_corrections(count)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        new_p[k], new_m[k], new_v[k] = adam_leaf(
            params[k], grads[k], state.mu[k], state.nu[k], lrs[k], c1, c2)
    return new_p, AdamState(count=count, mu=new_m, nu=new_v)


def bias_corrections(count: torch.Tensor):
    """(1 - beta1^t, 1 - beta2^t) for the update count ``t`` after the step."""
    t = count.to(torch.float32)
    return 1.0 - torch.pow(BETA1, t), 1.0 - torch.pow(BETA2, t)


def adam_leaf(p, g, m, v, lr, c1, c2):
    """Adam on one tensor: (new value, new first moment, new second)."""
    m = BETA1 * m + (1.0 - BETA1) * g
    v = BETA2 * v + (1.0 - BETA2) * (g * g)
    return p - lr * (m / c1) / (torch.sqrt(v / c2) + EPS), m, v


def xyz_lr_schedule(cfg: GSConfig, spatial_lr_scale: float):
    """get_expon_lr_func semantics: log-lerp between init and final over
    max_steps; the reference passes no warm-up delay."""
    lr_init = cfg.position_lr_init * spatial_lr_scale
    lr_final = cfg.position_lr_final * spatial_lr_scale
    max_steps = cfg.position_lr_max_steps

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        return torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return lr


def learning_rates(cfg: GSConfig, spatial_lr_scale: float, step) -> dict:
    """The per-group lr dict for ``adam_update`` at ``step`` (0-based, an
    int or a 0-d tensor; the xyz lr stays on the step's device)."""
    return {
        "xyz": xyz_lr_schedule(cfg, spatial_lr_scale)(step),
        "f_dc": cfg.feature_lr,
        "f_rest": cfg.feature_lr / 20.0,
        "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr,
        "rotation": cfg.rotation_lr,
    }
