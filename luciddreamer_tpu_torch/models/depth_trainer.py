"""Monodepth training of the port's ZoeDepth, the twin of
``luciddreamer_tpu/models/depth_trainer.py`` (the reference's
ZoeDepth/zoedepth/trainers/base_trainer.py + zoedepth_trainer.py): SILog
(+ optional gradient) loss, the one-cycle learning-rate schedule, gradient
clipping to a global norm of 0.1, AdamW, a guard that skips a batch whose
loss is not finite, and validation with best-checkpoint tracking.

The schedule and the optimizer are optax's, rebuilt by formula:
``cosine_onecycle_schedule`` (not ``torch.optim.lr_scheduler.OneCycleLR``,
which places its boundaries elsewhere and also cycles Adam's beta1) and
``chain(clip_by_global_norm(0.1), adamw(b1 0.9, b2 0.999, eps 1e-8,
weight decay 0.01 on every tensor))``; the clip scales by max/||g|| only
when ||g|| >= max, with no epsilon.

With a ``parallel.sharded.Mesh`` the global batch is split over its
``data`` index and the predictions are gathered before the loss, so the
loss and the gradient are the global batch's (SILog is a root of global
masked moments: averaging per-rank SILog gradients would be wrong); the
gradients of the ranks' slices are summed over the ``data`` group and the
update runs replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.models.depth_eval import compute_metrics
from luciddreamer_tpu_torch.models.depth_losses import grad_l1_loss, silog_loss
from luciddreamer_tpu_torch.models.zoedepth import (
    ZoeDepth, ZoeDepthConfig, init_random_,
)
from luciddreamer_tpu_torch.parallel.sharded import (
    all_reduce_flat, gather_replicated,
)

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class DepthTrainConfig:
    """Mirrors config_zoedepth.json 'train' (lr 1.61e-4, wd 0.01, one-cycle
    with div_factor 1 / final_div_factor 1e4 / pct_start 0.7, grad clip 0.1,
    w_si 1, w_grad 0)."""

    lr: float = 1.61e-4
    weight_decay: float = 0.01
    epochs: int = 5
    steps_per_epoch: int = 100
    pct_start: float = 0.7
    div_factor: float = 1.0
    final_div_factor: float = 10_000.0
    grad_clip: float = 0.1
    w_si: float = 1.0
    w_grad: float = 0.0
    validate_every: int = 100


def onecycle_schedule(cfg: DepthTrainConfig) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule(total steps, lr, pct_start, div_factor,
    final_div_factor): from lr / div_factor up to lr at step int(pct_start
    * total), then down to lr / div_factor / final_div_factor at step total,
    each leg a half cosine; constant after.  Evaluated in float64; optax
    does so in float32."""
    total = cfg.epochs * cfg.steps_per_epoch
    if total <= 0:
        raise ValueError("the one-cycle schedule needs a positive step count")
    bounds = (0, int(cfg.pct_start * total), int(total))
    values = np.cumprod([cfg.lr / cfg.div_factor, cfg.div_factor,
                         1.0 / (cfg.div_factor * cfg.final_div_factor)])

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0
                             * (math.cos(math.pi * pct) + 1))
        return float(values[-1])

    return schedule


@torch.no_grad()
def _adamw_update(params, grads, mu, nu, count, lr, weight_decay, max_norm):
    """optax's clip_by_global_norm(max_norm) then adamw(lr, weight_decay),
    in place on ``params``, ``mu`` and ``nu``; ``count`` is the update's
    1-based number."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    grads = torch._foreach_mul(
        torch._foreach_div(grads, torch.where(keep, 1.0, norm)),
        torch.where(keep, 1.0, max_norm))
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
    m_hat = torch._foreach_div(mu, 1.0 - B1**count)
    v_hat = torch._foreach_div(nu, 1.0 - B2**count)
    torch._foreach_sqrt_(v_hat)
    torch._foreach_add_(v_hat, EPS)
    upd = torch._foreach_div(m_hat, v_hat)
    torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_add_(params, upd, alpha=-lr)


class DepthTrainer:
    """Trains a ``ZoeDepth`` of ``model_cfg`` (default the tiny test
    configuration) from random weights seeded with ``seed``.  ``mesh``: a
    ``parallel.sharded.Mesh`` whose ``data`` index splits each batch (its
    device is the model's); ``device=None`` means the CUDA device."""

    def __init__(self, model_cfg: Optional[ZoeDepthConfig] = None,
                 cfg: Optional[DepthTrainConfig] = None, seed: int = 0,
                 mesh=None, device=None):
        dev = resolve_device(device)
        if mesh is not None and dev.type != mesh.device.type:
            raise ValueError(f"the trainer is on {dev}, its mesh on "
                             f"{mesh.device}")
        self.device = mesh.device if mesh is not None else dev
        self.model_cfg = model_cfg or ZoeDepthConfig.tiny()
        self.cfg = cfg or DepthTrainConfig()
        self.model = ZoeDepth(self.model_cfg).to(self.device).eval()
        init_random_(self.model, seed)
        self.params = list(self.model.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.schedule = onecycle_schedule(self.cfg)
        self.step = 0
        self.best_metric = float("inf")
        self.best_params = None
        self.mesh = mesh

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=self.device)

    def _predict(self, image):
        """(B, H, W, 3) images -> (B, H, W) metric depth."""
        return self.model(image.permute(0, 3, 1, 2))["metric_depth"]

    def _loss(self, pred, depth, mask):
        loss = self.cfg.w_si * silog_loss(pred, depth, mask)
        if self.cfg.w_grad > 0:
            loss = loss + self.cfg.w_grad * grad_l1_loss(pred, depth, mask)
        return loss

    def _global_pred(self, image):
        """The predictions of the whole batch: with a mesh this rank predicts
        its slice of the data split and the slices are gathered."""
        mesh = self.mesh
        if mesh is None or mesh.data_group is None:
            return self._predict(image)
        B = image.shape[0]
        if B % mesh.data:
            raise ValueError(f"a batch of {B} does not split over "
                             f"{mesh.data} data ranks")
        b = B // mesh.data
        local = self._predict(image[mesh.d_index * b:(mesh.d_index + 1) * b])
        return gather_replicated(local, mesh.data_group, mesh.data,
                                 mesh.d_index, 0)

    def train_batch(self, image, depth, mask=None):
        """One step on image (B, H, W, 3), depth (B, H, W) and mask (default
        depth > 0); returns the loss.  A batch whose loss is not finite
        changes nothing and does not count as a step (the reference's NaN
        guard, base_trainer.py:125-128)."""
        image, depth = self._tensor(image), self._tensor(depth)
        mask = depth > 0 if mask is None else self._tensor(mask, torch.bool)
        loss = self._loss(self._global_pred(image), depth, mask)
        grads = torch.autograd.grad(loss, self.params)
        value = float(loss.detach())
        if not math.isfinite(value):
            return value
        lr = self.schedule(self.step)
        self.step += 1
        if self.mesh is not None:
            grads = all_reduce_flat(list(grads), self.mesh.data_group)
        _adamw_update(self.params, list(grads), self.mu, self.nu, self.step,
                      lr, self.cfg.weight_decay, self.cfg.grad_clip)
        return value

    @torch.no_grad()
    def validate(self, batches: Iterable, crop: str | None = None) -> dict:
        """The metric suite averaged over the images of ``batches`` of
        (image (B, H, W, 3), depth (B, H, W), ...); keeps a CPU copy of the
        weights with the best abs_rel (base_trainer.py:217-257)."""
        acc: dict[str, list] = {}
        for image, depth, *_ in batches:
            pred = self._predict(self._tensor(image)).cpu().numpy()
            depth = np.asarray(depth.cpu() if torch.is_tensor(depth) else depth)
            for b in range(pred.shape[0]):
                for k, v in compute_metrics(depth[b], pred[b], crop=crop).items():
                    acc.setdefault(k, []).append(v)
        means = {k: float(np.nanmean(v)) for k, v in acc.items()}
        if means.get("abs_rel", float("inf")) < self.best_metric:
            self.best_metric = means["abs_rel"]
            self.best_params = {k: v.detach().cpu().clone() for k, v in
                                self.model.state_dict().items()}
        return means

    def fit(self, data: Iterable, val_data=None, log_fn: Callable = print):
        """``data`` yields (image (B, H, W, 3), depth (B, H, W)[, mask])."""
        for i, batch in enumerate(data):
            loss = self.train_batch(*batch)
            if val_data is not None and (i + 1) % self.cfg.validate_every == 0:
                metrics = self.validate(val_data)
                log_fn(f"step {self.step}: loss {loss:.4f} "
                       f"abs_rel {metrics['abs_rel']:.4f}")
        return self.model.state_dict()
