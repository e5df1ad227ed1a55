"""The 3DGS optimisation loop ("baking"), the twin of
``luciddreamer_tpu/train/loop.py``.

One training step covers render -> loss -> backward -> Adam -> the
densification statistics.  The Gaussian buffer has a fixed capacity with
an alive mask, so densify/prune never reallocates.  The SH warm-up is a
coefficient mask derived on the device from the step counter, which also
stays on the device, as does the xyz learning rate.

A render that overflowed its pair budget dropped pairs and its gradient is
wrong: the whole update is then selected away on the device and the step
is not counted.  The host reads each step's overflow flag one step later,
from a pinned host copy behind a CUDA event, so it never blocks on the
step in flight; the lost step is run again after the pair budget doubles.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from luciddreamer_tpu_torch.config import GSConfig
from luciddreamer_tpu_torch.core.types import Camera, GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model.gaussians import (
    DensifyStats,
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
)
from luciddreamer_tpu_torch.model.optim import (
    GROUPS, AdamState, adam_init, adam_update, learning_rates,
)
from luciddreamer_tpu_torch.render.tiled import default_pair_capacity, render_tiled
from luciddreamer_tpu_torch.train.losses import l1_loss, ssim
from luciddreamer_tpu_torch.utils.debug import check_finite


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    adam: AdamState
    stats: DensifyStats
    step: torch.Tensor       # () int32, number of completed iterations


def sh_band_mask(active_degree, n_rest: int, device=None) -> torch.Tensor:
    """(n_rest, 1) 0/1 mask keeping SH bands <= active_degree (an int or a
    0-d tensor); the rest coefficients start at band 1."""
    idx = torch.arange(n_rest, device=device) + 1
    band = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    return (band <= active_degree).to(torch.float32)[:, None]


def view_loss(img, gt_image, depth, gt_depth, cfg: GSConfig):
    """(1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM), plus lambda_depth
    times the depth L1 over the pixels where both depths are positive when
    ``gt_depth`` is given.  For one view (3, H, W) or a batch (B, 3, H, W):
    L1 and SSIM are means over every pixel of the batch, the depth term's
    mask count is the batch's."""
    loss = (1.0 - cfg.lambda_dssim) * l1_loss(img, gt_image) + \
        cfg.lambda_dssim * (1.0 - ssim(img, gt_image))
    if cfg.lambda_depth > 0.0 and gt_depth is not None:
        dmask = (gt_depth > 0) & (depth > 0)
        dl = torch.sum(torch.abs(depth - gt_depth) * dmask) / (
            torch.sum(dmask) + 1e-8
        )
        loss = loss + cfg.lambda_depth * dl
    return loss


def loss_and_grads(state: TrainState, loss_fn):
    """Differentiate ``loss_fn(render_params, mean2d_offset) -> (loss,
    aux)`` at ``state`` under the SH warm-up mask of its next step: (the
    detached loss, aux, the gradients by group name, dL/d mean2d_offset)."""
    it = state.step + 1                       # 1-based iteration
    max_deg = state.params.max_sh_degree
    active_deg = torch.clamp_max(it // 1000, max_deg)
    n_rest = (max_deg + 1) ** 2 - 1
    sh_mask = sh_band_mask(active_deg, n_rest, device=state.step.device)
    p = state.params.param_dict()
    # the masked SH rest is the render's leaf; d/d(raw) = d/d(masked) * mask
    render_params = GaussianParams.from_param_dict(
        dict(p, f_rest=p["f_rest"] * sh_mask[None]), state.params.alive
    )
    offset = torch.zeros_like(p["xyz"][:, :2], requires_grad=True)
    loss, aux = loss_fn(render_params, offset)
    g = torch.autograd.grad(
        loss,
        [render_params.xyz, render_params.features_dc,
         render_params.features_rest, render_params.scaling,
         render_params.rotation, render_params.opacity, offset],
        allow_unused=True, materialize_grads=True,
    )
    grads = dict(zip(GROUPS, g[:-1]))
    grads["f_rest"] = grads["f_rest"] * sh_mask[None]
    return loss.detach(), aux, grads, g[-1]


def select_state(ovf: torch.Tensor, new: TrainState,
                 old: TrainState) -> TrainState:
    """``old`` where the device bool ``ovf`` is set, else ``new``: an update
    computed from a truncated pair list is never committed."""
    keep = lambda n, o: torch.where(ovf, o, n)
    pdict, old_p = new.params.param_dict(), old.params.param_dict()
    return TrainState(
        params=GaussianParams.from_param_dict(
            {k: keep(pdict[k], old_p[k]) for k in pdict}, old.params.alive),
        adam=AdamState(
            count=keep(new.adam.count, old.adam.count),
            mu={k: keep(new.adam.mu[k], old.adam.mu[k]) for k in pdict},
            nu={k: keep(new.adam.nu[k], old.adam.nu[k]) for k in pdict},
        ),
        stats=DensifyStats(
            grad_accum=keep(new.stats.grad_accum, old.stats.grad_accum),
            denom=keep(new.stats.denom, old.stats.denom),
            max_radii2d=keep(new.stats.max_radii2d, old.stats.max_radii2d),
        ),
        step=keep(new.step, old.step),
    )


@torch.no_grad()
def apply_update(state: TrainState, grads: dict, g2d, radii, ovf,
                 cfg: GSConfig, extent: float) -> TrainState:
    """Adam on every group, the densification statistics and the step
    count, selected away on the device when ``ovf`` is set."""
    it = state.step + 1
    pdict = state.params.param_dict()
    lrs = learning_rates(cfg, extent, it - 1)
    new_p, adam = adam_update(pdict, grads, state.adam, lrs)
    new = TrainState(
        params=GaussianParams.from_param_dict(new_p, state.params.alive),
        adam=adam,
        stats=add_densification_stats(state.stats, g2d, radii),
        step=it,
    )
    return select_state(ovf, new, state)


class _HostFlag:
    """A device bool that the host reads later without a sync in between:
    a pinned host copy recorded behind a CUDA event."""

    def __init__(self, flag: torch.Tensor):
        if flag.is_cuda:
            self.value = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.value.copy_(flag, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.value, self.event = flag, None

    def read(self) -> bool:
        if self.event is not None:
            self.event.synchronize()
        return bool(self.value)


class Trainer:
    """Drives a TrainState through cfg.iterations steps over a list of views.

    views: list of (Camera, image (3,H,W)[, depth (H,W)]) or objects with
    .camera/.image[/.depth].  ``device=None`` means the CUDA device, and
    the state is moved there; ``backend`` is render_tiled's.
    """

    def __init__(
        self,
        params: GaussianParams,
        cfg: GSConfig,
        cameras_extent: float,
        pair_cap: int | None = None,
        backend: str = "cuda",
        chunk: int = 384,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.extent = float(cameras_extent)
        self.backend = backend
        self.chunk = chunk
        self.pair_cap = pair_cap
        self.max_sh_degree = params.max_sh_degree
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
            device=self.device,
        )
        params = GaussianParams.from_param_dict(
            {k: v.to(self.device) for k, v in params.param_dict().items()},
            params.alive.to(self.device),
        )
        self.state = TrainState(
            params=params,
            adam=adam_init(params.param_dict()),
            stats=DensifyStats.zero(params.capacity, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self.py_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.last_overflow = False

    # ---- one step ----

    def _render_loss(self, params, mean2d_offset, camera, gt_image, gt_depth):
        out = render_tiled(
            params, camera, self.bg, active_sh_degree=self.max_sh_degree,
            chunk=self.chunk, pair_cap=self.pair_cap, backend=self.backend,
            mean2d_offset=mean2d_offset,
        )
        loss = view_loss(out["render"], gt_image, out["depth"], gt_depth,
                         self.cfg)
        aux = {"radii": out["radii"], "overflow": out["overflow"]}
        return loss, aux

    def _loss_and_grads(self, state: TrainState, camera: Camera, gt_image,
                        gt_depth):
        """(loss, aux, grads by group name, dL/d mean2d_offset)."""
        return loss_and_grads(
            state, lambda p, off: self._render_loss(p, off, camera, gt_image,
                                                    gt_depth))

    def _step(self, state: TrainState, camera: Camera, gt_image, gt_depth):
        loss, aux, grads, g2d = self._loss_and_grads(state, camera, gt_image,
                                                     gt_depth)
        new_state = apply_update(state, grads, g2d, aux["radii"],
                                 aux["overflow"], self.cfg, self.extent)
        return new_state, loss, aux["overflow"]

    def _densify(self, state: TrainState, max_screen_size):
        params, adam, stats, ovf = densify_and_prune(
            state.params, state.adam, state.stats,
            grad_threshold=self.cfg.densify_grad_threshold,
            min_opacity=0.005,
            extent=self.extent,
            max_screen_size=max_screen_size,
            percent_dense=self.cfg.percent_dense,
            generator=self.generator,
        )
        return TrainState(params, adam, stats, state.step), ovf

    def _opacity_reset(self, state: TrainState):
        params, adam = reset_opacity(state.params, state.adam)
        return TrainState(params, adam, state.stats, state.step)

    # ---- host loop ----

    def _grow_pair_cap(self):
        if self.pair_cap is None:
            self.pair_cap = default_pair_capacity(self.state.params.capacity)
        self.pair_cap *= 2
        self.last_overflow = True
        self._cap_gen += 1

    def _views(self, views):
        dev = self.device
        f32 = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                        else x, dtype=torch.float32, device=dev)
        norm = []
        for v in views:
            if hasattr(v, "camera"):
                cam, img, depth = v.camera, v.image, getattr(v, "depth", None)
            else:
                cam, img = v[0], v[1]
                depth = v[2] if len(v) > 2 else None
            norm.append((cam.to(dev), f32(img),
                         None if depth is None else f32(depth)))
        return norm

    def _sample(self, norm):
        """The next step's view: (camera, image, depth or None)."""
        return norm[self.py_rng.integers(len(norm))]

    def run(self, views, iterations: int | None = None, callback=None,
            log_every: int = 0, timer=None):
        """Train for ``iterations`` (default cfg.iterations) committed steps.

        ``callback(it, state, loss)`` gets ``loss`` as a device scalar;
        reading it every step would sync the host on each step.
        ``log_every`` > 0 prints loss, alive count and pair budget.
        ``timer``, a ``utils.profiling.PhaseTimer``, gets each step's host
        time (the launch, not the device's work) as phase "train_step".
        With ``cfg.debug`` a non-finite loss raises, after an npz snapshot
        of the parameters, image and view under ``debug_snapshots/`` where
        they hold a NaN or inf.
        """
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        norm = self._views(views)

        self._cap_gen = 0
        pending = None               # (_HostFlag of a step's overflow, cap_gen)
        it = 0
        launched = 0                 # steps assumed committed (optimistic)
        while launched < iterations:
            it += 1
            launched += 1
            view = self._sample(norm)
            with (timer.phase("train_step") if timer is not None
                  else contextlib.nullcontext()):
                self.state, loss, ovf = self._step(self.state, *view)

            # the PREVIOUS step's overflow flag (one-step lag): an overflowed
            # step changed nothing, so un-count it; only the first flag of a
            # capacity generation doubles the budget
            if pending is not None:
                p_flag, p_gen = pending
                if p_flag.read():
                    launched -= 1
                    if p_gen == self._cap_gen:
                        self._grow_pair_cap()
            pending = (_HostFlag(ovf), self._cap_gen)

            if cfg.debug and not bool(torch.isfinite(loss)):
                check_finite(
                    {"params": self.state.params.param_dict(), "gt": view[1],
                     "camera": view[0]},
                    outdir="debug_snapshots", tag=f"train_it{it}",
                )
                raise FloatingPointError(f"non-finite loss at iteration {it}")

            if log_every and it % log_every == 0:
                print(
                    f"[bake] it {it:5d}  loss {float(loss):.4f}  gaussians "
                    f"{int(self.state.params.num_alive)}  pair_cap {self.pair_cap}",
                    flush=True,
                )

            if it < cfg.densify_until_iter:
                if (it > cfg.densify_from_iter
                        and it % cfg.densification_interval == 0):
                    size_thr = 20 if it > cfg.opacity_reset_interval else None
                    self.state, dovf = self._densify(self.state, size_thr)
                    if bool(dovf):
                        self.last_overflow = True
                if it % cfg.opacity_reset_interval == 0 or (
                    cfg.white_background and it == cfg.densify_from_iter
                ):
                    self.state = self._opacity_reset(self.state)

            if callback is not None:
                callback(it, self.state, loss)

        # the trailing flag: if the final step overflowed it changed nothing,
        # so grow and run again until a clean update lands
        while pending is not None:
            p_flag, p_gen = pending
            pending = None
            if p_flag.read():
                if p_gen == self._cap_gen:
                    self._grow_pair_cap()
                self.state, loss, ovf = self._step(self.state,
                                                   *self._sample(norm))
                pending = (_HostFlag(ovf), self._cap_gen)
        return self.state
