#!/usr/bin/env python3
"""The port's multi-device path in one world of N processes, one card each,
held against one card: what ``chip_smoke.py`` (one card, a world of one)
cannot run.  Launch it with torchrun, which sets the variables that
``luciddreamer_tpu_torch.parallel.multihost.initialize`` reads:

    torchrun --standalone --nproc-per-node=4 tools/nccl_world.py
    torchrun --standalone --nproc-per-node=4 tools/nccl_world.py \\
        --device cpu --points 3000 --capacity 3600 --size 64 --zoe tiny

The second line rehearses it on the CPU with gloo at a small size.  On the
cards every rank builds the same scene as ``chip_smoke.py`` phase 7 (1M
live Gaussians in a capacity of 1.2M, 512x512, its 4 llff targets) and
runs, with N ranks (the (2, N/2) cases need an even N):

1. ``render_sharded`` on a (1, N) mesh against ``render_tiled`` on its own
   card: render, depth and acc within 1e-5, radii equal, no overflow;
2. the gradient of a seeded weighted sum of that render, summed over the
   world, against the one-card gradient: each group within 5e-4 of its
   max;
3. ``ring_all_reduce`` of 1,000,003 floats per rank over the world: the
   same bits on every rank, within 1e-5 of each element's scale of a plain
   sum;
4. ``sharded_train_step_batch`` on a (2, N/2) mesh with two cameras and the
   depth term against the same step on one card (both views rendered
   whole, ``train.loop``'s pieces): loss within 1e-5 relative, Adam's first
   moments (0.1 x the gradient) within 5e-4 of each group's max, the new
   parameters within 1e-6 where the gradient exceeds 1e-3 of its group's
   max; then ``sharded_train_step_overlapped`` on that mesh against the
   batch step at the same limits (it sums each band's loss share in
   another order; the share of each group's entries whose update differs
   by more than 0.05 of its learning rate is printed);
5. ``ShardedTrainer`` on a (1, N) mesh for 20 iterations (a densify at 20)
   against ``Trainer`` on one card with the same seed, budget and chunk:
   the same step count, xyz within 0.05 of the xyz learning rate on all
   but 0.1% of entries, the alive masks' difference counted; the trained
   xyz and alive mask the same bits on every rank;
6. ``DepthTrainer`` with ``mesh=make_mesh(data=N)`` for 3 steps on a batch
   of N against the same batch on one card (ZoeD_N at its published
   geometry, random weights): losses within 1e-4 relative, parameters
   within 0.05 of the learning rate on all but 0.1% of entries;
7. times on rank 0 (device ms by CUDA events, host wall ms): a (1, N)
   step, batch and overlapped, and an (N, 1) step against a ``Trainer``
   step, and a data-parallel ZoeD_N step against the same batch on one
   card.

Rank 0 prints a line per check, the card's name and power limit, and the
times; the command exits non-zero when a check fails on any rank.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the scenes, timing and check helpers)
from luciddreamer_tpu_torch.app import LucidDreamerTPU  # noqa: E402
from luciddreamer_tpu_torch.config import CameraConfig, GSConfig  # noqa: E402
from luciddreamer_tpu_torch.model.gaussians import DensifyStats  # noqa: E402
from luciddreamer_tpu_torch.model.optim import GROUPS, adam_init  # noqa: E402
from luciddreamer_tpu_torch.models.depth_trainer import DepthTrainer  # noqa: E402
from luciddreamer_tpu_torch.models.zoedepth import ZoeDepthConfig  # noqa: E402
from luciddreamer_tpu_torch.parallel import (  # noqa: E402
    ShardedTrainer, make_mesh, multihost, render_sharded, ring_all_reduce,
    sharded_train_step_batch, sharded_train_step_overlapped,
)
from luciddreamer_tpu_torch.parallel.sharded import all_reduce_flat  # noqa: E402
from luciddreamer_tpu_torch.render.tiled import render_tiled  # noqa: E402
from luciddreamer_tpu_torch.train.loop import (  # noqa: E402
    Trainer, TrainState, apply_update, loss_and_grads, view_loss,
)

CHUNK = 128
TRAIN_ITERS = 20


class World:
    """This rank's place and its failures; rank 0 prints."""

    def __init__(self, dev):
        self.rank, self.n, self.dev = dist.get_rank(), dist.get_world_size(), dev
        self.failed = []

    def say(self, msg):
        if self.rank == 0:
            print(msg, flush=True)

    def check(self, ok, msg):
        if not ok:
            self.failed.append(msg)
            print(f"[rank {self.rank}] FAILED: {msg}", flush=True)

    def same_everywhere(self, t: torch.Tensor) -> bool:
        """Whether ``t`` holds the same bits on every rank."""
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t.contiguous())
        return all(torch.equal(p, parts[0]) for p in parts)


def fresh_state(params):
    p = chip_smoke.clone_params(params)
    return TrainState(p, adam_init(p.param_dict()),
                      DensifyStats.zero(p.capacity, device=p.xyz.device),
                      torch.zeros((), dtype=torch.int32, device=p.xyz.device))


def one_card_batch_step(state, cams, gt, gtd, bg, cfg, extent):
    """``sharded_train_step_batch``'s step on one card: every view rendered
    whole, the batch's loss, Adam, the statistics and the overflow gate."""
    deg = state.params.max_sh_degree

    def loss_fn(p, offset):
        outs = [render_tiled(p, c, bg, active_sh_degree=deg, chunk=CHUNK,
                             mean2d_offset=offset) for c in cams]
        stack = lambda k: torch.stack([o[k] for o in outs])
        aux = {"radii": stack("radii").amax(0),
               "overflow": stack("overflow").any()}
        return view_loss(stack("render"), gt, stack("depth"), gtd, cfg), aux

    loss, aux, grads, g2d = loss_and_grads(state, loss_fn)
    return apply_update(state, grads, g2d, aux["radii"], aux["overflow"], cfg,
                        extent), loss


def step_errors(new, ref):
    """One Adam step against a reference step from the same state: Adam's
    first moments (0.1 x the gradient) as max |d| / the group's max, and
    the new parameters' max |d| where the reference gradient exceeds 1e-3
    of its group's max (Adam's first step moves every other entry by
    +-lr on the sign of a gradient near zero)."""
    mu_err, p_err = [], []
    for k in GROUPS:
        g = ref.adam.mu[k].abs()
        mu_err.append(round(scaled_err(new.adam.mu[k], ref.adam.mu[k]), 9))
        # a group with no gradient (the masked SH bands) did not move
        big = g > 1e-3 * g.max() if bool(g.max() > 0) else g == 0
        p_err.append(round(float((new.params.param_dict()[k]
                                  - ref.params.param_dict()[k])[big]
                                 .abs().max()), 9))
    return mu_err, p_err


def lr_units(a, b, lr):
    """(share of entries of |a - b| / lr beyond 0.05, its max)."""
    d = (a - b).detach().abs().double() / lr
    return float((d > 0.05).double().mean()), float(d.max())


def scaled_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--points", type=int, default=chip_smoke.P_FULL)
    ap.add_argument("--capacity", type=int, default=chip_smoke.CAPACITY)
    ap.add_argument("--size", type=int, default=chip_smoke.H)
    ap.add_argument("--zoe", default="published", choices=("published", "tiny"))
    args = ap.parse_args()

    if not multihost.initialize(device=args.device):
        print("nccl_world: run it under torchrun with more than one process",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    w = World(dev)
    # an exception ends this rank, and torchrun then ends the others
    run(w, args)
    failed = torch.tensor(len(w.failed), device=dev)
    dist.all_reduce(failed)
    dist.destroy_process_group()
    w.say(f"[world] {w.n} ranks on {dev.type}: "
          + ("every check passed" if int(failed) == 0
             else f"{int(failed)} checks failed"))
    return int(int(failed) != 0)


def run(w: World, args):
    dev, n = w.dev, w.n
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        w.say(f"[world] cards: {smi}; torch {torch.__version__}")
        if w.rank == 0:
            chip_smoke.print_build_report()
        dist.barrier()
    w.say(f"[world] {n} ranks, backend {dist.get_backend()}")
    size = args.size
    cams = LucidDreamerTPU(cam_config=CameraConfig(image_width=size,
                                                   image_height=size),
                           device=dev).preset_cameras("llff")
    start, views = chip_smoke.training_scene(cams, dev, args.points,
                                             args.capacity)
    cam, img = views[0]
    bg = torch.zeros(3, device=dev)

    # ---- 1. the band render on (1, N) ----
    m1n = make_mesh(1, n, device=dev)
    with torch.no_grad():
        out = render_sharded(start, cam, bg, m1n, chunk=CHUNK)
        ref = render_tiled(start, cam, bg, chunk=CHUNK)
    err = {k: float((out[k] - ref[k]).abs().max())
           for k in ("render", "depth", "acc")}
    w.say(f"[world] 1. render_sharded on (1, {n}) against render_tiled: "
          f"max |d| {err}; radii equal {torch.equal(out['radii'], ref['radii'])}")
    w.check(max(err.values()) <= 1e-5 and torch.equal(out["radii"], ref["radii"])
            and not bool(out["overflow"]), "the sharded render disagrees")

    # ---- 2. its gradient ----
    wt = torch.randn((3, size, size), generator=torch.Generator(device=dev)
                     .manual_seed(5), device=dev)
    leaves = list(start.parameters())
    g_sh = all_reduce_flat(list(torch.autograd.grad(torch.sum(
        render_sharded(start, cam, bg, m1n, chunk=CHUNK)["render"] * wt),
        leaves)), m1n.world_group)
    g_one = torch.autograd.grad(torch.sum(
        render_tiled(start, cam, bg, chunk=CHUNK)["render"] * wt), leaves)
    errs = [scaled_err(a, b) for a, b in zip(g_sh, g_one)]
    w.say(f"[world] 2. gradient summed over {n} bands against one card, max "
          f"|d| / group max: {np.round(errs, 9).tolist()}")
    w.check(max(errs) <= 5e-4, "the sharded gradient disagrees")

    # ---- 3. the ring ----
    x = torch.as_tensor(np.random.default_rng(7 + w.rank).normal(
        size=1_000_003).astype(np.float32), device=dev)
    ring = ring_all_reduce(x, m1n.world_group, n)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    total = torch.stack(parts).double().sum(0)
    scale = torch.stack(parts).abs().double().sum(0).clamp_min(1e-30)
    rel = float(((ring.double() - total).abs() / scale).max())
    same = w.same_everywhere(ring)
    w.say(f"[world] 3. ring_all_reduce of {x.numel()} floats: the same bits on "
          f"every rank {same}; max |d| / scale against float64 {rel:.2e}")
    w.check(same and rel <= 1e-5, "the ring disagrees")

    # ---- 4. the batch and overlapped steps on (2, N/2) ----
    if n % 2 == 0:
        m2 = make_mesh(2, n // 2, device=dev)
        cfg = GSConfig(lambda_depth=0.3)
        two = [v[0] for v in views[:2]]
        gt = torch.stack([v[1] for v in views[:2]])
        with torch.no_grad():
            gtd = torch.stack([render_tiled(start, c, bg)["depth"] * 1.1
                               for c in two])
        new, loss, ovf = sharded_train_step_batch(
            fresh_state(start), two, gt, bg, m2, cfg, 2.0, gt_depth_batch=gtd,
            chunk=CHUNK)
        ref, ref_loss = one_card_batch_step(fresh_state(start), two, gt, gtd,
                                            bg, cfg, 2.0)
        mu_err, p_err = step_errors(new, ref)
        w.say(f"[world] 4. batch step on (2, {n // 2}) with depth against one "
              f"card: loss {float(loss):.7f} / {float(ref_loss):.7f}; Adam mu "
              f"max |d| / max {mu_err}; parameters where the gradient is "
              f"large, max |d| {p_err}")
        w.check(not bool(ovf) and abs(float(loss) - float(ref_loss))
                <= 1e-5 * abs(float(ref_loss)) and max(mu_err) <= 5e-4
                and max(p_err) <= 1e-6, "the batch step disagrees")
        ovl, ovl_loss, _ = sharded_train_step_overlapped(
            fresh_state(start), two, gt, bg, m2, cfg, 2.0, chunk=CHUNK,
            gt_depth_batch=gtd)
        mu_err, p_err = step_errors(ovl, new)
        lrs = {"xyz": cfg.position_lr_init * 2.0, "f_dc": cfg.feature_lr,
               "f_rest": cfg.feature_lr / 20, "opacity": cfg.opacity_lr,
               "scaling": cfg.scaling_lr, "rotation": cfg.rotation_lr}
        shares = {k: lr_units(ovl.params.param_dict()[k],
                              new.params.param_dict()[k], lrs[k])
                  for k in GROUPS}
        w.say(f"[world] 4. overlapped step against the batch step: loss "
              f"{float(ovl_loss):.7f}; Adam mu max |d| / max {mu_err}; "
              f"parameters where the gradient is large, max |d| {p_err}; per "
              f"group (share of entries beyond 0.05 lr, max in lr) {shares}")
        w.check(abs(float(ovl_loss) - float(loss)) <= 1e-5 * abs(float(loss))
                and max(mu_err) <= 5e-4 and max(p_err) <= 1e-6,
                "the overlapped step disagrees")
        del new, ref, ovl

    # ---- 5. ShardedTrainer on (1, N) against Trainer ----
    cfg = GSConfig(iterations=TRAIN_ITERS, densify_from_iter=10,
                   densification_interval=10)
    kw = dict(pair_cap=8 * args.capacity, chunk=CHUNK, seed=0)
    tr_one = Trainer(chip_smoke.clone_params(start), cfg, 2.0, device=dev,
                     **kw)
    st_one = tr_one.run(views)
    tr_sh = ShardedTrainer(chip_smoke.clone_params(start), cfg, 2.0, m1n,
                           device=dev, **kw)
    st_sh = tr_sh.run(views)
    share, worst = lr_units(st_sh.params.xyz, st_one.params.xyz,
                            cfg.position_lr_init * 2.0)
    alive_diff = int((st_sh.params.alive != st_one.params.alive).sum())
    same = (w.same_everywhere(st_sh.params.xyz.detach())
            and w.same_everywhere(st_sh.params.alive))
    w.say(f"[world] 5. ShardedTrainer on (1, {n}), {TRAIN_ITERS} iterations, "
          f"against Trainer on one card: steps {int(st_sh.step)} / "
          f"{int(st_one.step)}; xyz beyond 0.05 lr on {share:.2e} of entries, "
          f"at most {worst:.3f} lr; alive {int(st_sh.params.num_alive)} / "
          f"{int(st_one.params.num_alive)}, {alive_diff} differ; the same "
          f"bits on every rank {same}")
    w.check(int(st_sh.step) == int(st_one.step) == TRAIN_ITERS
            and share <= 1e-3 and same, "ShardedTrainer does not track Trainer")

    # ---- 7a. step times ----
    if dev.type == "cuda":
        mn1 = make_mesh(n, 1, device=dev)
        tr_dp = ShardedTrainer(chip_smoke.clone_params(start), cfg, 2.0, mn1,
                               device=dev, **kw)
        tr_ovl = ShardedTrainer(chip_smoke.clone_params(start), cfg, 2.0, m1n,
                                grad_overlap=True, device=dev, **kw)
        step = lambda tr: (lambda: tr._step(tr.state, *tr._sample(
            tr._views(views))))
        for r in range(2):
            t = {name: chip_smoke.timed(step(tr), 5) for name, tr in
                 (("trainer", tr_one), ("tiles", tr_sh), ("overlap", tr_ovl),
                  ("data", tr_dp))}
            w.say(f"[world] 7. round {r}, device ms / host wall ms per step: "
                  f"Trainer (1 view, one card) {t['trainer'][0]:.4f} / "
                  f"{t['trainer'][1]:.4f}; (1, {n}) mesh (1 view) "
                  f"{t['tiles'][0]:.4f} / {t['tiles'][1]:.4f}, overlapped "
                  f"{t['overlap'][0]:.4f} / {t['overlap'][1]:.4f}; ({n}, 1) "
                  f"mesh ({n} views) {t['data'][0]:.4f} / {t['data'][1]:.4f} "
                  f"| {smi[0]}")
        del tr_dp, tr_ovl
    del tr_one, tr_sh, st_one, st_sh
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 6. DepthTrainer, data parallel ----
    zcfg = ZoeDepthConfig() if args.zoe == "published" else ZoeDepthConfig.tiny()
    img_b, dep_b = chip_smoke.depth_batch(zcfg, seed=21)
    reps = -(-n // img_b.shape[0])
    img_b = np.concatenate([img_b] * reps)[:n]
    dep_b = np.concatenate([dep_b] * reps)[:n]
    dp = DepthTrainer(zcfg, seed=chip_smoke.ZOE_SEED,
                      mesh=make_mesh(data=n, device=dev), device=dev)
    one = DepthTrainer(zcfg, seed=chip_smoke.ZOE_SEED, device=dev)
    start_sd = {k: v.clone() for k, v in one.model.state_dict().items()}
    losses = [(dp.train_batch(img_b, dep_b), one.train_batch(img_b, dep_b))
              for _ in range(3)]
    lr = max(one.schedule(i) for i in range(3))
    off = total = 0
    worst = 0.0
    for k, v in one.model.state_dict().items():
        d = ((dp.model.state_dict()[k] - start_sd[k])
             - (v - start_sd[k])).abs().double() / lr
        off += int((d > 0.05).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    rel = max(abs(a - b) / abs(b) for a, b in losses)
    w.say(f"[world] 6. DepthTrainer over {n} data ranks, 3 steps at batch {n}, "
          f"against one card: losses {losses}; updates beyond 0.05 lr on "
          f"{off} of {total} entries, at most {worst:.3f} lr")
    w.check(rel <= 1e-4 and off <= 1e-3 * total,
            "data-parallel depth training disagrees")
    if dev.type == "cuda":
        t_dp = [chip_smoke.timed(lambda: dp.train_batch(img_b, dep_b), 3)
                for _ in range(2)]
        t_one = [chip_smoke.timed(lambda: one.train_batch(img_b, dep_b), 3)
                 for _ in range(2)]
        w.say(f"[world] 7. ZoeD_N training step at batch {n}, device ms / host "
              f"wall ms: {n} data ranks {t_dp}; one card {t_one} | {smi[0]}")


if __name__ == "__main__":
    sys.exit(main())
