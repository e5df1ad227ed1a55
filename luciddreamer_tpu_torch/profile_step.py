"""Stage split of the bench step on one NVIDIA GPU, the twin of
``tools/profile_step.py``: four cumulative prefixes of the step, each timed
as the bench times its step (``bench.steady``: host wall by the K-step
protocol, K1=2, K2=12, best of 3, and the device's ms by CUDA events), so
that stage i less stage i-1 is what stage i adds:

  1. preprocess (forward);
  2. preprocess and binning (forward): the attribute table read through
     the sort's owner index ``src``, plus the pair count;
  3. the whole forward render (K1);
  4. the whole forward and backward, the bench step (K1, K2, K3).

Stages 1-3 run without autograd.  Run on the card:
``python -m luciddreamer_tpu_torch.profile_step [P] [pair_cap] [chunk]``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from luciddreamer_tpu_torch.bench import FOV, bench_scene, fwd_bwd, steady
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.render.binning import build_tile_bins
from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
from luciddreamer_tpu_torch.render.tiled import aligned_pair_capacity, render_tiled

TILE = 16


def stages(params: GaussianParams, camera, bg, pair_cap: int, chunk: int):
    """[(name, s -> scalar)] of the four cumulative stages."""
    pd, alive = params.param_dict(), params.alive
    H, W = camera.height, camera.width
    slots = aligned_pair_capacity(pair_cap, chunk)

    def p_of(s):
        return GaussianParams.from_param_dict(
            dict(pd, xyz=pd["xyz"] + s * 1e-30), alive)

    @torch.no_grad()
    def preproc(s):
        pr = preprocess_gaussians(p_of(s), camera, 3, TILE)
        return pr.mean2d.sum() + pr.depth.sum()

    @torch.no_grad()
    def prep_bin(s):
        pr = preprocess_gaussians(p_of(s), camera, 3, TILE)
        bins = build_tile_bins(pr, H, W, TILE, slots)
        return bins.table[:, 0][bins.src].sum() + bins.num_pairs.float()

    @torch.no_grad()
    def fwd(s):
        out = render_tiled(p_of(s), camera, bg, chunk=chunk, pair_cap=pair_cap,
                           backend="cuda")
        return out["render"].sum() + out["depth"].sum()

    step = fwd_bwd(params, camera, bg, pair_cap, chunk)
    return [("preprocess fwd", preproc), ("prep+binning fwd", prep_bin),
            ("full fwd", fwd), ("full fwd+bwd", lambda s: step(s)[0])]


def run(P: int = 1_000_000, pair_cap: int = 3_000_000, chunk: int = 384,
        size: int = 512, k1: int = 2, k2: int = 12, reps: int = 3,
        device=None) -> list:
    """Time the four stages on ``device`` (None: the CUDA device; raises
    without one), print one line each, and return them as
    [{"stage", "wall_ms", "device_ms"}] (device ms None off the card)."""
    dev = resolve_device(device)
    params = bench_scene(P, device=dev)
    cam = make_camera(np.eye(4), FOV, FOV, size, size, device=dev)
    bg = torch.zeros(3, device=dev)
    print(f"[profile] P={P} pair_cap={pair_cap} {size}x{size} chunk={chunk} "
          f"on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f"; per-step ms by host wall and by CUDA events (+ over the stage "
          "before)")
    rows, prev = [], {"wall_ms": 0.0, "device_ms": 0.0}
    for name, fn in stages(params, cam, bg, pair_cap, chunk):
        t = steady(fn, dev, k1, k2, reps)
        ev = ("not measured" if t["device_ms"] is None else
              f"{t['device_ms']:9.4f} ms (+{t['device_ms'] - prev['device_ms']:8.4f})")
        print(f"[profile] {name:18s} wall {t['wall_ms']:9.4f} ms "
              f"(+{t['wall_ms'] - prev['wall_ms']:8.4f})   events {ev}")
        rows.append(dict(t, stage=name))
        prev = {k: v or 0.0 for k, v in t.items()}
    return rows


def main(argv=None):
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    run(*args)


if __name__ == "__main__":
    main()
