"""Rays/s of one forward+backward render step at 1M Gaussians and 512x512
on one NVIDIA GPU, the twin of ``bench.py``: the same scene, loss, pair
budget, chunk and K-step protocol, through ``render_tiled`` with the CUDA
kernels K1 (forward blend), K2 (its backward) and K3 (the cotangent
repack).

Run on the card: ``python -m luciddreamer_tpu_torch.bench``.  The last line
printed is one JSON object with ``bench.py``'s keys, ``{"metric", "value",
"unit", "vs_baseline"}``; the lines before it give the step's ms on the
device (CUDA events) beside the host's wall ms, the live pairs against the
budget, the peak device memory of a step and the kernels' launches per
step.

Protocol (``bench.py``): one step whose scalar, the sum of every gradient,
feeds the next step through ``xyz + s * 1e-30``; K steps enqueued back to
back with one host read at the end (the render reads no count on the
host, so nothing syncs inside a step); per-step time (t_K2 - t_K1) /
(K2 - K1), best of ``reps`` each, on the host's clock: the host paces a
step, so this is what a training loop sees.  The device's own ms per step
(``steady``) is printed beside it.  A warm-up step first builds the
kernels, and must not overflow the pair budget: a truncated pair list
would drop work and inflate rays/s.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.render import cuda_blend, cuda_repack
from luciddreamer_tpu_torch.render.tiled import aligned_pair_capacity, render_tiled

METRIC = "rays_per_s_fwd_bwd_1M_gaussians_512px"
# The port's first measurement of this step: 11,631,901.1 rays/s (22.54 ms
# a step by host wall) on an "NVIDIA H100 80GB HBM3, 700.00 W" card (as
# nvidia-smi --query-gpu=name,power.limit --format=csv,noheader gives it).
# vs_baseline tracks improvement over this anchor.
ANCHOR_RAYS_PER_S = 11_631_901.1
FOV = 0.8279                   # the camera's horizontal and vertical fov, rad


def bench_scene(P: int, seed: int = 42, device=None) -> GaussianParams:
    """``bench.py``'s scene, the same numpy draws in the same order: a
    Gaussian blob 3 units ahead of the origin camera, SH degree 3,
    log-scales in [-5.5, -3.5], every row alive."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return GaussianParams(
        xyz=f32(rng.normal(size=(P, 3)) + [0, 0, 3.0]),
        features_dc=f32(rng.normal(size=(P, 1, 3)) * 0.5),
        features_rest=f32(rng.normal(size=(P, 15, 3)) * 0.1),
        scaling=f32(rng.uniform(-5.5, -3.5, size=(P, 3))),
        rotation=f32(rng.normal(size=(P, 4))),
        opacity=f32(rng.uniform(-2.0, 3.0, size=(P, 1))),
        alive=torch.ones(P, dtype=torch.bool, device=dev),
    )


def bench_loss(out: dict) -> torch.Tensor:
    """``bench.py``'s loss: mean |render - 0.5| + 0.1 * mean depth."""
    return (out["render"] - 0.5).abs().mean() + 0.1 * out["depth"].mean()


def fwd_bwd(params: GaussianParams, camera, bg, pair_cap: int, chunk: int):
    """The bench step, ``s -> (the sum of every gradient, the gradients by
    group, render_tiled's output)`` of ``bench_loss`` at the parameters
    with ``xyz + s * 1e-30``."""
    pd, alive = params.param_dict(), params.alive

    def step(s):
        p = GaussianParams.from_param_dict(dict(pd, xyz=pd["xyz"] + s * 1e-30),
                                           alive)
        out = render_tiled(p, camera, bg, active_sh_degree=3, chunk=chunk,
                           pair_cap=pair_cap, backend="cuda")
        grads = dict(zip(pd, torch.autograd.grad(bench_loss(out),
                                                 list(p.parameters()))))
        return torch.stack([g.sum() for g in grads.values()]).sum(), grads, out

    return step


def launch_counts() -> dict:
    """The launches K1-K3's wrappers have counted in this process."""
    return {"blend_fwd": cuda_blend.blend_fwd.launches,
            "blend_bwd": cuda_blend.blend_bwd.launches,
            "repack_cols": cuda_repack.repack_cols.launches}


def steady(fn, device, k1: int, k2: int, reps: int) -> dict:
    """Per-step ms of ``s -> fn(s)`` chained on a scalar ``s``, after one
    warm-up call.  ``wall_ms``: the K-step protocol on the host's clock, K
    calls and one read of ``s``, (best of K2 - best of K1) / (K2 - K1).
    ``device_ms`` (on the card, else None): the median over ``reps * k2``
    calls of CUDA events around one call, each enqueued behind a
    device-side sleep longer than its enqueue, so that the events time the
    device's own work and never a wait for the host.  Runs ``1 + reps *
    (k1 + k2)`` calls, and ``reps * k2`` more on the card."""
    zero = torch.zeros((), device=device)

    def wall(k):
        t0 = time.perf_counter()
        s = zero
        for _ in range(k):
            s = fn(s)
        float(s)
        return (time.perf_counter() - t0) * 1e3

    float(fn(zero))
    best = lambda k: min(wall(k) for _ in range(reps))
    wall_ms = (best(k2) - best(k1)) / (k2 - k1)
    if device.type != "cuda":
        return {"wall_ms": wall_ms, "device_ms": None}
    pairs, s = [], zero
    for _ in range(reps * k2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e6 * (2 * wall_ms + 5)))   # ~2e6 cycles a ms
        start.record()
        s = fn(s)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    device_ms = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    return {"wall_ms": wall_ms, "device_ms": device_ms}


def run(P: int = 1_000_000, size: int = 512, pair_cap: int = 3_000_000,
        chunk: int = 384, k1: int = 1, k2: int = 10, reps: int = 3,
        device=None) -> dict:
    """Benchmark the step at ``bench.py``'s shape on ``device`` (None: the
    CUDA device; raises without one), print its lines, the JSON line last,
    and return what was printed as a dict."""
    dev = resolve_device(device)
    params = bench_scene(P, device=dev)
    cam = make_camera(np.eye(4), FOV, FOV, size, size, device=dev)
    bg = torch.zeros(3, device=dev)
    step = fwd_bwd(params, cam, bg, pair_cap, chunk)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    _, _, out = step(torch.zeros((), device=dev))     # builds the kernels
    overflow, pairs = bool(out["overflow"]), int(out["num_pairs"])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del out
    if overflow:
        raise RuntimeError(f"pair_cap {pair_cap} overflowed ({pairs} pairs); "
                           "benchmark invalid")

    before = launch_counts()
    t = steady(lambda s: step(s)[0], dev, k1, k2, reps)
    n_steps = 1 + reps * (k1 + k2) + (reps * k2 if cuda else 0)
    per_step = {k: (v - before[k]) / n_steps for k, v in launch_counts().items()}
    rays = size * size / (t["wall_ms"] / 1e3)
    slots = aligned_pair_capacity(pair_cap, chunk)
    print(f"[bench] {name}: P={P} {size}x{size} chunk={chunk} pair_cap="
          f"{pair_cap} ({slots} slots); K-step protocol K1={k1} K2={k2}, best "
          f"of {reps}")
    print(f"[bench] live pairs {pairs} of pair_cap {pair_cap} "
          f"({pairs / pair_cap:.4f}), no overflow")
    dev_ms = ("not measured" if t["device_ms"] is None
              else f"{t['device_ms']:.4f}")
    print(f"[bench] ms per step: host wall {t['wall_ms']:.4f} (K-step "
          f"protocol), device {dev_ms} (CUDA events, median of {reps * k2} "
          "steps each enqueued ahead)")
    print("[bench] peak device memory of a step: " + (
        "not measured" if peak is None else
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before)"))
    print(f"[bench] launches per step: {per_step}")
    line = {
        "metric": METRIC,
        "value": round(rays, 1),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays / ANCHOR_RAYS_PER_S, 3),
    }
    print(json.dumps(line))
    return dict(line, device=name, wall_ms=t["wall_ms"],
                device_ms=t["device_ms"], num_pairs=pairs, pair_slots=slots,
                peak_bytes=peak, launches_per_step=per_step)


def main():
    run()


if __name__ == "__main__":
    main()
