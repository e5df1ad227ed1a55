"""The port's hardware gate on one NVIDIA GPU, the twin of
``tools/tpu_smoke.py``, and BASELINE config 1, the twin of
``tests/test_baseline_config1.py``: each drive runs the tiled render with
the CUDA kernels K1-K3 and returns what it measured, with ``misses``, the
checks it failed (empty when it passed).

  * ``baseline_config1``: 10k Gaussians (seed 3) at 512x512, pair_cap
    300,000, chunk 128; the tiled render against the dense oracle on
    render (atol 1e-5) and depth (atol 5e-4), and on every parameter
    group's gradient of mean |render - target| + 0.1 * mean depth: more
    than 99.99% of elements within 5e-3 of the group's max |dense|, every
    element within 5e-2, all finite.
  * ``drive_20k``: 20k Gaussians (seed 7) at 512x512, pair_cap 400,000,
    chunk 128: forward without overflow, finite gradients, the 64x64 crop
    [224:288] within 1e-5 of the dense oracle.
  * ``bench_shape``: the bench scene at pair_cap 4,000,000 (not a multiple
    of 1024), chunk 128: forward and backward without overflow, finite
    gradients.
  * ``graft_entry``: ``entry()``'s ``fn`` on the device against the same
    ``fn`` on CPU copies of its arguments: render within 1e-5, depth within
    5e-4.

Run on the card: ``python -m luciddreamer_tpu_torch.smoke``; it exits
non-zero when a drive misses.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from luciddreamer_tpu_torch.bench import FOV, bench_scene, fwd_bwd
from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.entry import entry
from luciddreamer_tpu_torch.render.dense import render_dense
from luciddreamer_tpu_torch.render.tiled import render_tiled

SIZE = 512
CONFIG1 = {"P": 10_000, "seed": 3, "pair_cap": 300_000, "chunk": 128}
CONFIG1_RENDER_ATOL, CONFIG1_DEPTH_ATOL = 1e-5, 5e-4
CONFIG1_GRAD_BULK, CONFIG1_GRAD_SHARE, CONFIG1_GRAD_MAX = 5e-3, 0.9999, 5e-2
DRIVE_20K = {"P": 20_000, "seed": 7, "pair_cap": 400_000, "chunk": 128}
CROP = slice(224, 288)
CROP_ATOL = 1e-5
BENCH_SHAPE = {"P": 1_000_000, "seed": 42, "pair_cap": 4_000_000, "chunk": 128}
ENTRY_RENDER_ATOL, ENTRY_DEPTH_ATOL = 1e-5, 5e-4


def config1_scene(rng: np.random.Generator, P: int, device) -> GaussianParams:
    """``tests/test_baseline_config1.py::_scene``: the bench scene's blob
    with log-scales in [-5, -3], drawn from ``rng``."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return GaussianParams(
        xyz=f32(rng.normal(size=(P, 3)) + [0, 0, 3.0]),
        features_dc=f32(rng.normal(size=(P, 1, 3)) * 0.5),
        features_rest=f32(rng.normal(size=(P, 15, 3)) * 0.1),
        scaling=f32(rng.uniform(-5.0, -3.0, size=(P, 3))),
        rotation=f32(rng.normal(size=(P, 4))),
        opacity=f32(rng.uniform(-2.0, 3.0, size=(P, 1))),
        alive=torch.ones(P, dtype=torch.bool, device=device),
    )


def _camera(device):
    return make_camera(np.eye(4), FOV, FOV, SIZE, SIZE, device=device)


def _max_abs(a, b) -> float:
    return float((a - b).detach().abs().max())


def _grads(params, render, loss):
    """(render's output, d loss(output) / d each group) at ``params``."""
    p = GaussianParams.from_param_dict(params.param_dict(), params.alive)
    out = render(p)
    g = torch.autograd.grad(loss(out), list(p.parameters()))
    return out, dict(zip(params.param_dict(), g))


def baseline_config1(device=None) -> dict:
    """BASELINE config 1: the tiled render (K1; K2 and K3 in its backward)
    against the dense oracle, outputs and gradients, at
    ``tests/test_baseline_config1.py``'s scene and tolerances."""
    dev = resolve_device(device)
    rng = np.random.default_rng(CONFIG1["seed"])
    params = config1_scene(rng, CONFIG1["P"], dev)
    cam = _camera(dev)
    bg = torch.zeros(3, device=dev)
    tgt = torch.as_tensor(rng.uniform(size=(3, SIZE, SIZE)).astype(np.float32),
                          device=dev)
    loss = lambda out: ((out["render"] - tgt).abs().mean()
                        + 0.1 * out["depth"].mean())
    t0 = time.perf_counter()
    t_out, g_t = _grads(params, lambda p: render_tiled(
        p, cam, bg, pair_cap=CONFIG1["pair_cap"], chunk=CONFIG1["chunk"],
        backend="cuda"), loss)
    t1 = time.perf_counter()
    d_out, g_d = _grads(params, lambda p: render_dense(p, cam, bg), loss)
    t2 = time.perf_counter()
    res = {"num_pairs": int(t_out["num_pairs"]),
           "overflow": bool(t_out["overflow"]),
           "render": _max_abs(t_out["render"], d_out["render"]),
           "depth": _max_abs(t_out["depth"], d_out["depth"]),
           "tiled_s": t1 - t0, "dense_s": t2 - t1, "groups": {}}
    misses = []
    if res["overflow"]:
        misses.append("the tiled render overflowed its pair budget")
    if not res["render"] <= CONFIG1_RENDER_ATOL:
        misses.append(f"render max |d| {res['render']:.3e}")
    if not res["depth"] <= CONFIG1_DEPTH_ATOL:
        misses.append(f"depth max |d| {res['depth']:.3e}")
    for k, b in g_d.items():
        a = g_t[k]
        err = (a - b).abs() / (b.abs().max() + 1e-12)
        share = float((err <= CONFIG1_GRAD_BULK).double().mean())
        worst = float(err.max())
        finite = bool(torch.isfinite(a).all())
        res["groups"][k] = {"share": share, "max_err": worst, "finite": finite}
        if not (finite and share > CONFIG1_GRAD_SHARE
                and worst < CONFIG1_GRAD_MAX):
            misses.append(f"{k} gradient: finite {finite}, share within "
                          f"{CONFIG1_GRAD_BULK} {share:.6f}, max {worst:.3e}")
    res["misses"] = misses
    return res


def _finite_fwd_bwd(params, cam, bg, pair_cap, chunk):
    """(finite-gradient and overflow record, render_tiled's output) of one
    bench step."""
    _, grads, out = fwd_bwd(params, cam, bg, pair_cap, chunk)(
        torch.zeros((), device=cam.campos.device))
    res = {"num_pairs": int(out["num_pairs"]), "overflow": bool(out["overflow"]),
           "finite": {k: bool(torch.isfinite(g).all()) for k, g in grads.items()}}
    res["misses"] = (["pair overflow"] if res["overflow"] else []) + [
        f"non-finite gradient in {k}" for k, ok in res["finite"].items() if not ok]
    return res, out


def drive_20k(device=None) -> dict:
    """``tools/tpu_smoke.py::drive_20k``: forward and backward without
    overflow and with finite gradients, and the crop against the dense
    oracle."""
    dev = resolve_device(device)
    c = DRIVE_20K
    params = bench_scene(c["P"], seed=c["seed"], device=dev)
    cam = _camera(dev)
    bg = torch.zeros(3, device=dev)
    res, out = _finite_fwd_bwd(params, cam, bg, c["pair_cap"], c["chunk"])
    with torch.no_grad():
        dense = render_dense(params, cam, bg)
    res["crop"] = _max_abs(out["render"][:, CROP, CROP],
                           dense["render"][:, CROP, CROP])
    if not res["crop"] <= CROP_ATOL:
        res["misses"].append(f"64x64 crop against the dense oracle: max |d| "
                             f"{res['crop']:.3e}")
    return res


def bench_shape(device=None) -> dict:
    """``tools/tpu_smoke.py::bench_shape``: one forward and backward of the
    bench scene at a pair budget that is not a multiple of 1024."""
    dev = resolve_device(device)
    c = BENCH_SHAPE
    params = bench_scene(c["P"], seed=c["seed"], device=dev)
    res, _ = _finite_fwd_bwd(params, _camera(dev),
                             torch.zeros(3, device=dev), c["pair_cap"],
                             c["chunk"])
    return res


def graft_entry(device=None) -> dict:
    """``entry()``'s ``fn`` on ``device`` against the same ``fn`` on CPU
    copies of its arguments."""
    fn, (params, camera, bg) = entry(device)
    cpu = (GaussianParams.from_param_dict(
        {k: v.cpu() for k, v in params.param_dict().items()}, params.alive.cpu()),
        camera.to("cpu"), bg.cpu())
    with torch.no_grad():
        render, depth = fn(params, camera, bg)
        ref_render, ref_depth = fn(*cpu)
    res = {"shape": tuple(render.shape),
           "render": _max_abs(render.cpu(), ref_render),
           "depth": _max_abs(depth.cpu(), ref_depth)}
    res["misses"] = [
        f"{k} max |d| {res[k]:.3e} against the CPU"
        for k, atol in (("render", ENTRY_RENDER_ATOL), ("depth", ENTRY_DEPTH_ATOL))
        if not res[k] <= atol]
    return res


def main() -> int:
    resolve_device(None)
    failed = False
    for drive in (drive_20k, bench_shape, graft_entry, baseline_config1):
        t0 = time.perf_counter()
        res = drive()
        print(f"[{drive.__name__}] {time.perf_counter() - t0:.1f} s: {res}")
        failed |= bool(res["misses"])
    print("SMOKE: FAILED" if failed else "SMOKE: ALL GREEN")
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())
