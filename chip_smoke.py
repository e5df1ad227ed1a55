#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``luciddreamer_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Set-up: prints the card's name and power limit, builds the forward
   blend kernel K1 (``luciddreamer_tpu_torch/csrc/blend_fwd.cu``) with nvcc
   into ``build/kernels/`` and times the build.
2. K1 against its plain PyTorch version on a 20k-Gaussian 512x512 scene:
   render/final_T/acc atol 1e-5, depth atol 1e-4, n_contrib equal.
3. Main path: builds the 1M-Gaussian, SH-degree-3 scene from seed 42,
   saves it to PLY and loads it back through the port's app class, and
   renders the first 30 frames of the ``llff`` path at 512x512 through
   ``video.render_frames(device="cuda")``.  K1's launch count over that run
   must equal the frame count; the frames must be finite and not blank.
4. K1 against its plain version on frame 0 of the 1M scene: mean |d rgb|
   <= 1e-5, max |d rgb| <= 2e-2, n_contrib equal on >= 99.9% of pixels (the
   kernel multiplies T pair by pair, the plain version by chunk cumprod,
   so a pixel whose T lands on the 1e-4 latch within rounding may stop one
   pair apart).
5. Times per call at that shape, two rounds of 20 calls after a warm-up,
   for preprocess, binning, K1 and the whole frame: device time (CUDA
   events) and host wall time; the plain blend's device time; the frame's
   kernels by device time (torch.profiler); K1's work and bound.

Prints the kernels line and the card line, then the result line last.
Exits non-zero, printing no result, when any phase fails or no CUDA device
is present.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
P_FULL = 1_000_000
P_SMALL = 20_000
N_FRAMES = 30
H = W = 512

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 rate
# and fp32 rate outside the tensor cores.  The special-function rate for
# exp is 16 MUFU ops/clk/SM (Hopper architecture white paper) x 132 SMs x
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# K1 per evaluated (pair, pixel) product: dx, dy and power are 11 FLOPs;
# where power <= 0 one exp and one multiply; a commit adds 1-alpha, T*(..),
# w and five accumulations, 12 FLOPs.  Bytes per pair: the 11 channels read.
FLOPS_EVAL, FLOPS_EXP_PATH, FLOPS_COMMIT = 11, 1, 12
BYTES_PER_PAIR = 11 * 4


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def make_scene(P, seed, device):
    """The bench scene generator: a Gaussian blob 3 units ahead of the
    origin camera, SH degree 3, log-scales in [-5.5, -3.5]."""
    from luciddreamer_tpu_torch.core.types import GaussianParams

    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return GaussianParams(
        xyz=f32(rng.normal(size=(P, 3)) + [0, 0, 3.0]),
        features_dc=f32(rng.normal(size=(P, 1, 3)) * 0.5),
        features_rest=f32(rng.normal(size=(P, 15, 3)) * 0.1),
        scaling=f32(rng.uniform(-5.5, -3.5, size=(P, 3))),
        rotation=f32(rng.normal(size=(P, 4))),
        opacity=f32(rng.uniform(-2.0, 3.0, size=(P, 1))),
        alive=torch.ones(P, dtype=torch.bool, device=device),
    )


def timed(fn, reps):
    """(device ms, host wall ms) per call over ``reps`` back-to-back calls.
    Device: CUDA events around the calls, enqueued behind a device-side
    sleep so that the host's enqueue time is not what is measured.  Wall:
    host clock around the calls and a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (2 * wall_ms * reps + 20)))   # ~2e6 cycles/ms
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, wall_ms


def device_profile(fn, n):
    """torch.profiler over ``n`` calls: device kernel ms and host wall ms
    per call, and the frame's kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3 / n)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda kv: -kv[1])
    return sum(t for _, t in kernels), wall * 1e3 / n, kernels[:8]


def k1_work(bins, grid_x, chunk=128):
    """What K1 must compute on these bins, walked like the plain version:
    per pixel, the products evaluated before its done latch, those with
    power <= 0 (one exp each) and the commits."""
    from luciddreamer_tpu_torch.render import blend_math, torch_blend
    from luciddreamer_tpu_torch.render.binning import (
        A_CA, A_CB, A_CC, A_OP, A_VALID, A_X, A_Y)

    nt = bins.tile_start.shape[0]
    px, py = torch_blend.pixel_coords(nt, grid_x, 16, bins.attrs.device)
    px, py = px[:, None, :], py[:, None, :]
    start = bins.tile_start.long()[:, None]
    end = bins.tile_end.long()[:, None]
    T = torch.ones_like(px[:, 0])
    done = torch.zeros_like(T, dtype=torch.bool)
    n_eval = n_exp = n_commit = 0
    k = torch.arange(chunk, device=px.device)
    for c0 in range(0, int((end - start).max()), chunk):
        rows = start + c0 + k
        live = (rows < end)[..., None]
        a = bins.attrs[torch.where(rows < end, rows, 0)]
        col = lambda i: a[..., i, None]
        alpha, in_ellipse = blend_math.gaussian_alpha(
            col(A_X) - px, col(A_Y) - py, col(A_CA), col(A_CB), col(A_CC),
            col(A_OP))
        valid = (live & (col(A_VALID) > 0.5) & in_ellipse
                 & (alpha >= blend_math.ALPHA_MIN))
        a_eff = torch.where(valid, alpha, 0.0)
        t_after = T[:, None] * torch.cumprod(1.0 - a_eff, dim=1)
        done_after = done[:, None] | (t_after < blend_math.T_MIN)
        done_before = torch.cat([done[:, None], done_after[:, :-1]], dim=1)
        evaluated = live & ~done_before
        n_eval += int(evaluated.sum())
        n_exp += int((evaluated & in_ellipse & (col(A_VALID) > 0.5)).sum())
        commit = valid & ~done_after
        n_commit += int(commit.sum())
        T = T * torch.prod(torch.where(commit, 1.0 - a_eff, 1.0), dim=1)
        done = done_after[:, -1]
    return n_eval, n_exp, n_commit


def main() -> int:
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    # the plain versions run on the card too: full fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from luciddreamer_tpu_torch.app import LucidDreamerTPU
    from luciddreamer_tpu_torch.core.transforms import make_camera
    from luciddreamer_tpu_torch.model.ply import save_ply
    from luciddreamer_tpu_torch.render import cuda_blend, torch_blend
    from luciddreamer_tpu_torch.render.binning import build_tile_bins, num_tiles_for
    from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
    from luciddreamer_tpu_torch.render.tiled import (
        default_pair_capacity, render_tiled)
    from luciddreamer_tpu_torch.video import render_frames

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {torch.cuda.get_device_name(0)} | {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 1. set-up: build K1 ----
    t0 = time.time()
    cuda_blend.build()
    print(f"[build] K1 built in {time.time() - t0:.1f} s "
          f"({cuda_blend.library_path().name})")
    log = cuda_blend.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # ---- 2. K1 against its plain version on the 20k scene ----
    def compare(params, cam, tag):
        with torch.no_grad():
            out = render_tiled(params, cam, bg, chunk=128, backend="cuda")
            ref = render_tiled(params, cam, bg, chunk=128, backend="torch")
        torch.cuda.synchronize()
        if bool(out["overflow"]):
            raise RuntimeError(f"{tag}: pair overflow")
        err = {k: float((out[k] - ref[k]).abs().max())
               for k in ("render", "depth", "acc", "final_T")}
        nc_eq = float((out["n_contrib"] == ref["n_contrib"]).float().mean())
        mean_rgb = float((out["render"] - ref["render"]).abs().mean())
        finite = all(bool(torch.isfinite(out[k]).all())
                     for k in ("render", "depth", "acc", "final_T"))
        print(f"[compare] {tag}: pairs {int(out['num_pairs'])} max|d| "
              + " ".join(f"{k} {v:.3e}" for k, v in err.items())
              + f" mean|d rgb| {mean_rgb:.3e} n_contrib equal {nc_eq:.6f}")
        return out, err, nc_eq, mean_rgb, finite

    bg = torch.zeros(3, device=dev)
    small = make_scene(P_SMALL, seed=7, device=dev)
    cam0 = make_camera(np.eye(4), 0.8279, 0.8279, W, H, device=dev)
    _, err, nc_eq, _, finite = compare(small, cam0, "20k 512x512")
    if not finite or err["render"] > 1e-5 or err["final_T"] > 1e-5 \
            or err["acc"] > 1e-5 or err["depth"] > 1e-4 or nc_eq != 1.0:
        return fail("K1 disagrees with the plain version on the 20k scene")
    del small

    # ---- 3. main path at full size ----
    t0 = time.time()
    scene = make_scene(P_FULL, seed=42, device="cpu")
    app = LucidDreamerTPU(device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "scene.ply")
        save_ply(scene, path)
        app.load_ply(path)
    if app.params.capacity != P_FULL or not app.params.xyz.is_cuda:
        return fail("PLY round trip did not give the 1M scene on the card")
    if not torch.equal(app.params.xyz.cpu(), scene.xyz.detach()):
        return fail("PLY round trip changed the means")
    del scene
    cams = app.preset_cameras("llff")[:N_FRAMES]
    print(f"[main] scene built, saved and loaded in {time.time() - t0:.1f} s")

    torch.cuda.synchronize()
    cuda_blend.blend_tiles.launches = 0
    t0 = time.time()
    rgbs, depths = render_frames(app.params, cams, bg, active_sh_degree=3,
                                 device="cuda")
    torch.cuda.synchronize()
    main_s = time.time() - t0
    k1_launches = cuda_blend.blend_tiles.launches
    print(f"[main] {N_FRAMES} frames in {main_s:.2f} s host time, "
          f"K1 launches {k1_launches}")
    if k1_launches != N_FRAMES:
        return fail(f"K1 launched {k1_launches} times for {N_FRAMES} frames")
    if len(rgbs) != N_FRAMES or rgbs[0].shape != (H, W, 3):
        return fail("render_frames returned the wrong frames")
    covered = [float((d > 0).mean()) for d in depths]
    if not all(np.isfinite(d).all() for d in depths):
        return fail("non-finite depth")
    if min(covered) < 0.05:
        return fail(f"a frame is nearly blank: depth > 0 on {min(covered):.3f}")
    print(f"[main] depth > 0 on {min(covered):.4f}..{max(covered):.4f} of "
          f"pixels; mean rgb {float(np.mean(rgbs)):.2f}/255")

    # ---- 4. K1 against its plain version at the main-path shape ----
    out, err, nc_eq, mean_rgb, finite = compare(app.params, cams[0],
                                                "1M llff frame 0")
    if not finite or mean_rgb > 1e-5 or err["render"] > 2e-2 or nc_eq < 0.999:
        return fail("K1 disagrees with the plain version on the 1M frame")
    acc_share = float((out["acc"] > 0.5).float().mean())
    print(f"[compare] 1M frame 0: acc > 0.5 on {acc_share:.4f} of pixels")
    if acc_share < 0.05:
        return fail("1M frame 0 is nearly blank")
    k1_err = err["render"]

    # ---- 5. times per frame at the main-path shape ----
    params, cam = app.params, cams[0]
    grid_x, _ = num_tiles_for(H, W, 16)
    pair_cap = default_pair_capacity(params.capacity)   # chunk-aligned at 128
    with torch.no_grad():
        proc = preprocess_gaussians(params, cam, 3)
        bins = build_tile_bins(proc, H, W, 16, pair_cap)
        phases = {
            "preprocess": lambda: preprocess_gaussians(params, cam, 3),
            "binning": lambda: build_tile_bins(proc, H, W, 16, pair_cap),
            "k1": lambda: cuda_blend.blend_tiles(
                bins.attrs, bins.tile_start, bins.tile_end, grid_x),
            "frame": lambda: render_tiled(params, cam, bg, chunk=128,
                                          backend="cuda"),
        }
        plain = lambda: torch_blend.blend_tiles_torch(
            bins.attrs, bins.tile_start, bins.tile_end, grid_x, 16, 128)
        # two rounds, the plain blend in between, to show the spread
        rounds = [{k: timed(f, 20) for k, f in phases.items()}]
        plain_ms, _ = timed(plain, 2)
        rounds.append({k: timed(f, 20) for k, f in phases.items()})
        for r, times in enumerate(rounds):
            print(f"[time] round {r}: device ms / host wall ms per call: "
                  + "; ".join(f"{k} {d:.4f} / {w:.4f}"
                              for k, (d, w) in times.items()))
        print(f"[time] plain blend: device {plain_ms:.4f} ms per call")
        dev_ms, wall_ms, top = device_profile(phases["frame"], 5)
        print(f"[profile] frame: device kernels {dev_ms:.4f} ms, host wall "
              f"{wall_ms:.4f} ms per frame (profiler on); by kernel:")
        for name, t in top:
            print(f"[profile]   {t:9.4f} ms  {name[:100]}")
        n_eval, n_exp, n_commit = k1_work(bins, grid_x)
    num_pairs = int(bins.num_pairs)
    nt = bins.tile_start.shape[0]
    k1_bytes = num_pairs * BYTES_PER_PAIR + nt * (2 * 4 + 256 * 8 * 4)
    k1_flops = (n_eval * FLOPS_EVAL + n_exp * FLOPS_EXP_PATH
                + n_commit * FLOPS_COMMIT)
    bound = {
        "bytes": k1_bytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(k1_flops / FP32_FLOPS_PER_S,
                          n_exp / SFU_OPS_PER_S) * 1e3,
    }
    bound_by = max(bound, key=bound.get)
    print(f"[time] K1 work: pairs {num_pairs} evaluated products {n_eval} "
          f"exps {n_exp} commits {n_commit} flops {k1_flops} bytes {k1_bytes}")
    print(f"[time] K1 bound: bytes {bound['bytes']:.5f} ms, operations "
          f"{bound['operations']:.5f} ms -> {bound_by}")
    print(f"[time] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(json.dumps({"kernels": [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "luciddreamer_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "luciddreamer_tpu/render/pallas_blend.py:152",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": min(r["k1"][0] for r in rounds),
        "plain_ms": plain_ms,
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
