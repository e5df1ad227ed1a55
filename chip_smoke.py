#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``luciddreamer_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Set-up: prints the card's name and power limit, builds the kernels K1
   (``csrc/blend_fwd.cu``), K2 (``csrc/blend_bwd.cu``) and K3
   (``csrc/repack_cols.cu``) with nvcc, one process each, all at once, into
   ``build/kernels/``, and prints the build time, ptxas's lines and the
   blocks per SM that its registers and shared memory imply.
2. K1 against its plain PyTorch version on a 20k-Gaussian 512x512 scene:
   render/final_T/acc atol 1e-5, depth atol 1e-4, n_contrib equal.
3. Serving path: builds the 1M-Gaussian, SH-degree-3 scene from seed 42,
   saves it to PLY and loads it back through the port's app class, and
   renders the first 30 frames of the ``llff`` path at 512x512 through
   ``video.render_frames(device="cuda")``.  K1's launch count over that run
   must equal the frame count; the frames must be finite and not blank.
4. K1 against its plain version on frame 0 of the 1M scene: mean |d rgb|
   <= 1e-5, max |d rgb| <= 2e-2, n_contrib equal on >= 99.9% of pixels (the
   kernel multiplies T pair by pair, the plain version by chunk cumprod,
   so a pixel whose T lands on the 1e-4 latch within rounding may stop one
   pair apart).
5. Serving times per call at that shape, two rounds of 20 calls after a
   warm-up, for preprocess, binning, K1 and the whole frame: device time
   (CUDA events) and host wall time; the plain blend's device time; the
   frame's kernels by device time (torch.profiler); that no op of a frame
   gathers the attribute table's 16-channel rows into a tensor of the pair
   capacity (the profiler's shapes and memory; the same check must find
   the plain version's copy); K1's work, its bound (the bytes of the rows
   a tile walks before its last pixel is done, 44 used bytes and the
   4-byte ``src`` entry each, and of the state, against the operations
   on them) and the rows it stages; the peak device memory of a frame.
6. K2 and K3 against their plain versions at llff frame 0, 512x512, with
   random cotangents from a seed: K2 at 20k Gaussians on every channel
   within 5e-4 of the channel's max |ref| on rows [0, num_pairs) and zero
   beyond; at 1M the same on >= 99.9% of rows (the latch, as in 4), with
   the relative L2 error per channel, and two runs of K2 on the same inputs
   bit-equal; K3 bit-equal at 1M.  K1 and K2 on synthetic tiles whose
   ranges are empty or 1, 31 ... 65, 127 ... 129, 256, 257 and more rows
   long (the batch and stage edges) and on an opaque wall that latches in
   the first batch, read through a table shuffled against the stream that
   shares rows between tiles and holds decoy rows: K1's n_contrib
   bit-equal and its state within 1e-5, K2 as above.  K3 on a shuffled
   permutation whose dead rows land in the middle of slot order, with a
   live count of 0, below, at and above the row count, bit-equal.  The
   binning VJP (K3, float64 prefix sum, boundary gather) against a float64
   index_add at 1M, beside the same VJP with an fp32 prefix sum.  The whole
   gradient, ``backend="cuda"`` against ``backend="torch"`` (the plain
   forward and backward through the same autograd Function), all six
   parameter groups within 5e-4 of the group's max, at 20k and 1M.
7. Training path: the bench scene padded to capacity 1.2M with dead rows;
   targets are its renders at the first 4 llff poses; the trained scene is
   the same with features_dc and opacity perturbed from seed 43;
   ``GSConfig(iterations=40, densify_from_iter=10,
   densification_interval=10)`` and ``Trainer(device="cuda")`` with its
   default pair budget.  Every loss finite, the mean of the last 5 below
   the first 5, the alive count changed by densify, K1, K2 and K3 launched
   once per step run, and no overflowed step committed.  Then
   ``create_from_pcd`` on 400k points, timed, its knn checked on 1,000
   rows against a float64 brute force.
8. Training times at the main-path shape, device ms by events and host
   wall ms, two rounds: the whole step, its forward, its backward, K2, the
   binning VJP with K3, K3, K3's library call, K2's zero fill alone, Adam,
   densify; the plain K2's time; a torch.profiler table of one step and the
   device's busy share; that no op of a step gathers the pair capacity's
   16-channel rows; K2's and K3's bounds; the tiles' range lengths, the
   rows K2 walks and how many (warp, row) sums it takes; K2 on the longest
   tile alone; the peak device memory of a step.

9. Dream to video, the app's own path at full width: ``LucidDreamerTPU(
   device="cuda").create`` on a synthetic 512x512 conditioning image (made
   from seed 5 with numpy: smooth gradients and waves with hard-edged
   discs) and the waterfall prompt, on the ``lookdown`` path (14 poses, 70
   training frames), with the weight-free inpainter and depth, the cloud
   Morton-subsampled to 400,000 points, capacity 1.2M, the pair budget
   min(8 x capacity, 6M) and ``GSConfig(iterations=100,
   position_lr_max_steps=100, densify_from_iter=50,
   densification_interval=25)``; then all 400 ``llff`` frames of the
   scene's preset path through ``video.render_frames(device="cuda")``.
   The 70 frames finite, a cloud of more than 512^2 points, the 1.2M
   capacity, the loss falling (mean of the last 10 steps below the first
   10), K2 and K3 launched once per step and K1 once per step and frame,
   the 400 frames finite and not blank, and ``gsplat.ply`` loadable.
   Prints the seconds of the dream loop, the align loop and the stages
   ``create`` times with its ``PhaseTimer``, the cloud's size, ms per bake
   step (events, host wall), ms per frame, the peak device memory and the
   PSNR of training view 0 before and after the bake.  After the launch
   counts are read, the kernels are held against their plain versions at
   this path's shapes: the whole gradient, ``backend="cuda"`` against
   ``"torch"`` (K1, K2, K3), on the baked scene at training view 0 and the
   bake's pair budget, within 5e-4 of each group's max as in 6; K1 on
   llff frame 0 at the video's budget, at the limits of 4.  (Writing the
   video files needs imageio, which the script does not ask for; the CPU
   tests write them.)

Prints the kernels line (``launches``: the sum of each kernel's counts
over the three main-path runs, phases 3, 7 and 9) and the card line, then
the result line last.
Exits non-zero, printing no result, when any phase fails or no CUDA device
is present.
"""
import ctypes
import json
import re
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
CAPACITY = 1_200_000          # the largest scene the app keeps
N_FRAMES = 30
H = W = 512
TRAIN_VIEWS = 4
TRAIN_ITERS = 40
PCD_POINTS = 400_000          # the largest point cloud the app builds from
KERNELS = ("blend_fwd", "blend_bwd", "repack_cols")

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 rate
# and fp32 rate outside the tensor cores.  The special-function rate (exp,
# reciprocal) is 16 MUFU ops/clk/SM (Hopper architecture white paper) x 132
# SMs x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# K1 per evaluated (pair, pixel) product: dx, dy and power are 11 FLOPs;
# where power <= 0 one exp and one multiply; a commit adds 1-alpha, T*(..),
# w and five accumulations, 12 FLOPs.  Bytes per walked row (a row before
# its tile's last pixel is done; nothing after that reaches the output):
# the 11 channels read and its src entry (the table row it reads).
FLOPS_EVAL, FLOPS_EXP_PATH, FLOPS_COMMIT = 11, 1, 12
BYTES_PER_ROW = 11 * 4 + 4
K1_BATCH = 64                      # rows K1 stages per batch
K1_STAGED_ROW_BYTES = 3 * 16 + 4   # three 16-byte pieces and the src entry
# K2 per committed product, beyond the forward's evaluation: 1-alpha,
# test_T, w (3); q (8); the running prefix and suffix (3); dalpha (4, one
# of them a divide, also one SFU reciprocal); dpower (1); the 10 gradient
# terms (24); and one add into each of the 10 per-pair sums.
FLOPS_K2_COMMIT = 3 + 8 + 3 + 4 + 1 + 24 + 10
K2_READ_PER_ROW = 11 * 4 + 4       # per walked row, as K1
K2_WRITE_PER_PAIR = 10 * 4         # per live pair
K2_PIXEL_BYTES = (6 + 6) * 4       # 6 saved state and 6 cotangent rows
K3_BYTES_READ = 10 * 4             # per live row
K3_BYTES_ORDER = 8                 # per slot
K3_BYTES_WRITE = 10 * 4            # per slot
# ops that gather rows of a tensor into a new one
GATHER_OPS = {"aten::index", "aten::index_select", "aten::gather",
              "aten::take", "aten::take_along_dim", "aten::embedding"}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def row_copies(fn, pair_cap):
    """The ops of one call of ``fn`` that gather the rows of a 16-channel
    tensor into one of at least ``pair_cap`` rows, by the profiler's input
    shapes and memory: the stream-order copy of the attribute table, which
    the kernels do not need.  [(op, bytes it allocated)]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, profile_memory=True) as prof:
        fn()
        torch.cuda.synchronize()
    found = []
    for e in prof.events():
        shapes = e.input_shapes or [[]]
        made = max(e.device_memory_usage, e.cpu_memory_usage)
        if (e.name in GATHER_OPS and len(shapes[0]) == 2 and shapes[0][1] == 16
                and made >= pair_cap * 16 * 4):
            found.append((e.name, made))
    return found


def peak_memory(fn):
    """(peak, held before) device bytes over one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), base


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


def device_profile(fn, n, top=8):
    """torch.profiler over ``n`` calls: device kernel ms and host wall ms
    per call, and the kernels by device time."""
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
    return sum(t for _, t in kernels), wall * 1e3 / n, kernels[:top]


def bound_of(nbytes, flops, sfu_ops):
    """(bound ms, "bytes" or "operations") on the published peaks."""
    bound = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(flops / FP32_FLOPS_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3,
    }
    by = max(bound, key=bound.get)
    return bound[by], by, bound


def blocks_per_sm(regs, smem, threads=256):
    """Resident blocks per SM that a kernel's registers per thread and
    static shared memory per block allow on an H100: 65,536 registers
    handed out in units of 8 per thread, 233,472 B of shared memory with
    1 KB reserved per block, 2,048 threads."""
    by_regs = 65536 // (-(-regs // 8) * 8 * threads)
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads)


def print_build_report():
    from luciddreamer_tpu_torch.render import kernels

    t0 = time.time()
    kernels.build(*KERNELS)
    print(f"[build] {', '.join(KERNELS)} built in {time.time() - t0:.1f} s "
          "(one nvcc each, in parallel)")
    for name in KERNELS:
        print(f"[build] {name}: {kernels.library_path(name).name}")
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build]   {line.strip()}")
            used = re.search(r"Used (\d+) registers", line)
            if used:
                smem = re.search(r"(\d+) bytes smem", line)
                regs, smem = int(used.group(1)), int(smem.group(1)) if smem else 0
                print(f"[build]   -> {blocks_per_sm(regs, smem)} blocks of 256 "
                      f"threads per SM ({regs} registers, {smem} B shared memory)")


# ---------------------------------------------------------------- serving

def compare(params, cam, bg, tag, pair_cap=None):
    """K1 against its plain version on one frame, both through
    ``render_tiled``: (K1's output, max |d| per output, the share of pixels
    whose n_contrib is equal, mean |d rgb|, all finite)."""
    from luciddreamer_tpu_torch.render.tiled import render_tiled

    with torch.no_grad():
        out = render_tiled(params, cam, bg, chunk=128, pair_cap=pair_cap,
                           backend="cuda")
        ref = render_tiled(params, cam, bg, chunk=128, pair_cap=pair_cap,
                           backend="torch")
    torch.cuda.synchronize()
    check(not bool(out["overflow"]), f"{tag}: pair overflow")
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


def check_large_frame(params, cam, bg, tag, pair_cap=None):
    """K1 against its plain version on a frame of a large scene: mean
    |d rgb| <= 1e-5, max |d rgb| <= 2e-2, n_contrib equal on >= 99.9% of
    pixels, and acc > 0.5 on >= 5% of them.  Returns max |d rgb|."""
    out, err, nc_eq, mean_rgb, finite = compare(params, cam, bg, tag, pair_cap)
    check(finite and mean_rgb <= 1e-5 and err["render"] <= 2e-2
          and nc_eq >= 0.999, f"K1 disagrees with the plain version on {tag}")
    acc_share = float((out["acc"] > 0.5).float().mean())
    print(f"[compare] {tag}: acc > 0.5 on {acc_share:.4f} of pixels")
    check(acc_share >= 0.05, f"{tag} is nearly blank")
    return err["render"]


def serving(bg, dev):
    """Phases 2-5; returns (app, cams, K1 serving record)."""
    from luciddreamer_tpu_torch.app import LucidDreamerTPU
    from luciddreamer_tpu_torch.core.transforms import make_camera
    from luciddreamer_tpu_torch.model.ply import save_ply
    from luciddreamer_tpu_torch.render import cuda_blend
    from luciddreamer_tpu_torch.render.binning import (
        build_tile_bins, num_tiles_for, pair_rows)
    from luciddreamer_tpu_torch.render.blend_cases import blend_work
    from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
    from luciddreamer_tpu_torch.render.tiled import (
        default_pair_capacity, render_tiled)
    from luciddreamer_tpu_torch.video import render_frames

    # ---- 2. K1 against its plain version on the 20k scene ----
    small = make_scene(P_SMALL, seed=7, device=dev)
    cam0 = make_camera(np.eye(4), 0.8279, 0.8279, W, H, device=dev)
    _, err, nc_eq, _, finite = compare(small, cam0, bg, "20k 512x512")
    check(finite and err["render"] <= 1e-5 and err["final_T"] <= 1e-5
          and err["acc"] <= 1e-5 and err["depth"] <= 1e-4 and nc_eq == 1.0,
          "K1 disagrees with the plain version on the 20k scene")
    del small

    # ---- 3. serving path at full size ----
    t0 = time.time()
    scene = make_scene(P_FULL, seed=42, device="cpu")
    app = LucidDreamerTPU(device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "scene.ply")
        save_ply(scene, path)
        app.load_ply(path)
    check(app.params.capacity == P_FULL and app.params.xyz.is_cuda,
          "PLY round trip did not give the 1M scene on the card")
    check(torch.equal(app.params.xyz.cpu(), scene.xyz.detach()),
          "PLY round trip changed the means")
    del scene
    cams = app.preset_cameras("llff")[:N_FRAMES]
    print(f"[serve] scene built, saved and loaded in {time.time() - t0:.1f} s")

    torch.cuda.synchronize()
    cuda_blend.blend_fwd.launches = 0
    t0 = time.time()
    rgbs, depths = render_frames(app.params, cams, bg, active_sh_degree=3,
                                 device="cuda")
    torch.cuda.synchronize()
    main_s = time.time() - t0
    k1_launches = cuda_blend.blend_fwd.launches
    print(f"[serve] {N_FRAMES} frames in {main_s:.2f} s host time, "
          f"K1 launches {k1_launches}")
    check(k1_launches == N_FRAMES,
          f"K1 launched {k1_launches} times for {N_FRAMES} frames")
    check(len(rgbs) == N_FRAMES and rgbs[0].shape == (H, W, 3),
          "render_frames returned the wrong frames")
    covered = [float((d > 0).mean()) for d in depths]
    check(all(np.isfinite(d).all() for d in depths), "non-finite depth")
    check(min(covered) >= 0.05,
          f"a frame is nearly blank: depth > 0 on {min(covered):.3f}")
    print(f"[serve] depth > 0 on {min(covered):.4f}..{max(covered):.4f} of "
          f"pixels; mean rgb {float(np.mean(rgbs)):.2f}/255")

    # ---- 4. K1 against its plain version at the serving shape ----
    k1_err = check_large_frame(app.params, cams[0], bg, "1M llff frame 0")

    # ---- 5. serving times per frame ----
    params, cam = app.params, cams[0]
    grid_x, _ = num_tiles_for(H, W, 16)
    pair_cap = default_pair_capacity(params.capacity)   # 1024-aligned
    with torch.no_grad():
        proc = preprocess_gaussians(params, cam, 3)
        bins = build_tile_bins(proc, H, W, 16, pair_cap)
        phases = {
            "preprocess": lambda: preprocess_gaussians(params, cam, 3),
            "binning": lambda: build_tile_bins(proc, H, W, 16, pair_cap),
            "k1": lambda: cuda_blend.blend_fwd(
                bins.table, bins.src, bins.tile_start, bins.tile_end, grid_x),
            "frame": lambda: render_tiled(params, cam, bg, chunk=128,
                                          backend="cuda"),
        }
        # the plain version of the same function of (table, src)
        plain = lambda: cuda_blend.blend_fwd_torch(
            pair_rows(bins.table, bins.src), bins.tile_start, bins.tile_end,
            grid_x, 16, 128)
        # two rounds, the plain blend in between, to show the spread
        rounds = [{k: timed(f, 20) for k, f in phases.items()}]
        plain_ms, _ = timed(plain, 2)
        rounds.append({k: timed(f, 20) for k, f in phases.items()})
        for r, times in enumerate(rounds):
            print(f"[time] serve round {r}: device ms / host wall ms per call: "
                  + "; ".join(f"{k} {d:.4f} / {w:.4f}"
                              for k, (d, w) in times.items()))
        print(f"[time] plain blend: device {plain_ms:.4f} ms per call")
        dev_ms, wall_ms, top = device_profile(phases["frame"], 5)
        print(f"[profile] frame: device kernels {dev_ms:.4f} ms, host wall "
              f"{wall_ms:.4f} ms per frame (profiler on); by kernel:")
        for name, t in top:
            print(f"[profile]   {t:9.4f} ms  {name[:100]}")
        copies = row_copies(phases["frame"], pair_cap)
        plain_copies = row_copies(
            lambda: pair_rows(bins.table, bins.src), pair_cap)
        work = blend_work(bins.table, bins.src, bins.tile_start, bins.tile_end,
                          grid_x)
        peak, base = peak_memory(phases["frame"])
    print(f"[profile] frame: ops gathering (>= {pair_cap}, 16) rows: "
          f"{copies or 'none'}; in the plain version's pair_rows: {plain_copies}")
    check(plain_copies, "the row-copy check does not see the plain version's copy")
    check(not copies, "a frame gathers the attribute rows in stream order")
    print(f"[time] frame peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
          "held before it)")
    n_eval, n_exp, n_commit = work["evaluated"], work["exps"], work["commits"]
    num_pairs = int(bins.num_pairs)
    nt = bins.tile_start.shape[0]
    lengths = (bins.tile_end - bins.tile_start).long()
    walked = work["walked"]
    k1_bytes = int(walked.sum()) * BYTES_PER_ROW + nt * (2 * 4 + 256 * 8 * 4)
    # what K1 stages: the batch in which a tile's last pixel is done and
    # the one after it, already in flight, or the whole range
    staged = torch.minimum(lengths, K1_BATCH * (-(-walked // K1_BATCH) + 1))
    k1_design_bytes = (int(staged.sum()) * K1_STAGED_ROW_BYTES
                       + nt * (2 * 4 + 256 * 8 * 4))
    k1_flops = (n_eval * FLOPS_EVAL + n_exp * FLOPS_EXP_PATH
                + n_commit * FLOPS_COMMIT)
    bound, bound_by, both = bound_of(k1_bytes, k1_flops, n_exp)
    print(f"[time] K1 work: pairs {num_pairs}, rows walked {int(walked.sum())}, "
          f"evaluated products {n_eval} exps {n_exp} commits {n_commit} flops "
          f"{k1_flops} bytes {k1_bytes}")
    print(f"[time] K1 bound: bytes {both['bytes']:.5f} ms, operations "
          f"{both['operations']:.5f} ms -> {bound_by}")
    print(f"[time] K1 stages {int(staged.sum())} rows ({int(walked.sum())} "
          f"walked) of {num_pairs}: {k1_design_bytes} bytes with the state, "
          f"{k1_design_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms at the peak rate")
    record = {
        "serve_launches": k1_launches, "max_abs_err": k1_err,
        "ms": min(r["k1"][0] for r in rounds), "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "bytes_bound_ms": both["bytes"],
        "operations_bound_ms": both["operations"],
    }
    return app, cams, record


# ------------------------------------------------------- K2 / K3 / gradient

def frame_inputs(params, cam, seed):
    """Sorted pairs, the attribute table, K1's state and random cotangents
    at one frame."""
    from luciddreamer_tpu_torch.render import binning, cuda_blend
    from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
    from luciddreamer_tpu_torch.render.tiled import default_pair_capacity

    with torch.no_grad():
        proc = preprocess_gaussians(params, cam, 3)
        pair_cap = default_pair_capacity(params.capacity)
        pairs = binning.sort_pairs(proc, H, W, 16, pair_cap)
        table = binning.gaussian_attr_table(proc)
        state, _ = cuda_blend.blend_fwd(table, pairs.src, pairs.tile_start,
                                        pairs.tile_end, W // 16)
        g = torch.Generator(device=table.device).manual_seed(seed)
        d_state = torch.randn(state.shape, generator=g, device=table.device)
        d_state[:, 6] = 0.0
    return pairs, table, state, d_state


def k2_runs(table, src, tile_start, tile_end, state, d_state, grid_x):
    """K2 twice and the plain K2 on the same inputs: (out, rerun, ref)."""
    from luciddreamer_tpu_torch.render import binning, cuda_blend, torch_blend

    args = (tile_start, tile_end, state, d_state)
    out = cuda_blend.blend_bwd(table, src, *args, grid_x)
    rerun = cuda_blend.blend_bwd(table, src, *args, grid_x)
    ref = torch_blend.blend_tiles_bwd_torch(binning.pair_rows(table, src),
                                            *args, grid_x, 16, 128)
    torch.cuda.synchronize()
    return out, rerun, ref


def check_k2(params, cam, tag, row_share):
    """K2 against the plain K2; returns (pairs, K2's output, max abs
    error)."""
    pairs, table, state, d_state = frame_inputs(params, cam, seed=11)
    out, rerun, ref = k2_runs(table, pairs.src, pairs.tile_start,
                              pairs.tile_end, state, d_state, W // 16)
    rerun_equal = torch.equal(out, rerun)
    del rerun
    n = int(pairs.total)
    diff = (out[:n, :10] - ref[:n, :10]).abs()
    scale = ref[:n, :10].abs().amax(dim=0).clamp_min(1e-30)
    rows_bad = int((~((diff / scale) <= 5e-4).all(dim=1)).sum())
    rows_ok = 1.0 - rows_bad / max(n, 1)
    rel_l2 = (diff.norm(dim=0) / ref[:n, :10].norm(dim=0).clamp_min(1e-30)).tolist()
    tail_zero = not bool(out[n:].any()) and not bool(out[:, 10:].any())
    max_err = float(diff.max())
    print(f"[k2] {tag}: pairs {n}, rows outside 5e-4 of the channel max "
          f"{rows_bad} ({rows_ok:.6f} within); max |d| {max_err:.3e}; "
          "max |d|/channel max "
          + " ".join(f"{v:.2e}" for v in (diff / scale).amax(dim=0).tolist())
          + "; relative L2 " + " ".join(f"{v:.2e}" for v in rel_l2)
          + f"; rows past num_pairs and columns 10-15 zero: {tail_zero}"
          + f"; two runs bit-equal: {rerun_equal}")
    check(bool(torch.isfinite(out).all()), f"K2 non-finite at {tag}")
    check(rerun_equal, f"two runs of K2 on the same inputs differ at {tag}")
    check(tail_zero, f"K2 left non-zero rows past num_pairs at {tag}")
    check(rows_ok >= row_share,
          f"K2 disagrees with the plain version at {tag}: {rows_ok:.6f} of rows")
    del ref, state, d_state, table
    return pairs, out, max_err


def check_blend_edges(dev):
    """K1 and K2 against their plain versions on the synthetic edge cases."""
    from luciddreamer_tpu_torch.render import binning, cuda_blend
    from luciddreamer_tpu_torch.render.blend_cases import (
        EDGE_CASES, EDGE_GRID_X, blend_work, edge_case)

    for name, (lengths, wall, _) in EDGE_CASES.items():
        table, src, ts, te = edge_case(name, dev)
        state, n_contrib = cuda_blend.blend_fwd(table, src, ts, te, EDGE_GRID_X)
        ref_state, ref_nc = cuda_blend.blend_fwd_torch(
            binning.pair_rows(table, src), ts, te, EDGE_GRID_X, 16, 128)
        torch.cuda.synchronize()
        nc_equal = torch.equal(n_contrib, ref_nc)
        state_err = float((state - ref_state).abs().max())
        print(f"[k1] edge case {name}: {table.shape[0]} table rows read "
              f"through src; n_contrib bit-equal: {nc_equal} (max "
              f"{int(ref_nc.max())}); max |d state| {state_err:.3e}")
        check(nc_equal and state_err <= 1e-5,
              f"K1 disagrees with the plain version on edge case {name}")
        work = blend_work(table, src, ts, te, EDGE_GRID_X)
        multi = work["warp_rows"] - work["warp_rows_single"]
        print(f"[k2] edge case {name}: (warp, row) pairs with a commit on "
              f"several lanes {multi}, on one lane {work['warp_rows_single']}, "
              f"on none {work['warp_rows_none']}")
        check(min(multi, work["warp_rows_single"], work["warp_rows_none"]) > 0,
              f"edge case {name} does not reach all three of K2's sum branches")
        g = torch.Generator(device=dev).manual_seed(3)
        d_state = torch.randn(state.shape, generator=g, device=dev)
        d_state[:, 6] = 0.0
        out, rerun, ref = k2_runs(table, src, ts, te, state, d_state,
                                  EDGE_GRID_X)
        n = int(te.max())
        scale = ref[:n, :10].abs().amax(dim=0).clamp_min(1e-30)
        rel = ((out[:n, :10] - ref[:n, :10]).abs() / scale).amax(dim=0)
        nonzero = int(ref[:n, :10].any(dim=1).sum())
        tail_zero = not bool(out[n:].any()) and not bool(out[:, 10:].any())
        # the rows the plain version leaves zero (after a tile's latch, not
        # committed, invalid) are exactly zero in K2's output too
        zeros_kept = not bool(out[:n, :10][~ref[:n, :10].any(dim=1)].any())
        print(f"[k2] edge case {name}: ranges {list(lengths)}, {n} rows, "
              f"{nonzero} with a gradient; max |d| / channel max "
              f"{float(rel.max()):.2e}; zero rows kept zero: {zeros_kept}; "
              f"dead tail and columns 10-15 zero: {tail_zero}; two runs "
              f"bit-equal: {torch.equal(out, rerun)}")
        check(bool(torch.isfinite(out).all()), f"K2 non-finite on edge case {name}")
        check(nonzero > 0, f"edge case {name} has no gradient at all")
        check(float(rel.max()) <= 5e-4,
              f"K2 disagrees with the plain version on edge case {name}")
        check(tail_zero and zeros_kept,
              f"K2 wrote where it must leave zeros on edge case {name}")
        check(torch.equal(out, rerun), f"two runs of K2 differ on edge case {name}")
        if wall:
            # sanity of the case: every wall tile latches in its first 32
            # rows, everything after is zero
            check(int(work["walked"].max()) <= 32
                  and not bool(ref[int(ts[0]) + 32:int(te[0])].any()),
                  "the wall case does not latch in its first batch")


K3_EDGE_N = 1_000_003          # not a multiple of the kernels' block
K3_EDGE_LIVE = (0, 600_000, K3_EDGE_N, K3_EDGE_N + 5)


def check_k3_edges(dev):
    """K3 on a shuffled permutation: the dead rows' slots lie in the middle
    of slot order; a live count of 0, below n, n, and above n (overflow)."""
    from luciddreamer_tpu_torch.render import cuda_repack

    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((K3_EDGE_N, 16), generator=g, device=dev)
    order = torch.randperm(K3_EDGE_N, generator=g, device=dev)
    for live in K3_EDGE_LIVE:
        total = torch.tensor(live, device=dev)
        equal = torch.equal(cuda_repack.repack_cols(x, order, total),
                            cuda_repack.repack_cols_torch(x, order, total))
        print(f"[k3] edge case: {K3_EDGE_N} rows, shuffled order, live count "
              f"{live}: bit-equal to the plain version: {equal}")
        check(equal, f"K3 disagrees with its plain version at live count {live}")


def whole_gradient(params, cam, tag, pair_cap=None):
    """backend="cuda" against backend="torch" on every parameter group."""
    from luciddreamer_tpu_torch.render.tiled import render_tiled

    w = torch.randn((3, H, W), generator=torch.Generator(device="cuda")
                    .manual_seed(5), device="cuda")

    def grads(backend):
        for t in params.parameters():
            t.grad = None
        out = render_tiled(params, cam, torch.zeros(3, device="cuda"),
                           chunk=128, pair_cap=pair_cap, backend=backend)
        loss = (torch.sum(out["render"] * w) + 0.01 * torch.sum(out["depth"])
                + 0.3 * torch.sum(out["final_T"] ** 2)
                + 0.1 * torch.sum(out["acc"]))
        loss.backward()
        return {k: t.grad.clone() for k, t in params.named_parameters()}

    gk, gp = grads("cuda"), grads("torch")
    for t in params.parameters():
        t.grad = None
    errs = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30))
            for k in gk}
    print(f"[grad] {tag}: max |d grad| / group max, cuda vs torch: "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(np.isfinite(list(errs.values()))), f"non-finite gradient at {tag}")
    check(max(errs.values()) <= 5e-4,
          f"the CUDA gradient disagrees with the plain one at {tag}")


def check_vjp(pairs, d_rows):
    """K3 bit-equal to its plain version; the VJP of the row reads against
    float64."""
    from luciddreamer_tpu_torch.render import binning, cuda_repack

    cols = cuda_repack.repack_cols(d_rows, pairs.order, pairs.total)
    plain = cuda_repack.repack_cols_torch(d_rows, pairs.order, pairs.total)
    torch.cuda.synchronize()
    equal = torch.equal(cols, plain)
    k3_err = float((cols - plain).abs().max())
    print(f"[k3] 1M frame 0: K3 bit-equal to its plain version: {equal}")
    check(equal, "K3 disagrees with its plain version")
    del plain
    n = int(pairs.total)
    rows = pairs.offsets_p1.shape[0]
    exact = torch.zeros((rows, 16), dtype=torch.float64, device="cuda")
    exact.index_add_(0, pairs.src[:n].long(), d_rows[:n].double())
    got = binning.gather_vjp(d_rows, pairs.order, pairs.offsets_p1, pairs.total)
    cs = torch.cat([cols.new_zeros((10, 1)), torch.cumsum(cols, dim=1)], dim=1)
    csb = cs[:, pairs.offsets_p1.clamp(max=cols.shape[1])]
    fp32 = (csb[:, 1:] - csb[:, :-1]).t()
    scale = exact[:-1, :10].abs().amax(dim=0)
    e64 = ((got[:-1, :10].double() - exact[:-1, :10]).abs().amax(dim=0) / scale)
    e32 = ((fp32.double() - exact[:-1, :10]).abs().amax(dim=0) / scale)
    print("[vjp] 1M frame 0: gather VJP max |d| / channel max against a "
          "float64 index_add: float64 prefix sum (the port) "
          + " ".join(f"{v:.2e}" for v in e64.tolist())
          + "; fp32 prefix sum " + " ".join(f"{v:.2e}" for v in e32.tolist()))
    check(float(e64.max()) <= 1e-5, "the gather VJP disagrees with float64")
    return k3_err


# ---------------------------------------------------------- dream to video

DREAM_ITERS = 100
DREAM_FRAMES = 70             # 14 lookdown poses x 5 hemisphere views


def conditioning_image(seed):
    """A 512x512 uint8 landscape-like image: a sky gradient, a wavy ridge
    over textured ground, and hard-edged discs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32) / np.float32(H)
    img = np.stack([0.35 + 0.4 * y, 0.55 + 0.3 * y, 0.9 - 0.2 * y], -1)
    ridge = 0.45 + 0.08 * np.sin(2 * np.pi * (1.5 * x + rng.uniform()))
    texture = sum(rng.uniform(0.02, 0.06) * np.sin(
        2 * np.pi * (rng.uniform(2, 9) * x + rng.uniform(2, 9) * y
                     + rng.uniform())) for _ in range(6))
    ground = np.stack([0.25 + texture, 0.4 + 0.5 * (y - 0.5) + texture,
                       0.2 + texture], -1)
    img = np.where((y > ridge)[..., None], ground, img)
    for _ in range(5):
        cx, cy, r = rng.uniform(0.15, 0.85), rng.uniform(0.5, 0.9), rng.uniform(0.03, 0.08)
        disc = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[disc] = rng.uniform(0.1, 0.9, size=3)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def dream_to_video(dev):
    """Phase 9: the app's dream -> bake -> video path; returns each kernel's
    launches in it."""
    from luciddreamer_tpu_torch import app as app_mod
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.core.types import GaussianParams
    from luciddreamer_tpu_torch.model.ply import load_ply
    from luciddreamer_tpu_torch.render import cuda_blend, cuda_repack
    from luciddreamer_tpu_torch.render.tiled import render_tiled
    from luciddreamer_tpu_torch.train.loop import Trainer
    from luciddreamer_tpu_torch.train.losses import psnr
    from luciddreamer_tpu_torch.utils import PhaseTimer
    from luciddreamer_tpu_torch.video import render_frames

    image = conditioning_image(seed=5)
    prompt = (ROOT / "examples" / "waterfall.txt").read_text().splitlines()[0]
    marks, record = {}, {"losses": [], "events": []}

    def progress(stage, i, n):
        if stage not in marks:
            torch.cuda.synchronize()
            marks[stage] = time.perf_counter()

    def counted_step(self, state, *a):
        if not record["events"]:
            # the scene create_from_pcd made, before the first update
            record["start"] = GaussianParams.from_param_dict(
                {k: v.clone() for k, v in state.params.param_dict().items()},
                state.params.alive.clone())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        out = step(self, state, *a)
        end.record()
        record["events"].append((start, end))
        record["losses"].append(out[1])
        return out

    def view0_psnr(params, view):
        with torch.no_grad():    # the plain blend: no launch is counted
            out = render_tiled(params, view.camera, torch.zeros(3, device=dev),
                               backend="torch")
        return float(psnr(out["render"], torch.as_tensor(view.image, device=dev)))

    step = Trainer._step
    Trainer._step = counted_step
    cfg = GSConfig(iterations=DREAM_ITERS, position_lr_max_steps=DREAM_ITERS,
                   densify_from_iter=50, densification_interval=25)
    timer = PhaseTimer()
    bg = torch.zeros(3, device=dev)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            app = app_mod.LucidDreamerTPU(gs_config=cfg, save_dir=tmp,
                                          device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters = (cuda_blend.blend_fwd, cuda_blend.blend_bwd,
                        cuda_repack.repack_cols)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            ply = app.create(image, prompt, "", "lookdown", seed=1,
                             diff_steps=30, progress_callback=progress,
                             timer=timer)
            torch.cuda.synchronize()
            create_s = time.perf_counter() - t0
            cams = app.scene.get_preset_cameras("llff")
            t1 = time.perf_counter()
            rgbs, depths = render_frames(app.params, cams, [0.0, 0.0, 0.0],
                                         active_sh_degree=3, device="cuda")
            torch.cuda.synchronize()
            video_s = time.perf_counter() - t1
            launches = {c.__name__: c.launches for c in counters}
            peak = torch.cuda.max_memory_allocated()
            alive = int(app.params.num_alive)
            reloaded = load_ply(ply, device="cuda")
    finally:
        Trainer._step = step

    steps = len(record["losses"])
    losses = [float(v) for v in record["losses"]]
    step_ms = [a.elapsed_time(b) for a, b in record["events"]]
    views = app.scene.get_train_views()
    cloud = app.traindata["pcd_points"].shape[1]
    baked = int(record["start"].num_alive)
    capacity = app.trainer.state.params.capacity
    psnr_before = view0_psnr(record["start"], views[0])
    psnr_after = view0_psnr(app.params, views[0])
    del record["start"]
    stage = timer.totals
    dream_s = marks["align"] - t0
    print(f"[dream] create {create_s:.2f} s host time: dream loop (conditioning "
          f"and 13 views) {dream_s:.2f} s, align loop ({len(views)} frames) "
          f"{stage['dream'] - dream_s:.2f} s, Scene {stage['scene']:.2f} s, "
          f"Morton subsample + create_from_pcd + Trainer {stage['bake_setup']:.2f} "
          f"s, bake {stage['bake']:.2f} s for {steps} steps, save_ply "
          f"{stage['save_ply']:.2f} s")
    print(f"[dream] cloud {cloud} points, {baked} after the Morton subsample; "
          f"capacity {capacity}; pair budget {app.trainer.pair_cap}; alive "
          f"after the bake {alive}")
    print(f"[dream] bake step: device ms by events min / median / max "
          f"{min(step_ms):.4f} / {float(np.median(step_ms)):.4f} / "
          f"{max(step_ms):.4f}; host wall {stage['bake'] * 1e3 / steps:.4f} "
          "ms per step (incl. 2 densifies)")
    print(f"[dream] loss first 10 {np.round(losses[:10], 5).tolist()} last 10 "
          f"{np.round(losses[-10:], 5).tolist()}; PSNR of training view 0 "
          f"before {psnr_before:.3f} dB, after {psnr_after:.3f} dB")
    covered = [float((d > 0).mean()) for d in depths]
    print(f"[dream] {len(rgbs)} llff frames in {video_s:.2f} s host time, "
          f"{video_s * 1e3 / len(rgbs):.4f} ms per frame; depth > 0 on "
          f"{min(covered):.4f}..{max(covered):.4f} of pixels; mean rgb "
          f"{float(np.mean(rgbs)):.2f}/255")
    print(f"[dream] launches {launches}; peak device memory "
          f"{peak / 2**30:.3f} GiB over create and the video")
    check(len(views) == DREAM_FRAMES and all(
        np.isfinite(v.image).all() and np.isfinite(v.depth).all() for v in views),
        "the dream stage did not give 70 finite training frames")
    check(cloud > H * W and baked == min(cloud, app_mod.MAX_PCD_POINTS),
          f"cloud of {cloud} points, {baked} baked")
    check(capacity == CAPACITY, f"capacity {capacity}, not {CAPACITY}")
    check(all(np.isfinite(losses)), "a bake loss is not finite")
    check(np.mean(losses[-10:]) < np.mean(losses[:10]), "the bake loss did not fall")
    check(launches["blend_bwd"] == steps and launches["repack_cols"] == steps
          and launches["blend_fwd"] == steps + len(cams),
          f"launches {launches} for {steps} steps and {len(cams)} frames")
    check(len(rgbs) == len(cams) == 400 and all(np.isfinite(d).all() for d in depths)
          and min(covered) >= 0.05, "the video's frames are wrong or blank")
    check(int(reloaded.num_alive) == alive, "gsplat.ply does not load back")

    # the kernels against their plain versions at this path's own shapes,
    # after its counts were read: K1, K2 and K3 on the baked scene at the
    # bake's pair budget and training view 0, K1 on video frame 0 at the
    # video's budget
    whole_gradient(app.params, views[0].camera, "dreamed scene, training "
                   f"view 0, pair budget {app.trainer.pair_cap}",
                   pair_cap=app.trainer.pair_cap)
    check_large_frame(app.params, cams[0], bg, "dreamed scene, llff frame 0")
    return launches


# ---------------------------------------------------------------- training

def training(app, cams, dev):
    """Phase 7 (the training main path) and phase 8 (its times)."""
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.core.types import GaussianParams
    from luciddreamer_tpu_torch.model import gaussians as gs
    from luciddreamer_tpu_torch.model.optim import (
        adam_init, adam_update, learning_rates)
    from luciddreamer_tpu_torch.render import (
        binning, cuda_blend, cuda_repack, kernels, torch_blend)
    from luciddreamer_tpu_torch.render.blend_cases import blend_work
    from luciddreamer_tpu_torch.render.tiled import render_tiled
    from luciddreamer_tpu_torch.train.loop import Trainer

    # ---- 7. set-up ----
    scene = make_scene(P_FULL, seed=42, device=dev)
    scene, _, _ = gs.grow_capacity(scene, adam_init(scene.param_dict()),
                                   gs.DensifyStats.zero(P_FULL, dev), CAPACITY)
    views = []
    with torch.no_grad():
        for cam in cams[:TRAIN_VIEWS]:
            out = render_tiled(scene, cam, torch.zeros(3, device=dev))
            check(not bool(out["overflow"]), "target render overflowed")
            views.append((cam, out["render"]))
    rng = np.random.default_rng(43)
    p = scene.param_dict()
    alive = scene.alive
    noise = lambda shape, s: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32) * s, device=dev) * alive.view(
            (-1,) + (1,) * (len(shape) - 1))
    p["f_dc"] = p["f_dc"] + noise(p["f_dc"].shape, 0.3)
    p["opacity"] = p["opacity"] + noise(p["opacity"].shape, 1.0)
    start = GaussianParams.from_param_dict(p, alive)
    cfg = GSConfig(iterations=TRAIN_ITERS, densify_from_iter=10,
                   densification_interval=10)
    tr = Trainer(start, cfg, cameras_extent=2.0, device="cuda")
    alive_before = int(tr.state.params.num_alive)
    step_calls = []
    inner_step = tr._step

    def counted_step(*a):
        step_calls.append(1)
        return inner_step(*a)

    tr._step = counted_step
    losses = []
    torch.cuda.synchronize()
    cuda_blend.blend_fwd.launches = 0
    cuda_blend.blend_bwd.launches = 0
    cuda_repack.repack_cols.launches = 0
    t0 = time.time()
    state = tr.run(views, callback=lambda it, st, loss: losses.append(loss))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {"blend_fwd": cuda_blend.blend_fwd.launches,
                "blend_bwd": cuda_blend.blend_bwd.launches,
                "repack_cols": cuda_repack.repack_cols.launches}
    tr._step = inner_step
    steps = len(step_calls)
    losses = [float(v) for v in losses]
    alive_after = int(state.params.num_alive)
    print(f"[train] {TRAIN_ITERS} iterations ({steps} steps run) in "
          f"{train_s:.2f} s host time; launches {launches}; pair_cap "
          f"{tr.pair_cap}; overflow seen {tr.last_overflow}")
    print(f"[train] loss first 5 {np.round(losses[:5], 5).tolist()} last 5 "
          f"{np.round(losses[-5:], 5).tolist()}; alive {alive_before} -> "
          f"{alive_after} of {CAPACITY}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), "the loss did not fall")
    check(alive_after != alive_before, "densify did not change the population")
    check(all(v == steps for v in launches.values()),
          f"kernel launches {launches} differ from the {steps} steps run")
    check(int(state.step) == TRAIN_ITERS and int(state.adam.count) == TRAIN_ITERS,
          "an overflowed step was committed or a step went missing")

    # ---- create_from_pcd at the app's largest cloud ----
    g = np.random.default_rng(44)
    pts = torch.as_tensor(g.uniform([-2, -2, 2], [2, 2, 6], (PCD_POINTS, 3))
                          .astype(np.float32), device=dev)
    cols = torch.as_tensor(g.uniform(size=(PCD_POINTS, 3)).astype(np.float32),
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    pcd = gs.create_from_pcd(pts, cols, capacity=CAPACITY)
    torch.cuda.synchronize()
    pcd_s = time.time() - t0
    # the scale is log sqrt(mean 3-NN squared distance): check that mean
    rows = torch.as_tensor(g.choice(PCD_POINTS, 1000, replace=False), device=dev)
    got = torch.exp(2.0 * pcd.scaling[rows, 0].double())
    p64 = pts.double()
    r64 = p64[rows]
    d2 = ((r64 * r64).sum(1)[:, None] + (p64 * p64).sum(1)[None, :]
          - 2.0 * r64 @ p64.T)                    # float64: negligible cancellation
    d2[torch.arange(1000, device=dev), rows] = float("inf")
    ref = torch.topk(d2, 3, dim=1, largest=False).values.mean(dim=1).clamp_min(1e-7)
    rel = float(((got.detach() - ref).abs() / ref).max())
    print(f"[pcd] create_from_pcd of {PCD_POINTS} points into capacity "
          f"{CAPACITY}: {pcd_s:.3f} s host time; knn on 1000 rows against "
          f"float64: max relative error {rel:.3e}")
    check(int(pcd.num_alive) == PCD_POINTS and bool(torch.isfinite(pcd.scaling).all()),
          "create_from_pcd gave a wrong scene")
    check(rel <= 2e-2, "knn disagrees with the float64 brute force")
    del pcd, d2, p64

    # ---- 8. times at the main-path shape ----
    cam, img = views[0]
    step = lambda: tr._step(state, cam, img, None)

    def forward():
        rp = GaussianParams.from_param_dict(state.params.param_dict(), alive_now)
        off = torch.zeros((rp.capacity, 2), device=dev, requires_grad=True)
        loss, _ = tr._render_loss(rp, off, cam, img, None)
        return loss, [rp.xyz, rp.features_dc, rp.features_rest, rp.scaling,
                      rp.rotation, rp.opacity, off]

    alive_now = state.params.alive
    loss, leaves = forward()
    backward = lambda: torch.autograd.grad(loss, leaves, retain_graph=True)
    pairs, table, kstate, d_state = frame_inputs(state.params, cam, seed=12)
    src = pairs.src
    d_rows = cuda_blend.blend_bwd(table, src, pairs.tile_start,
                                   pairs.tile_end, kstate, d_state, W // 16)
    lib_out = torch.empty((10, d_rows.shape[0]), device=dev)
    # the zero fill that K2's launch function runs before its kernel, alone
    fill_out = torch.empty_like(d_rows)
    fill = ctypes.CDLL(str(kernels.library_path("blend_bwd"))).blend_bwd_zero_fill
    fill.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fill.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def zero_fill():
        check(fill(fill_out.data_ptr(), fill_out.shape[0], stream) == 0,
              "K2's zero fill failed")

    _, _, grads, _ = tr._loss_and_grads(state, cam, img, None)
    pdict = state.params.param_dict()
    lrs = learning_rates(cfg, tr.extent, state.step)
    phases = {
        "step": (step, 5),
        "forward": (forward, 5),
        "backward": (backward, 5),
        "k2": (lambda: cuda_blend.blend_bwd(
            table, src, pairs.tile_start, pairs.tile_end, kstate, d_state,
            W // 16), 20),
        "k2_zero_fill": (zero_fill, 20),
        "binning_vjp": (lambda: binning.gather_vjp(
            d_rows, pairs.order, pairs.offsets_p1, pairs.total), 20),
        "k3": (lambda: cuda_repack.repack_cols(d_rows, pairs.order,
                                               pairs.total), 20),
        "k3_library": (lambda: lib_out.index_copy_(
            1, pairs.order, d_rows[:, :10].t()), 20),
        "adam": (lambda: adam_update(pdict, grads, state.adam, lrs), 20),
        "densify": (lambda: gs.densify_and_prune(
            state.params, state.adam, state.stats, cfg.densify_grad_threshold,
            0.005, tr.extent, None, cfg.percent_dense, generator=tr.generator), 5),
    }
    rounds = []
    for r in range(2):
        rounds.append({k: timed(f, n) for k, (f, n) in phases.items()})
        print(f"[time] train round {r}: device ms / host wall ms per call: "
              + "; ".join(f"{k} {d:.4f} / {w:.4f}"
                          for k, (d, w) in rounds[-1].items()))
        if r == 0:
            k2_plain_ms, _ = timed(lambda: torch_blend.blend_tiles_bwd_torch(
                binning.pair_rows(table, src), pairs.tile_start,
                pairs.tile_end, kstate, d_state, W // 16, 16, 128), 1)
            k3_plain_ms, _ = timed(lambda: cuda_repack.repack_cols_torch(
                d_rows, pairs.order, pairs.total), 5)
    print(f"[time] plain K2 {k2_plain_ms:.4f} ms, plain K3 {k3_plain_ms:.4f} ms "
          "(device, per call)")
    for r, times in enumerate(rounds):
        print(f"[time] K2 zero fill round {r}: {times['k2_zero_fill'][0]:.4f} ms "
              f"of K2's {times['k2'][0]:.4f} ms (device, per call), the "
              f"kernel alone {times['k2'][0] - times['k2_zero_fill'][0]:.4f} ms")
    del loss, leaves, fill_out
    dev_ms, wall_ms, top = device_profile(step, 3, top=12)
    print(f"[profile] training step: device kernels {dev_ms:.4f} ms, host "
          f"wall {wall_ms:.4f} ms per step (profiler on), device busy share "
          f"{dev_ms / wall_ms:.4f}; by kernel:")
    for name, t in top:
        print(f"[profile]   {t:9.4f} ms  {name[:100]}")
    copies = row_copies(step, src.shape[0])
    print(f"[profile] training step: ops gathering (>= {src.shape[0]}, 16) "
          f"rows: {copies or 'none'}")
    check(not copies, "a training step gathers the attribute rows in stream order")
    peak, base = peak_memory(step)
    print(f"[time] training step peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
          "held before it)")

    # ---- bounds of K2 and K3 at this frame ----
    with torch.no_grad():
        walk = blend_work(table, src, pairs.tile_start, pairs.tile_end, W // 16)
    n_eval, n_exp, n_commit = walk["evaluated"], walk["exps"], walk["commits"]
    n = int(pairs.total)
    nt = pairs.tile_start.shape[0]
    cap = src.shape[0]

    # ---- the tiles' ranges, what K2 walks of them, and the longest alone ----
    lengths = (pairs.tile_end - pairs.tile_start).double()
    walked = walk["walked"].double()
    stats = lambda v: (f"mean {float(v.mean()):.1f}, p99 "
                       f"{float(torch.quantile(v, 0.99)):.0f}, max {int(v.max())}")
    print(f"[tiles] {nt} tiles at this frame: range length {stats(lengths)}; "
          f"rows walked before the tile's last pixel is done {stats(walked)}, "
          f"{int(walked.sum())} of {n} rows in all")
    print(f"[tiles] K2's sums: (warp, row) pairs walked {int(walked.sum()) * 8}, "
          f"with a commit {walk['warp_rows']} (a warp an 8x4 block of pixels; "
          f"{walk['warp_rows_strip']} if it were a 16x2 strip), with exactly "
          f"one {walk['warp_rows_single']}; commits per (warp, row) with any "
          f"{n_commit / max(walk['warp_rows'], 1):.2f}")
    longest = int(walked.argmax())
    only = torch.zeros(nt, dtype=torch.bool, device=dev)
    only[longest] = True
    zero = torch.zeros_like(pairs.tile_start)
    one_start = torch.where(only, pairs.tile_start, zero)
    one_end = torch.where(only, pairs.tile_end, zero)
    one_ms, _ = timed(lambda: cuda_blend.blend_bwd(
        table, src, one_start, one_end, kstate, d_state, W // 16), 20)
    fill_ms = min(r["k2_zero_fill"][0] for r in rounds)
    print(f"[tiles] K2 with every range but tile {longest}'s emptied "
          f"({int(lengths[longest])} rows, {int(walked[longest])} walked): "
          f"{one_ms:.4f} ms with the zero fill, {one_ms - fill_ms:.4f} ms "
          "without (device, per call)")
    k2_bytes = (int(walked.sum()) * K2_READ_PER_ROW + n * K2_WRITE_PER_PAIR
                + nt * (2 * 4 + 256 * K2_PIXEL_BYTES))
    k2_flops = (n_eval * FLOPS_EVAL + n_exp * FLOPS_EXP_PATH
                + n_commit * FLOPS_K2_COMMIT)
    k2_bound, k2_by, k2_both = bound_of(k2_bytes, k2_flops, n_exp + n_commit)
    k3_bytes = n * K3_BYTES_READ + cap * (K3_BYTES_ORDER + K3_BYTES_WRITE) + 8
    k3_bound, k3_by, k3_both = bound_of(k3_bytes, 0, 0)
    print(f"[time] K2 work: pairs {n} of {cap} slots, evaluated products "
          f"{n_eval}, exps {n_exp}, commits {n_commit}, flops {k2_flops}, "
          f"bytes {k2_bytes}; bound: bytes {k2_both['bytes']:.5f} ms, "
          f"operations {k2_both['operations']:.5f} ms -> {k2_by}")
    print(f"[time] K3 work: bytes {k3_bytes}; bound {k3_bound:.5f} ms -> {k3_by}")
    best = lambda k: min(r[k][0] for r in rounds)
    return {
        "launches": launches,
        "blend_bwd": {"ms": best("k2"), "plain_ms": k2_plain_ms,
                      "bound_ms": k2_bound, "bound_by": k2_by,
                      "bytes_bound_ms": k2_both["bytes"],
                      "operations_bound_ms": k2_both["operations"]},
        "repack_cols": {"ms": best("k3"), "plain_ms": k3_plain_ms,
                        "bound_ms": k3_bound, "bound_by": k3_by,
                        "bytes_bound_ms": k3_both["bytes"],
                        "operations_bound_ms": k3_both["operations"],
                        "library_ms": best("k3_library")},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions run on the card too: full fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {torch.cuda.get_device_name(0)} | {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.time()
    try:
        print_build_report()
        bg = torch.zeros(3, device=dev)
        app, cams, k1 = serving(bg, dev)

        # ---- 6. K2, K3 and the whole gradient ----
        small = make_scene(P_SMALL, seed=7, device=dev)
        check_k2(small, cams[0], "20k llff frame 0", 1.0)
        whole_gradient(small, cams[0], "20k llff frame 0")
        del small
        check_blend_edges(dev)
        check_k3_edges(dev)
        pairs, d_rows, k2_err = check_k2(
            app.params, cams[0], "1M llff frame 0", 0.999)
        k3_err = check_vjp(pairs, d_rows)
        del pairs, d_rows
        whole_gradient(app.params, cams[0], "1M llff frame 0")

        train = training(app, cams, dev)
        del app
        dream = dream_to_video(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases in {time.time() - t_start:.1f} s")

    source = "luciddreamer_tpu_torch/csrc/{}.cu".format
    launches = {k: train["launches"][k] + dream[k] for k in KERNELS}
    launches["blend_fwd"] += k1["serve_launches"]
    rows = [
        {"name": "blend_fwd", "route": "cuda", "source": source("blend_fwd"),
         "replaces": "luciddreamer_tpu/render/pallas_blend.py:152",
         "launches": launches["blend_fwd"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "bytes_bound_ms": k1["bytes_bound_ms"],
         "operations_bound_ms": k1["operations_bound_ms"], "library_ms": None},
        {"name": "blend_bwd", "route": "cuda", "source": source("blend_bwd"),
         "replaces": "luciddreamer_tpu/render/pallas_blend.py:215",
         "launches": launches["blend_bwd"], "max_abs_err": k2_err,
         **train["blend_bwd"], "library_ms": None},
        {"name": "repack_cols", "route": "cuda", "source": source("repack_cols"),
         "replaces": "luciddreamer_tpu/render/binning.py:234",
         "launches": launches["repack_cols"], "max_abs_err": k3_err,
         **train["repack_cols"]},
    ]
    print(f"[done] launches by path: serving {{'blend_fwd': "
          f"{k1['serve_launches']}}}, training {train['launches']}, dream to "
          f"video {dream}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
