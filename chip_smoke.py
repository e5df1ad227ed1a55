#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``luciddreamer_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Set-up: prints the card's name and power limit, builds the kernels K1
   (``csrc/blend_fwd.cu``), K2 (``csrc/blend_bwd.cu``), K3
   (``csrc/repack_cols.cu``) and the exact knn (``csrc/knn3_exact.cu``)
   with nvcc, one process each, all at once, into
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

10. The depth model, at full width with RANDOM weights (seeded
   ``torch.Generator``s; the registry refuses such a model, and no
   checkpoint is in the repository): ZoeD_N at its published geometry
   (``ZoeDepthConfig()``: BEiT-L/16, 24 blocks, 1024 wide, 16 heads, hooks
   5/11/17/23, project readout, 384x512, 64 bins, attractors 16/8/4/1)
   built through ``ZoeDepthEstimator`` on the card, every parameter on
   ``cuda``; its depth of phase 9's 512x512 image finite, positive and
   512x512; ms per call by events and host wall, two rounds of 10 after a
   warm-up, the peak device memory of a call, the FLOPs of one forward
   counted from the configuration (``zoe_forward_flops``) and their share
   of the fp32 peak, a torch.profiler table of a call; one forward at 384x512 without augmentation held
   against the same weights on the CPU, max |d| <= 1e-3 x max |ref| for
   the metric and the relative depth.  ZoeD_NK at the same geometry: one
   forward, finite, and its ms.  Then ``create`` as in 9 with that ZoeD_N
   registered as the dream's depth estimator (``DreamConfig(
   depth_estimator=...)``), 30 bake steps and the first 30 ``llff`` frames:
   one estimator call per dreamed view (14), a finite cloud, capacity 1.2M
   and the 6M pair budget, every loss finite, K2 and K3 launched once per
   step and K1 once per step and frame, the frames finite and not blank;
   the dream loop's seconds beside phase 9's and the ms of depth per view.
   After the counts are read, K1, K2 and K3 are held against their plain
   versions on this run's own scene, as in 9: the whole gradient at
   training view 0 and the bake's pair budget, and K1 on llff frame 0.

11. Sharded training (``parallel/``) at the training main path's full width:
   phase 7's scene (1M live in 1.2M, 512x512, its 4 llff targets).
   (a) Frame 0 as 4 bands of 8 tile rows, each through
   ``parallel.sharded._render_rows`` with backend "cuda", stitched and held
   against ``render_tiled`` at the limits of 4 with radii equal; the
   bands' summed gradient of a seeded weighted sum against the whole
   render's, each group within 5e-4 of its max (K1, K2 and K3 launched
   once a band); on the band with most pairs K1 against its plain version
   at the limits of 4, K2 as in 6 (>= 99.9% of rows), K3 bit-equal and the
   binning VJP against float64; binning + K1 device ms of each band
   against the whole frame's.  (b) An NCCL world of one
   (``multihost.initialize`` at a loopback address, a 1 x 1 mesh):
   ``ShardedTrainer`` for 20 iterations against ``Trainer`` with the same
   seed, pair budget (9.6M) and chunk: the same step count and alive
   mask, xyz within 2e-4; ``grad_overlap=True`` for 5 steps against the
   batch step (xyz: beyond 0.05 of the xyz lr on <= 0.1% of entries);
   K1-K3 launched once per step run.  (c) ``dryrun_multichip(1)`` (K1-K3
   three times each).  Prints a sharded step's and a Trainer step's ms
   (events, host wall) and the sharded step's peak memory, with the card's
   name and power limit.
12. Depth training: ``DepthTrainer(device="cuda")`` on ZoeD_N at its
   published geometry, random weights from seed 11, 5 steps at batch 2 and
   384x512 on a seeded synthetic batch (crops of phase 9's image, a smooth
   depth of low-frequency waves): every loss finite, the parameters moved,
   ms per step (events, host wall), the FLOPs' share of the fp32 peak (3 x
   ``zoe_forward_flops`` per image) and the peak memory; a batch with a NaN
   depth changes nothing; one step of the tiny configuration on the card
   against the CPU (loss within 1e-4 relative, updates within 0.05 lr on
   >= 99.9% of entries).

13. The SIBR viewer bridge: phase 3's 1M scene read again from its PLY
   file, a ``ViewerServer(port=0)`` on 127.0.0.1 and a fake SIBR client
   thread that connects, signals, and sends 30 requests for llff frames
   0-29 at 512x512 over one connection (the glm-transposed, y/z-flipped
   matrices the viewer sends); the server answers each through
   ``serve_once``, polling with 1 ms sleeps until a deadline.  Every reply
   byte-equal to a direct ``render_tiled(backend="cuda")`` of the camera
   ``camera_from_message`` builds, every such camera within 1e-6 of its
   source, the replies not blank, K1 launched once per request.  Prints
   the round trip per request (send to last byte, host wall): median, max
   and the first.
14. The Gradio UI at the app's own defaults: ``app_gradio.build_demo``
   under a stand-in ``gradio`` module (``gradio_stub``: components record
   their arguments, buttons their bindings), and stand-ins for imageio and
   matplotlib where those are not installed (``video_stand_ins``: an mp4
   written through OpenCV, matplotlib's jet table).  "Run all" on phase
   9's image, prompt "", ``lookdown``, ``llff``, seed 1, 30 inpainting
   steps, the classic inpainter, radial depth and "SD1.5 (default)": the
   2,990-step bake (densify every 100 steps from step 600), capacity 1.2M,
   pair budget 6M, then the 400 llff frames; then "Render video" for
   ``back_and_forth`` (201 frames), then "Render video" with the depth
   dropdown changed, which must raise ``gr.Error``.  Both videos and the
   PLY file written and not empty, every loss finite, the PSNR of training
   view 0 risen, K2 and K3 launched once per step and K1 once per step
   and frame.  Prints ``create``'s stages, ms per bake step (events, host
   wall), live Gaussians against the capacity, the pairs of the training
   views against the budget, the overflowed steps, the densify statistic
   against its threshold, ms per frame of each video, the files and the
   peak memory; then holds K1-K3 against their plain versions on the baked
   scene as phase 9 does.

15. The model adapters under stand-ins (``adapter_stand_ins``: neither
   machine has ``diffusers``, ``transformers`` or the checkpoints): a
   stand-in ``diffusers`` whose two pipelines record their kwargs, check
   that the generator and the control image live on the pipe's device and
   compute their image there from their input (``diffusers_stub``); a
   scripted two-convolution LaMa saved as ``big-lama.pt`` in the run's
   working directory under ``build/``, with the port's ``fetch_checked``
   replaced by one that returns that file (no network is reached, and a
   stand-in's md5 cannot match big-lama.pt's); a stand-in ``transformers``
   whose depth pipeline returns a 384x384 map for the 512x512 image, so
   the adapter resizes it (``transformers_stub``).  ``create`` at 512x512
   on ``lookdown`` with ``inpainter="sd_controlnet"`` (which chains
   ``lama``) and ``depth_estimator="zoedepth"``, at phase 9's cuts (400,000
   points, capacity 1.2M, budget 6M, 100 bake steps), then the first 30
   ``llff`` frames.  ControlNet and LaMa called once per dreamed view (13)
   and ZoeDepth once per view (14), each on and returning CUDA tensors;
   the pipe's strength 0.9, steps, prompt and size, its seeds drawn from
   the dream's generator; every loss finite, view 0's PSNR risen, K2 and
   K3 launched once per step and K1 once per step and frame, the frames
   finite and not blank.  Prints ``create``'s stages (host s), each
   adapter's host ms per call, a bake step's ms (events, host wall) and
   the peak memory.  After the counts are read, K1-K3 against their plain
   versions on the baked scene as phase 9 does, then each of the four
   adapters (``sd`` too) applied once on ``cuda`` and once on the CPU to
   one 512x512 input: ``sd`` within 1e-6, ``lama`` within 1e-5,
   ``sd_controlnet`` within one grey level (its init image is LaMa's fill
   rounded to 8 bits) with its mask image equal and its condition within
   1e-5, ``zoedepth`` within 1e-5 of the depth's max.

16. The programs that run the JAX package on its chip, through the port
   (``luciddreamer_tpu_torch.smoke``, ``bench``, ``profile_step``,
   ``entry``): BASELINE config 1 (``tests/test_baseline_config1.py``: 10k
   Gaussians from seed 3 at 512x512, pair_cap 300,000, chunk 128), the
   tiled render with K1-K3 against the dense oracle, which recomputes each
   chunk in its backward, on render (atol 1e-5), depth (atol 5e-4) and
   every parameter group's gradient (more than 99.99% of elements within
   5e-3 of the group's max, all within 5e-2); ``tools/tpu_smoke.py``'s
   drives: 20k Gaussians (seed 7) at pair_cap 400,000 and chunk 128
   without overflow, with finite gradients and the 64x64 crop [224:288]
   within 1e-5 of the dense oracle, and the bench scene at pair_cap
   4,000,000 (4,000,768 slots) and chunk 128, forward and backward without
   overflow and with finite gradients; ``entry()`` on the card against
   its ``fn`` on CPU copies of its arguments (render 1e-5, depth 5e-4);
   ``bench.run()`` at ``bench.py``'s shape and protocol, printing its
   lines and its JSON line (K1-K3 once per step); ``profile_step``'s four
   cumulative stages, by host wall and by events.  K1-K3 must each be
   launched in the phase.

17. The last two pieces of the port.  (a) The exact 3-NN, ``knn3_exact``
   (``csrc/knn3_exact.cu``, the counterpart of the JAX package's host C++
   KD-tree ``native/knn_native.cpp::mean_sq_dist_3nn``, not a TPU kernel),
   through ``points.mean_sq_dist_3nn_exact`` on 50,000 seeded points,
   phase 7's 400,000-point ``create_from_pcd`` cloud and 1.2M points (one
   launch each); bit-equal to its plain version on every row at 50k and
   400k and on 1,000 sampled rows at 1.2M; the kernel and the plain
   version within 1e-5 relative of a float64 brute force on 1,000 sampled
   rows of each cloud, the formula knn's (``points/knn.py``) miss on them
   printed beside; edge cases n = 0...4, every point three times, and
   20,000 points 1e3 from the origin (where the formula cancels worst),
   bit-equal and within 1e-5 of float64 (+1e-7); device ms by events at
   400k and 1.2M against the function's bound (its bytes), the brute
   force's own bound (n (n - 1) pairs of 8 fp32 operations), the formula
   knn's one call and the code it replaces: the JAX package's KD-tree,
   compiled by g++ from ``native/knn_native.cpp`` and timed on the host
   (one call, every row within 1e-5 of the kernel); and the plain
   version's one call at 400k.  (b) ``grad_overlap.run`` (the twin of ``tools/grad_overlap.py``)
   at its own configuration (100,000 Gaussians, 512x512, pair_cap 400,000,
   chunk 128) in an NCCL world of one on a 1 x 1 mesh: both steps warmed
   up, timed and traced; its report and verdict printed; K1-K3 launched
   once per step by the counts and once per step in each trace; no ring
   window (a world of one sends nothing); the two steps agree (loss 1e-5
   relative, Adam's first moments 5e-4 of each group's max).

Prints the kernels line (``launches``: for K1-K3 the sum of each kernel's
counts over the ten main-path runs, phases 3, 7, 9, 10, 11, 13, 14, 15, 16
and 17 (b); for ``knn3_exact`` its three calls in 17 (a)) and the card
line, then the result line last.
Exits non-zero, printing no result, when any phase fails or no CUDA device
is present.
"""
import contextlib
import ctypes
import importlib.util
import json
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
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
BLEND_KERNELS = ("blend_fwd", "blend_bwd", "repack_cols")
KERNELS = BLEND_KERNELS + ("knn3_exact",)

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
    """The bench scene generator (``luciddreamer_tpu_torch.bench``): a
    Gaussian blob 3 units ahead of the origin camera, SH degree 3,
    log-scales in [-5.5, -3.5]."""
    from luciddreamer_tpu_torch.bench import bench_scene

    return bench_scene(P, seed, device)


def timed(fn, reps, once=False):
    """(device ms, host wall ms) per call over ``reps`` back-to-back calls.
    Device: CUDA events around the calls, enqueued behind a device-side
    sleep so that the host's enqueue time is not what is measured.  Wall:
    host clock around the calls and a synchronize.  With ``once``: one
    call of ``fn`` alone (seconds of work, which a warm-up and two timed
    rounds would triple), by CUDA events: (device ms, its result)."""
    if once:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), out
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


def serving(bg, dev, ply_path):
    """Phases 2-5; returns (app, cams, K1 serving record).  The 1M scene is
    saved to ``ply_path``, where phase 13 reads it again."""
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
    save_ply(scene, str(ply_path))
    app.load_ply(str(ply_path))
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

def band_proc(proc, capacity, t, n):
    """Band t of n of a 512x512 frame's preprocessed Gaussians as
    ``parallel.sharded._render_rows`` bins them: (proc, the band's height,
    its default pair budget)."""
    from luciddreamer_tpu_torch.parallel.sharded import (
        band_of, band_pair_capacity)

    rows = H // 16 // n
    return (band_of(proc, t * rows, rows, 16), rows * 16,
            band_pair_capacity(capacity, n))


def frame_inputs(params, cam, seed, band=None):
    """Sorted pairs, the attribute table, K1's state and random cotangents
    at one frame, or at its band t of n (``band=(t, n)``, binned as
    ``parallel.sharded._render_rows`` bins it, at the default per-band
    budget)."""
    from luciddreamer_tpu_torch.render import binning, cuda_blend
    from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
    from luciddreamer_tpu_torch.render.tiled import default_pair_capacity

    with torch.no_grad():
        proc = preprocess_gaussians(params, cam, 3)
        pair_cap, height = default_pair_capacity(params.capacity), H
        if band is not None:
            proc, height, pair_cap = band_proc(proc, params.capacity, *band)
        pairs = binning.sort_pairs(proc, height, W, 16, pair_cap)
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


def check_k2(params, cam, tag, row_share, band=None):
    """K2 against the plain K2 (on band t of n with ``band=(t, n)``);
    returns (pairs, K2's output, max abs error)."""
    pairs, table, state, d_state = frame_inputs(params, cam, seed=11,
                                                band=band)
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


@contextlib.contextmanager
def wrapped(owner, name, wrapper):
    """Replace ``owner.name`` by ``wrapper(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, wrapper(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def installed(modules):
    """Put ``modules`` (name -> module) into ``sys.modules`` inside the
    block; afterwards each name holds what it held before, or nothing."""
    saved = {name: sys.modules.get(name) for name in modules}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                del sys.modules[name]
            else:
                sys.modules[name] = module


@contextlib.contextmanager
def recorded_steps():
    """Record every ``Trainer._step`` of the block: its CUDA events and
    loss, and a copy of the scene before the first update (``"start"``)."""
    from luciddreamer_tpu_torch.train.loop import Trainer

    record = {"losses": [], "events": []}

    def wrapper(step):
        def counted_step(self, state, *a):
            if not record["events"]:
                record["start"] = clone_params(state.params)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = step(self, state, *a)
            end.record()
            record["events"].append((start, end))
            record["losses"].append(out[1])
            return out
        return counted_step

    with wrapped(Trainer, "_step", wrapper):
        yield record


def view0_psnr(params, view):
    """PSNR of ``params`` rendered at a training view, through the plain
    blend (no launch is counted)."""
    from luciddreamer_tpu_torch.render.tiled import render_tiled
    from luciddreamer_tpu_torch.train.losses import psnr

    dev = params.xyz.device
    with torch.no_grad():
        out = render_tiled(params, view.camera, torch.zeros(3, device=dev),
                           backend="torch")
    return float(psnr(out["render"], torch.as_tensor(view.image, device=dev)))


def dream_to_video(dev):
    """Phase 9: the app's dream -> bake -> video path; returns each kernel's
    launches in it and the dream loop's seconds."""
    from luciddreamer_tpu_torch import app as app_mod
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.model.ply import load_ply
    from luciddreamer_tpu_torch.utils import PhaseTimer
    from luciddreamer_tpu_torch.video import render_frames

    image = conditioning_image(seed=5)
    prompt = (ROOT / "examples" / "waterfall.txt").read_text().splitlines()[0]
    marks = {}

    def progress(stage, i, n):
        if stage not in marks:
            torch.cuda.synchronize()
            marks[stage] = time.perf_counter()

    cfg = GSConfig(iterations=DREAM_ITERS, position_lr_max_steps=DREAM_ITERS,
                   densify_from_iter=50, densification_interval=25)
    timer = PhaseTimer()
    bg = torch.zeros(3, device=dev)
    with recorded_steps() as record, tempfile.TemporaryDirectory(
            dir=ROOT / "build") as tmp:
        app = app_mod.LucidDreamerTPU(gs_config=cfg, save_dir=tmp,
                                      device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
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
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        alive = int(app.params.num_alive)
        reloaded = load_ply(ply, device="cuda")

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
    return launches, dream_s


# ------------------------------------------------------ the depth model

ZOE_SEED = 11
ZOE_BAKE_STEPS = 30
ZOE_FRAMES = 30
ZOE_DEPTH_NAME = "zoed_n_random_weights"


def zoe_forward_flops(cfg):
    """Multiply-add FLOPs (2 each) of one ZoeD_N forward at cfg.img_size,
    counted from the configuration: the matmuls and convolutions of the
    ViT, its attention, the DPT and the metric head.  Element-wise work
    (norms, softmax, resizes, the attractors' pull) is not counted."""
    v = cfg.vit
    H, W = cfg.img_size
    h, w = H // v.patch_size, W // v.patch_size
    n, C, f, bed = h * w, v.embed_dim, cfg.midas_features, cfg.bin_embedding_dim
    N, hid = n + 1, int(v.embed_dim * v.mlp_ratio)
    conv = lambda pixels, cin, cout, k=1: 2 * pixels * cin * cout * k * k
    vit = conv(n, 3, C, v.patch_size) + v.depth * 2 * N * C * (4 * C + 2 * hid)
    attention = v.depth * 4 * N * N * C
    och = cfg.out_channels
    dpt = 4 * (2 * n * 2 * C * C if v.readout == "project" else 0)
    dpt += sum(conv(n, C, c) for c in och)
    dpt += conv(n, och[0], och[0], 4) + conv(n, och[1], och[1], 2)
    dpt += conv(n // 4, och[3], och[3], 3)
    level = [16 * n, 4 * n, n, n // 4]            # pixels at strides 4..32
    dpt += sum(conv(px, c, f, 3) for px, c in zip(level, och))
    for k, px in enumerate(level):                # refinenet{k+1}
        dpt += (4 if k < 3 else 2) * conv(px, f, f, 3) + conv(4 * px, f, f)
    dpt += conv(H * W // 4, f, f // 2, 3) + conv(H * W, f // 2, 32, 3)
    dpt += conv(H * W, 32, 1)
    head = conv(n // 4, f, f) + conv(n // 4, f, 256) + conv(n // 4, 256,
                                                            cfg.n_bins)
    head += conv(n // 4, f, 128) + conv(n // 4, 128, bed)
    for px, a in zip([n, 4 * n, 16 * n, 64 * n], cfg.n_attractors):
        head += conv(px, f, 128) + conv(px, 128, bed)
        head += conv(px, bed, 128) + conv(px, 128, a)
    cin = 33 + bed
    head += conv(H * W, cin, cin // 2) + conv(H * W, cin // 2, 4)
    return {"vit": vit, "attention": attention, "dpt": dpt, "head": head}


def depth_model(dev, radial_dream_s):
    """Phase 10: ZoeD_N and ZoeD_NK at full width with random weights, and
    the app's dream -> bake -> video path with that ZoeD_N as its depth
    model; returns each kernel's launches in the app's run."""
    import torch.nn.functional as F

    from luciddreamer_tpu_torch import app as app_mod
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.dream import DreamConfig
    from luciddreamer_tpu_torch.dream.protocols import register_depth_estimator
    from luciddreamer_tpu_torch.models.zoedepth import (
        ZoeDepth, ZoeDepthConfig, ZoeDepthEstimator, init_random_)
    from luciddreamer_tpu_torch.models.zoedepth_nk import ZoeDepthNK
    from luciddreamer_tpu_torch.trajectory import get_pcdgen_poses
    from luciddreamer_tpu_torch.video import render_frames

    # ---- (a) ZoeD_N at its published geometry ----
    cfg = ZoeDepthConfig()
    t0 = time.perf_counter()
    est = ZoeDepthEstimator(cfg, seed=ZOE_SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in est.model.parameters())
    print(f"[zoe] ZoeD_N (BEiT-L/16: {cfg.vit.depth} blocks, "
          f"{cfg.vit.embed_dim} wide, {cfg.vit.num_heads} heads, hooks "
          f"{tuple(cfg.vit.hooks)}, {cfg.vit.readout} readout; "
          f"{cfg.img_size[0]}x{cfg.img_size[1]}, {cfg.n_bins} bins, attractors "
          f"{tuple(cfg.n_attractors)}), RANDOM weights from seed {ZOE_SEED}: "
          f"{n_params} parameters, built in {time.perf_counter() - t0:.1f} s")
    check(all(p.is_cuda for p in est.model.parameters()),
          "a ZoeD_N parameter is not on the card")
    image = torch.as_tensor(conditioning_image(seed=5), device=dev).float() / 255
    depth = est(image)
    check(depth.shape == (H, W) and bool(torch.isfinite(depth).all())
          and bool((depth > 0).all()), "ZoeD_N's depth is not finite, "
          f"positive and {H}x{W}")
    call = lambda: est(image)
    rounds = [timed(call, 10) for _ in range(2)]
    peak, base = peak_memory(call)
    flops = zoe_forward_flops(cfg)
    per_call = 2 * sum(flops.values())              # the image and its flip
    for r, (ms, wall) in enumerate(rounds):
        print(f"[zoe] estimator call on the 512x512 image (pad, resize, 2 "
              f"forwards, resize back) round {r}: device {ms:.4f} ms, host "
              f"wall {wall:.4f} ms; {per_call / (ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s = {per_call / (ms * 1e-3) / FP32_FLOPS_PER_S:.4f} of "
              "the fp32 peak")
    print("[zoe] FLOPs of one forward (matmuls and convolutions): "
          + ", ".join(f"{k} {v / 1e9:.2f} G" for k, v in flops.items())
          + f"; total {sum(flops.values()) / 1e9:.2f} G, {per_call / 1e9:.2f} "
          "G per call")
    print(f"[zoe] peak device memory of one call {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
          "held before it)")
    dev_ms, wall_ms, top = device_profile(call, 3, top=10)
    print(f"[profile] estimator call: device kernels {dev_ms:.4f} ms, host "
          f"wall {wall_ms:.4f} ms per call (profiler on); by kernel:")
    for name, t in top:
        print(f"[profile]   {t:9.4f} ms  {name[:100]}")

    x = F.interpolate(image.permute(2, 0, 1)[None], size=cfg.img_size,
                      mode="bilinear", align_corners=False, antialias=True)
    with torch.no_grad():
        out = est.model(x)
        cpu_model = ZoeDepth(cfg).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   est.model.state_dict().items()})
        t0 = time.perf_counter()
        ref = cpu_model(x.cpu())
        cpu_s = time.perf_counter() - t0
    del cpu_model
    errs = {}
    for key in ("metric_depth", "rel_depth"):
        scale = float(ref[key].abs().max())
        errs[key] = float((out[key].cpu() - ref[key]).abs().max()) / scale
        print(f"[zoe] one forward at 384x512 on the card against the CPU "
              f"({cpu_s:.1f} s there): max |d {key}| / max |ref| "
              f"{errs[key]:.3e} (max |ref| {scale:.4g})")
    check(all(e <= 1e-3 for e in errs.values()),
          f"ZoeD_N on the card disagrees with the CPU: {errs}")

    # ---- (b) ZoeD_NK at full geometry ----
    nk = init_random_(ZoeDepthNK(cfg).to(dev).eval(), ZOE_SEED + 1)

    def nk_call():
        with torch.no_grad():
            return nk(x)

    out = nk_call()
    check(all(bool(torch.isfinite(out[k]).all()) for k in
              ("metric_depth", "rel_depth", "domain_logits",
               "per_domain_depth")), "ZoeD_NK's outputs are not finite")
    nk_ms, nk_wall = timed(nk_call, 3)
    print(f"[zoe] ZoeD_NK, random weights from seed {ZOE_SEED + 1}, one "
          f"forward at 384x512: device {nk_ms:.4f} ms, host wall "
          f"{nk_wall:.4f} ms; finite")
    del nk, out

    # ---- (c) the app with that depth model ----
    depth_s = []

    def counted_depth(img):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = est(img)
        torch.cuda.synchronize()
        depth_s.append(time.perf_counter() - t)
        return d

    register_depth_estimator(ZOE_DEPTH_NAME, lambda device=None: counted_depth)
    prompt = (ROOT / "examples" / "waterfall.txt").read_text().splitlines()[0]
    marks = {}

    def progress(stage, i, n):
        if stage not in marks:
            torch.cuda.synchronize()
            marks[stage] = time.perf_counter()

    gs_cfg = GSConfig(iterations=ZOE_BAKE_STEPS,
                      position_lr_max_steps=ZOE_BAKE_STEPS,
                      densify_from_iter=50, densification_interval=25)
    with recorded_steps() as record, tempfile.TemporaryDirectory(
            dir=ROOT / "build") as tmp:
        app = app_mod.LucidDreamerTPU(
            gs_config=gs_cfg, save_dir=tmp, device="cuda",
            dream_config=DreamConfig(depth_estimator=ZOE_DEPTH_NAME))
        zero_counts()
        t0 = time.perf_counter()
        app.create(conditioning_image(seed=5), prompt, "", "lookdown",
                   seed=1, diff_steps=30, progress_callback=progress)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        cams = app.scene.get_preset_cameras("llff")[:ZOE_FRAMES]
        rgbs, depths = render_frames(app.params, cams, [0.0, 0.0, 0.0],
                                     active_sh_degree=3, device="cuda")
        torch.cuda.synchronize()
        launches = counts()
    losses = record["losses"]
    dream_s = marks["align"] - t0
    views = len(get_pcdgen_poses("lookdown"))
    steps = len(losses)
    losses = [float(v) for v in losses]
    cloud = app.traindata["pcd_points"]
    covered = [float((d > 0).mean()) for d in depths]
    print(f"[zoe] create with ZoeD_N as the depth model {create_s:.2f} s host "
          f"time: dream loop (conditioning and {views - 1} views) {dream_s:.2f} "
          f"s against {radial_dream_s:.2f} s with radial depth (phase 9); "
          f"{len(depth_s)} estimator calls, {np.mean(depth_s) * 1e3:.2f} ms "
          "each (host wall, synchronised)")
    print(f"[zoe] cloud {cloud.shape[1]} points; capacity "
          f"{app.trainer.state.params.capacity}; pair budget "
          f"{app.trainer.pair_cap}; {steps} bake steps, loss first 5 "
          f"{np.round(losses[:5], 5).tolist()} last 5 "
          f"{np.round(losses[-5:], 5).tolist()}; {len(rgbs)} llff frames, "
          f"depth > 0 on {min(covered):.4f}..{max(covered):.4f} of pixels; "
          f"launches {launches}")
    check(len(depth_s) == views,
          f"{len(depth_s)} depth calls for {views} dreamed views")
    check(bool(np.isfinite(cloud).all()), "the dreamed cloud is not finite")
    check(app.trainer.state.params.capacity == CAPACITY
          and app.trainer.pair_cap == app_mod.MAX_PAIR_CAP,
          "the bake did not run at phase 9's capacity and pair budget")
    check(steps == ZOE_BAKE_STEPS and all(np.isfinite(losses)),
          f"{steps} bake steps, or a loss that is not finite")
    check(launches["blend_bwd"] == steps and launches["repack_cols"] == steps
          and launches["blend_fwd"] == steps + len(cams),
          f"launches {launches} for {steps} steps and {len(cams)} frames")
    check(len(rgbs) == ZOE_FRAMES and all(np.isfinite(d).all() for d in depths)
          and min(covered) >= 0.05, "the video's frames are wrong or blank")

    # the kernels against their plain versions on this path's own scene,
    # after its counts were read, as phase 9 does on its own
    whole_gradient(app.params, app.scene.get_train_views()[0].camera,
                   "ZoeD_N dreamed scene, training view 0, pair budget "
                   f"{app.trainer.pair_cap}", pair_cap=app.trainer.pair_cap)
    check_large_frame(app.params, cams[0], torch.zeros(3, device=dev),
                      "ZoeD_N dreamed scene, llff frame 0")
    return launches


# ---------------------------------------------------------------- training

def training_scene(cams, dev, points=P_FULL, capacity=CAPACITY):
    """The training path's scene (phases 7 and 11): the bench scene padded
    to capacity 1.2M with dead rows, its renders at the first 4 llff poses
    as targets, and the start: the same Gaussians with features_dc and
    opacity perturbed from seed 43.  Returns (start, views)."""
    from luciddreamer_tpu_torch.core.types import GaussianParams
    from luciddreamer_tpu_torch.model import gaussians as gs
    from luciddreamer_tpu_torch.model.optim import adam_init
    from luciddreamer_tpu_torch.render.tiled import render_tiled

    scene = make_scene(points, seed=42, device=dev)
    scene, _, _ = gs.grow_capacity(scene, adam_init(scene.param_dict()),
                                   gs.DensifyStats.zero(points, dev), capacity)
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
    return GaussianParams.from_param_dict(p, alive), views

def training(app, cams, dev):
    """Phase 7 (the training main path) and phase 8 (its times)."""
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.core.types import GaussianParams
    from luciddreamer_tpu_torch.model import gaussians as gs
    from luciddreamer_tpu_torch.model.optim import adam_update, learning_rates
    from luciddreamer_tpu_torch.render import (
        binning, cuda_blend, cuda_repack, kernels, torch_blend)
    from luciddreamer_tpu_torch.render.blend_cases import blend_work
    from luciddreamer_tpu_torch.train.loop import Trainer

    # ---- 7. set-up ----
    start, views = training_scene(cams, dev)
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


# ------------------------------------------------------ sharded training

SHARD_TILES = 4               # bands of the decomposition in phase 11 (a)
SHARD_STEPS = 20
OVERLAP_STEPS = 5
SHARD_CHUNK = 128
SHARD_PAIR_CAP = 9_600_000    # Trainer's default at capacity 1.2M


def counts():
    from luciddreamer_tpu_torch.bench import launch_counts

    return launch_counts()


def zero_counts():
    from luciddreamer_tpu_torch.render import cuda_blend, cuda_repack

    for c in (cuda_blend.blend_fwd, cuda_blend.blend_bwd,
              cuda_repack.repack_cols):
        c.launches = 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clone_params(params):
    from luciddreamer_tpu_torch.core.types import GaussianParams

    return GaussianParams.from_param_dict(
        {k: v.clone() for k, v in params.param_dict().items()},
        params.alive.clone())


def band_decomposition(start, cam, dev):
    """Phase 11 (a): the frame as SHARD_TILES bands, each rendered by
    ``_render_rows`` with backend "cuda", against the whole render, and the
    summed gradient of the bands against the whole one; returns the
    launches of the bands' forward and backward."""
    from luciddreamer_tpu_torch.parallel.sharded import (
        _render_rows, band_pair_capacity)
    from luciddreamer_tpu_torch.render.tiled import render_tiled

    n, rows = SHARD_TILES, H // 16 // SHARD_TILES
    bg = torch.zeros(3, device=dev)
    cap = band_pair_capacity(start.capacity, n)

    def band(t, backend="cuda"):
        return _render_rows(start, cam, bg, t * rows, rows, active_sh_degree=3,
                            tile_size=16, chunk=SHARD_CHUNK, pair_cap=cap,
                            backend=backend)

    with torch.no_grad():
        whole = render_tiled(start, cam, bg, chunk=SHARD_CHUNK)
        bands = [band(t) for t in range(n)]
    check(not bool(whole["overflow"]) and not any(bool(b["overflow"])
                                                  for b in bands),
          "a band or the whole frame overflowed")
    cat = lambda k, dim: torch.cat([b[k] for b in bands], dim)
    stitched = {"render": cat("render", 1), "depth": cat("depth", 0),
                "acc": cat("acc", 0), "n_contrib": cat("n_contrib", 0)}
    err = {k: float((stitched[k] - whole[k]).abs().max())
           for k in ("render", "depth", "acc")}
    mean_rgb = float((stitched["render"] - whole["render"]).abs().mean())
    nc_eq = float((stitched["n_contrib"] == whole["n_contrib"]).float().mean())
    radii_eq = all(torch.equal(b["radii"], whole["radii"]) for b in bands)
    print(f"[shard] {n} bands of {rows} tile rows at llff frame 0 (pairs "
          f"{[int(b['num_pairs']) for b in bands]}, budget {cap} each; whole "
          f"frame {int(whole['num_pairs'])}): stitched against render_tiled "
          "max|d| " + " ".join(f"{k} {v:.3e}" for k, v in err.items())
          + f" mean|d rgb| {mean_rgb:.3e} n_contrib equal {nc_eq:.6f}; radii "
          f"equal on every band: {radii_eq}")
    check(mean_rgb <= 1e-5 and err["render"] <= 2e-2 and nc_eq >= 0.999
          and radii_eq, "the bands disagree with the whole render")

    w = torch.randn((3, H, W), generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev)

    def grads(loss_of):
        for t in start.parameters():
            t.grad = None
        loss_of().backward()
        return {k: t.grad.clone() for k, t in start.named_parameters()}

    def whole_loss():
        out = render_tiled(start, cam, bg, chunk=SHARD_CHUNK)
        return torch.sum(out["render"] * w) + 0.01 * torch.sum(out["depth"])

    def bands_loss():
        total = 0.0
        for t in range(n):
            out = band(t)
            r = slice(t * rows * 16, (t + 1) * rows * 16)
            total = total + torch.sum(out["render"] * w[:, r]) \
                + 0.01 * torch.sum(out["depth"])
        return total

    ref = grads(whole_loss)
    torch.cuda.synchronize()
    zero_counts()
    got = grads(bands_loss)
    torch.cuda.synchronize()
    launches = counts()
    for t in start.parameters():
        t.grad = None
    errs = {k: float((got[k] - ref[k]).abs().max()
                     / ref[k].abs().max().clamp_min(1e-30)) for k in ref}
    print(f"[shard] gradient of a seeded weighted sum, the {n} bands' sum "
          "against the whole render's, max |d| / group max: "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; launches {launches}")
    check(max(errs.values()) <= 5e-4,
          "the bands' gradient disagrees with the whole render's")
    check(all(v == n for v in launches.values()),
          f"launches {launches} for {n} bands' forward and backward")

    # K1, K2 and K3 against their plain versions on the band with most pairs
    t = int(np.argmax([int(b["num_pairs"]) for b in bands]))
    with torch.no_grad():
        out, plain = band(t), band(t, "torch")
    torch.cuda.synchronize()
    d_rgb = (out["render"] - plain["render"]).abs()
    nc = float((out["n_contrib"] == plain["n_contrib"]).float().mean())
    k1_err = float(d_rgb.max())
    print(f"[shard] band {t}: K1 against its plain version max |d rgb| "
          f"{k1_err:.3e} mean {float(d_rgb.mean()):.3e} max |d depth| "
          f"{float((out['depth'] - plain['depth']).abs().max()):.3e} "
          f"n_contrib equal {nc:.6f}")
    check(float(d_rgb.mean()) <= 1e-5 and k1_err <= 2e-2 and nc >= 0.999,
          f"K1 disagrees with its plain version on band {t}")
    pairs, d_rows, k2_err = check_k2(start, cam, f"1M band {t} of {n}", 0.999,
                                     band=(t, n))
    k3_err = check_vjp(pairs, d_rows)
    return launches, t, {"blend_fwd": k1_err, "blend_bwd": k2_err,
                         "repack_cols": k3_err}


def band_binning_ms(params, cam, t, n):
    """Device ms of binning and K1 alone, at band t of n (n = 1: the whole
    frame)."""
    from luciddreamer_tpu_torch.render import binning, cuda_blend
    from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians

    with torch.no_grad():
        proc, height, cap = band_proc(preprocess_gaussians(params, cam, 3),
                                      params.capacity, t, n)

        def run():
            pairs = binning.sort_pairs(proc, height, W, 16, cap)
            table = binning.gaussian_attr_table(proc)
            return cuda_blend.blend_fwd(table, pairs.src, pairs.tile_start,
                                        pairs.tile_end, W // 16)

        return min(timed(run, 10)[0] for _ in range(2))


def sharded_training(cams, dev, smi):
    """Phase 11: the sharded training path at the training main path's full
    width; returns its launches, the band compared and K1-K3's errors."""
    import torch.distributed as dist

    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.parallel import ShardedTrainer, make_mesh
    from luciddreamer_tpu_torch.parallel import multihost
    from luciddreamer_tpu_torch.parallel.dryrun import dryrun_multichip
    from luciddreamer_tpu_torch.train.loop import Trainer

    start, views = training_scene(cams, dev)
    cam, img = views[0]

    # ---- (a) the band decomposition ----
    band_launches, band_t, errs = band_decomposition(start, cam, dev)
    whole_ms = band_binning_ms(start, cam, 0, 1)
    band_ms = [band_binning_ms(start, cam, t, SHARD_TILES)
               for t in range(SHARD_TILES)]
    print(f"[shard] binning + K1, device ms: whole frame {whole_ms:.4f}; bands "
          + " ".join(f"{v:.4f}" for v in band_ms)
          + f" (sum {sum(band_ms):.4f}) | {smi}")

    # ---- (b) an NCCL world of one ----
    check(multihost.initialize(f"127.0.0.1:{free_port()}", num_processes=1,
                               process_id=0, device=dev),
          "initialize did not create a process group")
    launches = dict(band_launches)
    try:
        backend = dist.get_backend()
        check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
              f"the process group's backend is {backend}")
        mesh = make_mesh(1, 1, device=dev)
        cfg = GSConfig(iterations=SHARD_STEPS, densify_from_iter=10,
                       densification_interval=10)
        kw = dict(pair_cap=SHARD_PAIR_CAP, chunk=SHARD_CHUNK, seed=0)
        ref = Trainer(clone_params(start), cfg, 2.0, device=dev, **kw)
        ref_state = ref.run(views)
        sharded = ShardedTrainer(clone_params(start), cfg, 2.0, mesh,
                                 device=dev, **kw)
        steps = []
        inner = sharded._step
        sharded._step = lambda *a: steps.append(1) or inner(*a)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        state = sharded.run(views)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = counts()
        sharded._step = inner
        xyz_err = float((state.params.xyz - ref_state.params.xyz)
                        .detach().abs().max())
        alive_eq = torch.equal(state.params.alive, ref_state.params.alive)
        print(f"[shard] {backend} world of one, 1 x 1 mesh: ShardedTrainer "
              f"{SHARD_STEPS} iterations ({len(steps)} steps run) in "
              f"{run_s:.2f} s host time against Trainer, same seed, budget "
              f"{SHARD_PAIR_CAP} and chunk: steps {int(state.step)} / "
              f"{int(ref_state.step)}, alive equal {alive_eq} "
              f"({int(state.params.num_alive)}), max |d xyz| {xyz_err:.3e}; "
              f"launches {run_launches}")
        check(int(state.step) == int(ref_state.step) == SHARD_STEPS
              and alive_eq and xyz_err <= 2e-4,
              "ShardedTrainer does not track Trainer")
        check(all(v == len(steps) for v in run_launches.values()),
              f"launches {run_launches} for {len(steps)} sharded steps")

        cfg5 = GSConfig(iterations=OVERLAP_STEPS, densify_from_iter=10,
                        densification_interval=10)
        batch = ShardedTrainer(clone_params(start), cfg5, 2.0, mesh,
                               device=dev, **kw)
        batch_state = batch.run(views)
        overlapped = ShardedTrainer(clone_params(start), cfg5, 2.0, mesh,
                                    grad_overlap=True, device=dev, **kw)
        torch.cuda.synchronize()
        zero_counts()
        ovl_state = overlapped.run(views)
        torch.cuda.synchronize()
        ovl_launches = counts()
        # the two sum the loss in another order: an xyz entry whose gradient
        # is at rounding level may take Adam's +-lr step the other way
        unit = cfg5.position_lr_init * 2.0
        d = (ovl_state.params.xyz - batch_state.params.xyz).detach().abs() / unit
        off, ovl_err = float((d > 0.05).float().mean()), float(d.max()) * unit
        print(f"[shard] grad_overlap=True, {OVERLAP_STEPS} steps against the "
              f"batch step: max |d xyz| {ovl_err:.3e} ({ovl_err / unit:.3f} of "
              f"the xyz lr), share of entries beyond 0.05 lr {off:.2e}, steps "
              f"{int(ovl_state.step)}; launches {ovl_launches}")
        check(int(ovl_state.step) == OVERLAP_STEPS and off <= 1e-3
              and ovl_err <= 2.1 * OVERLAP_STEPS * unit,
              "the overlapped step disagrees with the batch step")
        check(all(v == OVERLAP_STEPS for v in ovl_launches.values()),
              f"launches {ovl_launches} for {OVERLAP_STEPS} overlapped steps")

        # ---- (c) the dry run ----
        zero_counts()
        dry = dryrun_multichip(1, device=dev)
        torch.cuda.synchronize()
        dry_launches = counts()
        print(f"[shard] dryrun_multichip(1): {dry}; launches {dry_launches}")
        check(all(v == 3 for v in dry_launches.values()),
              f"launches {dry_launches} for the dry run's 3 steps")
        for part in (run_launches, ovl_launches, dry_launches):
            launches = {k: launches[k] + part[k] for k in launches}

        # ---- times ----
        one = lambda tr: (lambda: tr._step(tr.state, *tr._sample(
            tr._views(views))))
        ref_step, sharded_step = one(ref), one(sharded)
        rounds = [(timed(sharded_step, 5), timed(ref_step, 5))
                  for _ in range(2)]
        for r, ((s_ms, s_wall), (t_ms, t_wall)) in enumerate(rounds):
            print(f"[shard] step round {r}: ShardedTrainer 1 x 1 device "
                  f"{s_ms:.4f} ms, host wall {s_wall:.4f} ms; Trainer device "
                  f"{t_ms:.4f} ms, host wall {t_wall:.4f} ms | {smi}")
        peak, base = peak_memory(sharded_step)
        print(f"[shard] sharded step peak device memory {peak / 2**30:.3f} GiB "
              f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} "
              "GiB held before it)")
    finally:
        dist.destroy_process_group()
    return launches, band_t, errs


# ---------------------------------------------------------- depth training

DEPTH_STEPS = 5
DEPTH_BATCH = 2


def depth_batch(cfg, seed):
    """A seeded synthetic (image, depth) batch at the model's input size:
    crops of phase 9's conditioning image, and a smooth positive depth
    field of a few low-frequency waves."""
    h, w = cfg.img_size
    rng = np.random.default_rng(seed)
    base = conditioning_image(seed=5).astype(np.float32) / 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    images, depths = [], []
    for _ in range(DEPTH_BATCH):
        y0 = int(rng.integers(0, base.shape[0] - h + 1))
        images.append(base[y0:y0 + h, :w])
        a, f = rng.uniform(0.2, 1.0, 3), rng.uniform(1.0, 4.0, 3)
        depths.append(2.0 + a[0] * np.sin(f[0] * xs) + a[1] * np.cos(f[1] * ys)
                      + a[2] * np.sin(f[2] * (xs + ys)))
    return (np.stack(images).astype(np.float32),
            np.stack(depths).astype(np.float32))


def depth_training(dev, smi):
    """Phase 12: DepthTrainer on ZoeD_N at its published geometry."""
    from luciddreamer_tpu_torch.models.depth_trainer import DepthTrainer
    from luciddreamer_tpu_torch.models.zoedepth import ZoeDepthConfig

    cfg = ZoeDepthConfig()
    tr = DepthTrainer(cfg, seed=ZOE_SEED, device=dev)
    check(all(p.device.type == dev.type for p in tr.params),
          "a parameter is not on the card")
    img, depth = depth_batch(cfg, seed=21)
    probe = {k: v.clone() for k, v in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, wall = [], [], []
    for _ in range(DEPTH_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        losses.append(tr.train_batch(img, depth))
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(v, probe[k])
                for k, v in tr.model.state_dict().items())
    flops = 3 * sum(zoe_forward_flops(cfg).values()) * DEPTH_BATCH
    best = min(ms[1:])
    print(f"[depth] ZoeD_N DepthTrainer, random weights from seed "
          f"{ZOE_SEED}, batch {DEPTH_BATCH} at {cfg.img_size[0]}x"
          f"{cfg.img_size[1]}: losses {np.round(losses, 5).tolist()}; "
          f"{moved} of {len(probe)} tensors moved; step {tr.step}")
    print(f"[depth] ms per step (device by events / host wall): "
          + "; ".join(f"{d:.2f} / {h:.2f}" for d, h in zip(ms, wall))
          + f"; {flops / 1e12:.3f} TFLOP a step (3 x a forward's, per image), "
          f"{flops / (best * 1e-3) / 1e12:.2f} TFLOP/s at the best step = "
          f"{flops / (best * 1e-3) / FP32_FLOPS_PER_S:.4f} of the fp32 peak; "
          f"peak device memory {peak / 2**30:.3f} GiB | {smi}")
    check(all(np.isfinite(losses)) and tr.step == DEPTH_STEPS,
          "a depth training loss is not finite")
    check(moved > 0.5 * len(probe), "the parameters did not change")

    bad = depth.copy()
    bad[0, 10, 10] = np.nan
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    nan_loss = tr.train_batch(img, bad)
    unchanged = all(torch.equal(v, before[k])
                    for k, v in tr.model.state_dict().items())
    print(f"[depth] a batch with a NaN depth: loss {nan_loss}, step "
          f"{tr.step}, parameters unchanged: {unchanged}")
    check(not np.isfinite(nan_loss) and tr.step == DEPTH_STEPS and unchanged,
          "a NaN batch committed an update")
    del tr, before, probe

    # the tiny configuration: one step on the card against the CPU's
    tiny = ZoeDepthConfig.tiny()
    cpu = DepthTrainer(tiny, seed=0, device="cpu")
    gpu = DepthTrainer(tiny, seed=0, device=dev)
    gpu.model.load_state_dict(cpu.model.state_dict())
    start = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    timg, tdep = depth_batch(tiny, seed=22)
    l_cpu, l_gpu = cpu.train_batch(timg, tdep), gpu.train_batch(timg, tdep)
    lr = cpu.schedule(0)
    off, total, worst = 0, 0, 0.0
    for k, v in cpu.model.state_dict().items():
        d = ((gpu.model.state_dict()[k].cpu() - start[k])
             - (v - start[k])).abs() / lr
        off += int((d > 0.05).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    print(f"[depth] tiny ZoeDepth, one step on the card against the CPU: "
          f"loss {l_gpu:.6f} / {l_cpu:.6f}; updates differ by more than "
          f"0.05 lr on {off} of {total} entries, at most {worst:.3f} lr")
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu) and off <= 1e-3 * total
          and worst <= 2.1, "the card's step disagrees with the CPU's")
    return {"ms": ms, "peak": peak}


# ------------------------------------------------------------- the viewer

VIEWER_REQUESTS = 30


def viewer_request(cam, scaling_modifier=1.0):
    """The request a SIBR viewer sends for the port's ``cam``: the
    transposed (glm) view and view-projection matrices with the y/z
    columns flipped, as ``tests/test_viewer.py`` builds them."""
    wvt = cam.viewmatrix.cpu().numpy().T.astype(np.float64)
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    vpt = cam.projmatrix.cpu().numpy().T.astype(np.float64)
    vpt[:, 1] *= -1
    return {
        "resolution_x": cam.width, "resolution_y": cam.height, "train": False,
        "fov_x": 2.0 * float(np.arctan(float(cam.tanfovx))),
        "fov_y": 2.0 * float(np.arctan(float(cam.tanfovy))),
        "z_near": cam.znear, "z_far": cam.zfar,
        "shs_python": False, "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": scaling_modifier,
        "view_matrix": wvt.reshape(-1).tolist(),
        "view_projection_matrix": vpt.reshape(-1).tolist(),
    }


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the viewer bridge closed the connection")
        buf += chunk
    return bytes(buf)


class SibrClient(threading.Thread):
    """A fake SIBR viewer on one connection: connects, sets ``connected``,
    then sends each request and reads its reply (H x W x 3 bytes when the
    request has a size, then the length-prefixed verify string).  Keeps
    the replies, each request's round trip (send to last byte received,
    host ms) and the error that stopped it, if any."""

    def __init__(self, address, messages, timeout=60.0):
        super().__init__(daemon=True)
        self.address, self.messages, self.timeout = address, messages, timeout
        self.connected = threading.Event()
        self.replies, self.round_trip_ms, self.error = [], [], None

    def run(self):
        try:
            with socket.create_connection(self.address, self.timeout) as s:
                self.connected.set()
                for msg in self.messages:
                    data = json.dumps(msg).encode()
                    t0 = time.perf_counter()
                    s.sendall(len(data).to_bytes(4, "little") + data)
                    img = _recv_exact(
                        s, msg["resolution_x"] * msg["resolution_y"] * 3)
                    n = int.from_bytes(_recv_exact(s, 4), "little")
                    verify = _recv_exact(s, n).decode("ascii")
                    self.round_trip_ms.append((time.perf_counter() - t0) * 1e3)
                    self.replies.append((img, verify))
        except OSError as e:
            self.error = e
        finally:
            self.connected.set()


def serve_requests(server, params, bg, messages, timeout=120.0):
    """Answer ``messages`` from a SibrClient through ``server.serve_once``:
    the client connects and signals, then the server polls, sleeping 1 ms
    after each empty poll, until every request is answered or ``timeout``
    passes.  Returns (the client, the count answered)."""
    client = SibrClient(server.listener.getsockname(), messages)
    client.start()
    client.connected.wait(timeout)
    deadline = time.monotonic() + timeout
    answered = 0
    while answered < len(messages) and time.monotonic() < deadline:
        if server.serve_once(params, bg):
            answered += 1
        else:
            time.sleep(0.001)
    client.join(timeout)
    return client, answered


def viewer(dev, ply_path):
    """Phase 13: the SIBR viewer bridge on phase 3's 1M scene; returns
    each kernel's launches while it answered."""
    from luciddreamer_tpu_torch.app import LucidDreamerTPU
    from luciddreamer_tpu_torch.render.tiled import render_tiled
    from luciddreamer_tpu_torch.viewer import ViewerServer, frame_bytes

    app = LucidDreamerTPU(device="cuda")
    app.load_ply(str(ply_path))
    cams = app.preset_cameras("llff")[:VIEWER_REQUESTS]
    messages = [viewer_request(c) for c in cams]
    bg = torch.zeros(3, device=dev)
    server = ViewerServer(port=0)
    try:
        torch.cuda.synchronize()
        zero_counts()
        client, answered = serve_requests(server, app.params, bg, messages)
        launches = counts()
    finally:
        server.close()
    check(client.error is None and answered == len(messages)
          == len(client.replies),
          f"the viewer answered {answered} of {len(messages)} requests, the "
          f"client read {len(client.replies)} ({client.error!r})")

    cam_err, equal, covered = 0.0, 0, []
    for cam, msg, (img, verify) in zip(cams, messages, client.replies):
        got = ViewerServer.camera_from_message(msg, dev)
        check((got.width, got.height, got.znear, got.zfar)
              == (cam.width, cam.height, cam.znear, cam.zfar),
              "camera_from_message changed the size or the clip planes")
        cam_err = max([cam_err] + [
            float((getattr(got, k) - getattr(cam, k)).abs().max())
            for k in ("viewmatrix", "projmatrix", "campos", "tanfovx",
                      "tanfovy")])
        with torch.no_grad():
            direct = render_tiled(app.params, got, bg, backend="cuda")
        equal += img == frame_bytes(direct["render"]) and verify == "ok"
        covered.append(np.count_nonzero(np.frombuffer(img, np.uint8)) / len(img))
    rt = np.asarray(client.round_trip_ms)
    print(f"[viewer] {answered} requests of {W}x{H} llff frames over one "
          f"connection, {app.params.capacity} Gaussians: round trip (send to "
          f"last byte, host wall) median {float(np.median(rt)):.4f} ms, max "
          f"{float(rt.max()):.4f} ms, first {float(rt[0]):.4f} ms; "
          f"launches {launches}")
    print(f"[viewer] replies byte-equal to a direct render of the same "
          f"camera: {equal} of {answered}; max |camera from message - "
          f"source| {cam_err:.3e}; non-zero bytes {min(covered):.4f}.."
          f"{max(covered):.4f}")
    check(cam_err <= 1e-6, f"a camera from its message is off by {cam_err:.3e}")
    check(equal == answered, "a viewer reply differs from the direct render")
    check(min(covered) >= 0.05, "a viewer reply is nearly blank")
    check(launches == {"blend_fwd": answered, "blend_bwd": 0, "repack_cols": 0},
          f"launches {launches} for {answered} viewer requests")
    return launches


# -------------------------------------------------------------- the Gradio UI

UI_BACKENDS = ("classic", "radial", "SD1.5 (default)")
UI_BUTTONS = ("Run all", "Create scene", "Render video")


def gradio_stub():
    """A stand-in ``gradio`` for phase 14 (gradio is not installed on the
    card machine, and the phase calls the bound functions itself): every
    component records its arguments in creation order, ``Button.click``
    records its binding, ``gr.Error`` is an exception.  Returns (the
    module, {"components": [...], "buttons": [...]})."""
    record = {"components": [], "buttons": []}

    class Component:
        def __init__(self, *args, **kw):
            self.args, self.kw = args, kw
            record["components"].append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Button(Component):
        bound = None

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            record["buttons"].append(self)

        def click(self, fn, inputs, outputs):
            self.bound = (fn, inputs, outputs)

    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Row", "Column", "Markdown", "Image", "Textbox",
                 "Dropdown", "Radio", "Number", "Slider", "Video", "File",
                 "Examples"):
        setattr(gr, name, type(name, (Component,), {}))
    gr.Button = Button
    gr.Error = type("Error", (Exception,), {})
    return gr, record


def _segment_table(points, n=256):
    """matplotlib's lookup table of one channel of a segmented colormap
    whose segments are continuous: ``points`` are (x, y) pairs."""
    x, y = np.asarray(points, np.float64).T
    x = x * (n - 1)
    xind = (n - 1) * np.linspace(0.0, 1.0, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    inner = distance * (y[ind] - y[ind - 1]) + y[ind - 1]
    return np.clip(np.concatenate([[y[0]], inner, [y[-1]]]), 0.0, 1.0)


JET = {"red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
       "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
                 (0.91, 0.0), (1.0, 0.0)),
       "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0))}


def video_stand_ins():
    """Stand-ins for the two modules the port's video writer imports and
    the card machine lacks (it has OpenCV and Pillow): ``imageio.mimwrite``
    encodes an mp4 (MPEG-4 part 2) through OpenCV and refuses any other
    suffix; ``matplotlib.colormaps["jet"]`` is matplotlib's jet, 256
    entries from its segment data.  Returns {name: module}."""
    def mimwrite(path, frames, fps=60, **_):
        import cv2

        if not str(path).endswith(".mp4"):
            raise ValueError(f"the imageio stand-in writes mp4 only: {path}")
        h, w = frames[0].shape[:2]
        out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (w, h))
        if not out.isOpened():
            raise RuntimeError(f"OpenCV cannot write {path}")
        try:
            for f in frames:
                out.write(cv2.cvtColor(np.ascontiguousarray(f),
                                       cv2.COLOR_RGB2BGR))
        finally:
            out.release()

    table = np.stack([_segment_table(JET[c]) for c in ("red", "green", "blue")]
                     + [np.ones(256)], axis=-1)

    def jet(x, bytes=False):
        xa = np.array(x, copy=True)
        xa *= 256
        xa[xa == 256] = 255
        lut = (table * 255).astype(np.uint8) if bytes else table
        return lut[xa.astype(int)]

    imageio = types.ModuleType("imageio")
    imageio.mimwrite = mimwrite
    matplotlib = types.ModuleType("matplotlib")
    matplotlib.colormaps = {"jet": jet}
    return {"imageio": imageio, "matplotlib": matplotlib}


def gradio_ui(dev, work):
    """Phase 14: the Gradio UI's buttons at the app's own defaults; returns
    each kernel's launches in its run."""
    from PIL import Image

    from luciddreamer_tpu_torch import app as app_mod
    from luciddreamer_tpu_torch import video as videolib
    from luciddreamer_tpu_torch.app_gradio import build_demo
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.render.binning import build_tile_bins
    from luciddreamer_tpu_torch.render.preprocess import preprocess_gaussians
    from luciddreamer_tpu_torch.utils import PhaseTimer

    gr, ui = gradio_stub()
    modules = {"gradio": gr, **{
        name: m for name, m in video_stand_ins().items()
        if importlib.util.find_spec(name) is None}}
    timer, seen = PhaseTimer(), {"writes": []}

    def timed_create(create):
        def run(self, *a, **kw):
            seen["app"] = self
            t0 = time.perf_counter()
            out = create(self, *a, timer=timer, **kw)
            torch.cuda.synchronize()
            seen["create_s"] = time.perf_counter() - t0
            return out
        return run

    def timed_write(write):
        def run(rgbs, depths, *a, **kw):
            t0 = time.perf_counter()
            out = write(rgbs, depths, *a, **kw)
            seen["writes"].append(time.perf_counter() - t0)
            return out
        return run

    image = Image.fromarray(conditioning_image(seed=5))
    with installed(modules), recorded_steps() as record, \
            wrapped(app_mod.LucidDreamerTPU, "create", timed_create), \
            wrapped(videolib, "write_videos", timed_write):
        build_demo(save_dir=str(work / "gradio"))
        bound = {b.args[0]: b.bound for b in ui["buttons"]}
        check(sorted(bound) == sorted(UI_BUTTONS)
              and all(b is not None for b in bound.values()),
              f"build_demo bound {bound}")
        run_all, render_only = bound["Run all"][0], bound["Render video"][0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        llff_paths = run_all(image, "", "", "lookdown", "llff", 1, 30,
                             *UI_BACKENDS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        back_paths = render_only("back_and_forth", *UI_BACKENDS)
        torch.cuda.synchronize()
        back_s = time.perf_counter() - t1
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        try:
            render_only("llff", "classic", "zoedepth_flax", "SD1.5 (default)")
            refused = False
        except gr.Error:
            refused = True

    app = seen["app"]
    tr = app.trainer
    views = app.scene.get_train_views()
    n_llff = len(app.scene.get_preset_cameras("llff"))
    n_back = len(app.scene.get_preset_cameras("back_and_forth"))
    steps = len(record["losses"])
    iterations = GSConfig().iterations
    losses = np.asarray([float(v) for v in record["losses"]])
    step_ms = np.asarray([a.elapsed_time(b) for a, b in record["events"]])
    psnr_before = view0_psnr(record.pop("start"), views[0])
    psnr_after = view0_psnr(app.params, views[0])
    alive, capacity = int(app.params.num_alive), app.params.capacity
    with torch.no_grad():
        pairs = np.asarray([int(build_tile_bins(
            preprocess_gaussians(app.params, v.camera, 3), H, W, 16,
            tr.pair_cap).num_pairs) for v in views])
    # the densify statistic since the last densify: each live Gaussian's
    # mean |dL/d mean2d| over the steps that saw it, in pixels
    stats, thr = tr.state.stats, tr.cfg.densify_grad_threshold
    seen_rows = app.params.alive & (stats.denom > 0)
    avg = (stats.grad_accum / stats.denom.clamp_min(1.0))[seen_rows]
    stage = timer.totals
    ply = work / "gradio" / "gsplat.ply"
    files = [Path(p) for p in (*llff_paths, *back_paths)] + [ply]
    print(f"[ui] run_all (create + llff video) {run_s:.2f} s host time; "
          f"create {seen['create_s']:.2f} s: dream {stage['dream']:.2f} s, "
          f"Scene {stage['scene']:.2f} s, bake_setup {stage['bake_setup']:.2f} "
          f"s, bake {stage['bake']:.2f} s for {steps} steps ({iterations} "
          f"committed), save_ply {stage['save_ply']:.2f} s")
    print(f"[ui] bake step: device ms by events min / median / max "
          f"{step_ms.min():.4f} / {float(np.median(step_ms)):.4f} / "
          f"{step_ms.max():.4f}; host wall {stage['bake'] * 1e3 / steps:.4f} ms "
          "per step; median by thirds of the bake "
          + " / ".join(f"{float(np.median(t)):.4f}"
                       for t in np.array_split(step_ms, 3)) + " ms")
    print(f"[ui] after the bake: {alive} live Gaussians of capacity "
          f"{capacity}; pairs of the {len(views)} training views max "
          f"{int(pairs.max())}, mean {float(pairs.mean()):.0f} against a pair "
          f"budget of {tr.pair_cap} (the app's {app_mod.MAX_PAIR_CAP}); "
          f"{steps - iterations} overflowed steps re-run; the Trainer's "
          f"overflow flag {tr.last_overflow}")
    print(f"[ui] densify statistic of the {int(seen_rows.sum())} live "
          f"Gaussians seen since the last densify: mean |dL/d mean2d| median "
          f"{float(avg.median()):.3e}, 99.9th percentile "
          f"{float(avg.quantile(0.999)):.3e}, max {float(avg.max()):.3e} per "
          f"pixel; at or above the threshold {thr}: {int((avg >= thr).sum())}; "
          f"at or above threshold / (W/2) = {thr / (W / 2):.3e} (the same rule "
          f"on a gradient in NDC units, W/2 times the pixel one): "
          f"{int((avg >= thr / (W / 2)).sum())}")
    print(f"[ui] loss first 10 mean {losses[:10].mean():.5f}, last 10 mean "
          f"{losses[-10:].mean():.5f}; PSNR of training view 0 before "
          f"{psnr_before:.3f} dB, after {psnr_after:.3f} dB")
    llff_s = run_s - seen["create_s"]
    print(f"[ui] videos (render, colourize and encode; host wall): llff "
          f"{n_llff} frames {llff_s * 1e3 / n_llff:.4f} ms per frame (writing "
          f"{seen['writes'][0] * 1e3 / n_llff:.4f}), back_and_forth {n_back} "
          f"frames {back_s * 1e3 / n_back:.4f} ms per frame (writing "
          f"{seen['writes'][1] * 1e3 / n_back:.4f}); stand-ins for "
          f"{sorted(set(modules) - {'gradio'})}; files "
          + ", ".join(f"{f.name} {f.stat().st_size if f.exists() else 0} B"
                      for f in files))
    print(f"[ui] launches {launches}; peak device memory {peak / 2**30:.3f} GiB "
          "over run_all and render_only")
    check(all(f.exists() and f.stat().st_size > 0 for f in files),
          "a video or the PLY file is missing or empty")
    check(bool(np.isfinite(losses).all()), "a bake loss is not finite")
    check(steps >= iterations, f"{steps} steps for {iterations} iterations")
    check(psnr_after > psnr_before, "the bake did not raise view 0's PSNR")
    check(capacity == CAPACITY, f"capacity {capacity}, not {CAPACITY}")
    check(launches == {"blend_fwd": steps + n_llff + n_back,
                       "blend_bwd": steps, "repack_cols": steps},
          f"launches {launches} for {steps} steps and {n_llff} + {n_back} "
          "frames")
    check(refused, "render_only rendered with a changed depth model")

    # the kernels against their plain versions on the baked scene, after
    # the counts were read, as phases 9 and 10 do
    whole_gradient(app.params, views[0].camera, "UI's baked scene, training "
                   f"view 0, pair budget {tr.pair_cap}", pair_cap=tr.pair_cap)
    check_large_frame(app.params, app.scene.get_preset_cameras("llff")[0],
                      torch.zeros(3, device=dev), "UI's baked scene, llff "
                      "frame 0")
    return launches


# ------------------------------------------------------ the model adapters

ADAPTER_BAKE_STEPS = 100
ADAPTER_FRAMES = 30
ADAPTER_DEPTH_HW = (384, 384)     # the stand-in depth map: not the image's size
ADAPTERS = ("sd", "lama", "sd_controlnet", "zoedepth")
LAMA_SEED = 13


class StandInLama(torch.nn.Module):
    """LaMa's call: image (1, 3, H, W) and mask (1, 1, H, W), 1 = hole ->
    image (1, 3, H, W) in [0, 1]; two 3x3 convolutions, seeded weights."""

    def __init__(self, seed: int):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(4, 16, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(16, 3, 3, padding=1)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, image, mask):
        x = torch.cat([image * (1 - mask), mask], 1)
        return torch.sigmoid(self.conv2(torch.relu(self.conv1(x))))


def scripted_lama(path, seed=LAMA_SEED):
    """``StandInLama(seed)`` scripted and saved at ``path``, a TorchScript
    file as big-lama.pt is; returns ``path``."""
    torch.jit.script(StandInLama(seed)).save(str(path))
    return path


def diffusers_stub():
    """A stand-in ``diffusers`` (neither machine has the package or Stable
    Diffusion weights): ``from_pretrained`` records its arguments, ``to``
    sets the pipe's device (the CPU before), and a call records its kwargs,
    checks that the generator and the control image live on the pipe's
    device, and computes its image there from its input: the inpainting
    pipe inverts the colours in the hole (1 - x), the ControlNet pipe where
    the condition is -1; exact, so the CPU and the card agree.  Returns
    (the module, {"from_pretrained": [...], "sd": [kwargs, ...],
    "sd_controlnet": [...]})."""
    from PIL import Image as PILImage

    record = {"from_pretrained": [], "sd": [], "sd_controlnet": []}

    class Result:
        def __init__(self, image):
            self.images = [image]

    class InpaintPipe:
        name = "sd"

        def __init__(self, model, controlnet):
            self.model, self.controlnet = model, controlnet
            self.device = torch.device("cpu")

        @classmethod
        def from_pretrained(cls, model, controlnet=None, **kw):
            record["from_pretrained"].append((cls.name, model, controlnet, kw))
            return cls(model, controlnet)

        def to(self, device):
            self.device = torch.device(device)
            return self

        def hole(self, kw):
            return torch.as_tensor(np.array(kw["mask_image"]),
                                   device=self.device) > 127

        def __call__(self, **kw):
            record[self.name].append(kw)
            check(kw["generator"].device.type == self.device.type,
                  f"the {self.name} pipe on {self.device} got a generator on "
                  f"{kw['generator'].device}")
            x = torch.as_tensor(np.array(kw["image"]),
                                device=self.device).to(torch.float32) / 255
            out = torch.where(self.hole(kw)[..., None], 1.0 - x, x)
            return Result(PILImage.fromarray(
                torch.round(out * 255).to(torch.uint8).cpu().numpy()))

    class ControlNetPipe(InpaintPipe):
        name = "sd_controlnet"

        def hole(self, kw):
            c = kw["control_image"]
            check(c.device.type == self.device.type,
                  f"the control image on {c.device}, the pipe on {self.device}")
            return (c[0] == -1).all(0)

    mod = types.ModuleType("diffusers")
    mod.StableDiffusionInpaintPipeline = InpaintPipe
    mod.StableDiffusionControlNetInpaintPipeline = ControlNetPipe
    mod.ControlNetModel = types.SimpleNamespace(
        from_pretrained=lambda name, **kw: {"name": name})
    return mod, record


def transformers_stub(depth_hw=ADAPTER_DEPTH_HW):
    """A stand-in ``transformers`` whose ``pipeline("depth-estimation",
    model, device)`` returns a depth map of ``depth_hw`` (another size than
    the image's, so the adapter resizes it): 3 - the image's mean
    brightness, resized bilinearly on the pipe's device.  Returns (the
    module, {"pipelines": [(model, device)], "calls": [(size, device)]})."""
    import torch.nn.functional as F

    record = {"pipelines": [], "calls": []}

    def pipeline(task, model=None, device=None):
        check(task == "depth-estimation", f"pipeline({task!r})")
        dev = torch.device("cpu" if device is None else device)
        record["pipelines"].append((model, dev))

        def run(image):
            record["calls"].append((image.size, dev))
            x = torch.as_tensor(np.array(image), device=dev).to(torch.float32)
            depth = 3.0 - x.mean(-1) / 255
            return {"predicted_depth": F.interpolate(
                depth[None, None], size=depth_hw, mode="bilinear",
                align_corners=False)[0]}
        return run

    mod = types.ModuleType("transformers")
    mod.pipeline = pipeline
    return mod, record


@contextlib.contextmanager
def adapter_stand_ins(lama_path, depth_hw=ADAPTER_DEPTH_HW):
    """Phase 15's stand-ins, inside the block only: ``diffusers_stub()`` and
    ``transformers_stub(depth_hw)`` in ``sys.modules``, and the port's
    ``utils.download.fetch_checked`` replaced by one that returns
    ``lama_path``, the scripted stand-in: no network is reached, and a
    stand-in's md5 cannot match big-lama.pt's.  The four adapters leave the
    port's registries before and after the block, so they register against
    the stand-ins and leave nothing behind.  Yields the stand-ins' records
    ({"diffusers": ..., "transformers": ...})."""
    from luciddreamer_tpu_torch.dream import protocols
    from luciddreamer_tpu_torch.utils import download

    diffusers, sd_record = diffusers_stub()
    transformers, depth_record = transformers_stub(depth_hw)

    def drop():
        for name in ADAPTERS:
            protocols._INPAINTERS.pop(name, None)
            protocols._DEPTH.pop(name, None)

    drop()
    try:
        with installed({"diffusers": diffusers, "transformers": transformers}), \
                wrapped(download, "fetch_checked",
                        lambda fetch: lambda url, dest, **kw: str(lama_path)):
            yield {"diffusers": sd_record, "transformers": depth_record}
    finally:
        drop()


def counted(factory, calls):
    """``factory(device=None)`` whose products record each call: the
    device types of the tensors passed and returned, and the call's host
    seconds (synchronised)."""
    def build(device=None):
        inner = factory(device=device)

        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            calls.append(({a.device.type for a in (*args, out)
                           if isinstance(a, torch.Tensor)},
                          time.perf_counter() - t))
            return out
        return call
    return build


def adapters_on_both_devices(dev, lama_path, image):
    """Each of the four adapters applied once on ``dev`` and once on the
    CPU to the same 512x512 input under the same stand-ins; returns
    {name: max |card - cpu|} after checking each against its tolerance."""
    from luciddreamer_tpu_torch.dream import protocols

    img = torch.as_tensor(image.astype(np.float32) / 255)
    y, x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    mask = (((x - 300) ** 2 + (y - 260) ** 2 < 90 ** 2) | (x < 40)).to(
        torch.float32)
    img[100:104, 100:110] = 0.0          # black pixels: holes for ControlNet
    # stated before the run: sd's stand-in is exact on 8-bit input, but the
    # card may divide by 255 through a reciprocal (an ulp); LaMa's
    # convolutions sum in another order (TF32 off); ControlNet rounds
    # LaMa's fill to 8 bits, so a value at a rounding edge may land one
    # grey level apart; the depth resizes bilinearly on each device
    limits = {"sd": 1e-6, "lama": 1e-5, "sd_controlnet": 1 / 255 + 1e-6,
              "zoedepth": 1e-5}
    errs = {}
    with adapter_stand_ins(lama_path) as rec:
        for name in ADAPTERS:
            outs = {}
            for d in (dev, torch.device("cpu")):
                if name == "zoedepth":
                    est = protocols.get_depth_estimator(name, device=d)
                    outs[d.type] = est(img.to(d))
                else:
                    inp = protocols.get_inpainter(name, device=d)
                    outs[d.type] = inp(img.to(d), mask.to(d), "a prompt", "",
                                       30, torch.Generator(device=d).manual_seed(3))
            card, cpu = outs[dev.type], outs["cpu"]
            check(card.device.type == dev.type and cpu.device.type == "cpu"
                  and card.shape == cpu.shape and card.dtype == torch.float32,
                  f"{name}: {card.device} {tuple(card.shape)} against "
                  f"{cpu.device} {tuple(cpu.shape)}")
            errs[name] = err = float((card.cpu() - cpu).abs().max())
            limit = limits[name] * (float(cpu.abs().max())
                                    if name == "zoedepth" else 1.0)
            check(err <= limit, f"{name} on {dev.type} against the CPU: max "
                  f"|d| {err:.3e}, limit {limit:.3e}")
        card_kw, cpu_kw = rec["diffusers"]["sd_controlnet"]
        mask_equal = np.array_equal(np.asarray(card_kw["mask_image"]),
                                    np.asarray(cpu_kw["mask_image"]))
        init_d = np.abs(np.asarray(card_kw["image"], np.int16)
                        - np.asarray(cpu_kw["image"], np.int16))
        cond_d = float((card_kw["control_image"].cpu()
                        - cpu_kw["control_image"]).abs().max())
    print(f"[adapters] {dev.type} against the CPU on one 512x512 input (a disc "
          f"and a band of holes, 40 black pixels): max |d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (zoedepth's limit {limit:.3e}); ControlNet's mask image "
          f"{'equal' if mask_equal else 'DIFFERENT'}, its init image "
          f"{int((init_d > 0).sum())} of {init_d.size} values a grey level "
          f"apart, its condition max |d| {cond_d:.3e}")
    check(mask_equal and init_d.max() <= 1 and cond_d <= 1e-5,
          "ControlNet's inputs differ between the card and the CPU")
    return errs


def model_adapters(dev, work):
    """Phase 15: the dream through the model adapters (``sd_controlnet``,
    which chains ``lama``, and ``zoedepth``) under stand-ins into the K1-K3
    bake and a video; returns each kernel's launches in its run."""
    from luciddreamer_tpu_torch import app as app_mod
    from luciddreamer_tpu_torch.config import GSConfig
    from luciddreamer_tpu_torch.dream import DreamConfig, protocols
    from luciddreamer_tpu_torch.trajectory import get_pcdgen_poses
    from luciddreamer_tpu_torch.utils import PhaseTimer
    from luciddreamer_tpu_torch.video import render_frames

    lama_path = scripted_lama(work / "big-lama.pt")
    image = conditioning_image(seed=5)
    prompt = (ROOT / "examples" / "waterfall.txt").read_text().splitlines()[0]
    calls = {"lama": [], "sd_controlnet": [], "zoedepth": []}
    marks = {}

    def progress(stage, i, n):
        if stage not in marks:
            torch.cuda.synchronize()
            marks[stage] = time.perf_counter()

    cfg = GSConfig(iterations=ADAPTER_BAKE_STEPS,
                   position_lr_max_steps=ADAPTER_BAKE_STEPS,
                   densify_from_iter=50, densification_interval=25)
    timer = PhaseTimer()
    with adapter_stand_ins(lama_path) as rec, recorded_steps() as record, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name in ("lama", "sd_controlnet"):
            protocols.register_inpainter(name, counted(
                protocols.inpainter_factory(name), calls[name]))
        protocols.register_depth_estimator("zoedepth", counted(
            protocols.depth_estimator_factory("zoedepth"), calls["zoedepth"]))
        app = app_mod.LucidDreamerTPU(
            gs_config=cfg, save_dir=tmp, device=dev,
            dream_config=DreamConfig(inpainter="sd_controlnet",
                                     depth_estimator="zoedepth"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        app.create(image, prompt, "", "lookdown", seed=1, diff_steps=30,
                   progress_callback=progress, timer=timer)
        torch.cuda.synchronize()
        create_s = time.perf_counter() - t0
        cams = app.scene.get_preset_cameras("llff")[:ADAPTER_FRAMES]
        t1 = time.perf_counter()
        rgbs, depths = render_frames(app.params, cams, [0.0, 0.0, 0.0],
                                     active_sh_degree=3, device=dev)
        torch.cuda.synchronize()
        video_s = time.perf_counter() - t1
        launches = counts()
        peak = torch.cuda.max_memory_allocated()

    views = len(get_pcdgen_poses("lookdown"))
    steps = len(record["losses"])
    losses = np.asarray([float(v) for v in record["losses"]])
    step_ms = np.asarray([a.elapsed_time(b) for a, b in record["events"]])
    train_views = app.scene.get_train_views()
    psnr_before = view0_psnr(record.pop("start"), train_views[0])
    psnr_after = view0_psnr(app.params, train_views[0])
    cloud = app.traindata["pcd_points"]
    stage = timer.totals
    dream_s = marks["align"] - t0
    cn_calls = rec["diffusers"]["sd_controlnet"]
    seeds = [kw["generator"].initial_seed() for kw in cn_calls]
    covered = [float((d > 0).mean()) for d in depths]
    ms = {k: " / ".join(f"{1e3 * f([t for _, t in v]):.2f}"
                        for f in (min, np.median, max))
          for k, v in calls.items()}
    print(f"[adapters] create with sd_controlnet (LaMa's init) and zoedepth "
          f"under stand-ins {create_s:.2f} s host time: dream loop "
          f"(conditioning and {views - 1} views) {dream_s:.2f} s, align loop "
          f"({len(train_views)} frames) {stage['dream'] - dream_s:.2f} s, Scene "
          f"{stage['scene']:.2f} s, bake_setup {stage['bake_setup']:.2f} s, "
          f"bake {stage['bake']:.2f} s for {steps} steps, save_ply "
          f"{stage['save_ply']:.2f} s")
    print(f"[adapters] calls, host ms each (synchronised) min / median / max: "
          f"sd_controlnet {len(calls['sd_controlnet'])} calls "
          f"{ms['sd_controlnet']} (LaMa inside), lama {len(calls['lama'])} "
          f"calls {ms['lama']}, zoedepth {len(calls['zoedepth'])} calls "
          f"{ms['zoedepth']}; seeds drawn from the dream's generator "
          f"{seeds[:3]}...")
    print(f"[adapters] cloud {cloud.shape[1]} points; capacity "
          f"{app.trainer.state.params.capacity}; pair budget "
          f"{app.trainer.pair_cap}; bake step: device ms by events min / "
          f"median / max {step_ms.min():.4f} / {float(np.median(step_ms)):.4f} "
          f"/ {step_ms.max():.4f}, host wall {stage['bake'] * 1e3 / steps:.4f} "
          f"ms per step; loss first 10 mean {losses[:10].mean():.5f}, last 10 "
          f"mean {losses[-10:].mean():.5f}; PSNR of training view 0 before "
          f"{psnr_before:.3f} dB, after {psnr_after:.3f} dB")
    print(f"[adapters] {len(rgbs)} llff frames in {video_s:.2f} s host time, "
          f"depth > 0 on {min(covered):.4f}..{max(covered):.4f} of pixels; "
          f"launches {launches}; peak device memory {peak / 2**30:.3f} GiB "
          "over create and the video")
    check(len(calls["sd_controlnet"]) == len(calls["lama"]) == views - 1
          and len(calls["zoedepth"]) == views,
          f"adapter calls {({k: len(v) for k, v in calls.items()})} for "
          f"{views} views, {views - 1} of them dreamed")
    check(all(devs == {dev.type} for v in calls.values() for devs, _ in v),
          "an adapter was called with, or returned, a tensor off the card")
    check(len(cn_calls) == views - 1 and all(
        kw["strength"] == 0.9 and kw["num_inference_steps"] == 30
        and kw["prompt"] == prompt and (kw["height"], kw["width"]) == (H, W)
        for kw in cn_calls) and len(set(seeds)) > 1,
        "the ControlNet pipe's arguments are wrong")
    check([d.type for _, d in rec["transformers"]["pipelines"]] == [dev.type]
          and all(size == (W, H) for size, _ in rec["transformers"]["calls"]),
          f"the depth pipelines {rec['transformers']['pipelines']}")
    check(bool(np.isfinite(cloud).all()) and cloud.shape[1] > H * W,
          "the dreamed cloud is not finite, or too small")
    check(app.trainer.state.params.capacity == CAPACITY
          and app.trainer.pair_cap == app_mod.MAX_PAIR_CAP,
          "the bake did not run at phase 9's capacity and pair budget")
    check(steps == ADAPTER_BAKE_STEPS and bool(np.isfinite(losses).all()),
          f"{steps} bake steps, or a loss that is not finite")
    check(psnr_after > psnr_before, "the bake did not raise view 0's PSNR")
    check(launches["blend_bwd"] == steps and launches["repack_cols"] == steps
          and launches["blend_fwd"] == steps + len(cams),
          f"launches {launches} for {steps} steps and {len(cams)} frames")
    check(len(rgbs) == ADAPTER_FRAMES
          and all(np.isfinite(d).all() for d in depths)
          and min(covered) >= 0.05, "the video's frames are wrong or blank")

    # the kernels against their plain versions on this path's own scene,
    # after its counts were read, as phases 9, 10 and 14 do
    whole_gradient(app.params, train_views[0].camera, "adapters' dreamed "
                   f"scene, training view 0, pair budget {app.trainer.pair_cap}",
                   pair_cap=app.trainer.pair_cap)
    check_large_frame(app.params, cams[0], torch.zeros(3, device=dev),
                      "adapters' dreamed scene, llff frame 0")
    adapters_on_both_devices(dev, lama_path, image)
    return launches


# ------------------------------------------ the JAX package's chip programs

def chip_programs(dev):
    """Phase 16: the programs that run the JAX package on its chip, through
    the port: BASELINE config 1 against the dense oracle, the drives of
    ``tools/tpu_smoke.py``, ``entry()`` against the CPU, the bench at its
    defaults and the four stages of the step's profile; returns each
    kernel's launches in the phase."""
    from luciddreamer_tpu_torch import bench, profile_step, smoke
    from luciddreamer_tpu_torch.render.tiled import aligned_pair_capacity

    zero_counts()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c1 = smoke.baseline_config1(dev)
    peak = torch.cuda.max_memory_allocated()
    c = smoke.CONFIG1
    print(f"[config1] {c['P']} Gaussians (seed {c['seed']}) {smoke.SIZE}x"
          f"{smoke.SIZE}, pair_cap {c['pair_cap']}, chunk {c['chunk']}: "
          f"{c1['num_pairs']} pairs; tiled (K1, K2, K3) {c1['tiled_s']:.2f} s, "
          f"dense oracle with per-chunk recomputation {c1['dense_s']:.2f} s, "
          f"peak device memory {peak / 2**30:.3f} GiB; max |d| render "
          f"{c1['render']:.3e} (atol {smoke.CONFIG1_RENDER_ATOL}), depth "
          f"{c1['depth']:.3e} (atol {smoke.CONFIG1_DEPTH_ATOL})")
    print("[config1] gradient, share within "
          f"{smoke.CONFIG1_GRAD_BULK} of the group's max (> "
          f"{smoke.CONFIG1_GRAD_SHARE}) / max relative error (< "
          f"{smoke.CONFIG1_GRAD_MAX}): " + ", ".join(
              f"{k} {g['share']:.6f} / {g['max_err']:.3e}"
              for k, g in c1["groups"].items()))
    check(not c1["misses"], f"BASELINE config 1: {c1['misses']}")

    d20 = smoke.drive_20k(dev)
    c = smoke.DRIVE_20K
    print(f"[tpu_smoke] 1: {c['P']} Gaussians (seed {c['seed']}), pair_cap "
          f"{c['pair_cap']}, chunk {c['chunk']}: {d20['num_pairs']} pairs, "
          f"gradients finite {all(d20['finite'].values())}, 64x64 crop "
          f"against the dense oracle max |d| {d20['crop']:.3e} (atol "
          f"{smoke.CROP_ATOL})")
    check(not d20["misses"], f"the 20k drive: {d20['misses']}")
    b4 = smoke.bench_shape(dev)
    c = smoke.BENCH_SHAPE
    print(f"[tpu_smoke] 2: the bench scene, pair_cap {c['pair_cap']} "
          f"({aligned_pair_capacity(c['pair_cap'], c['chunk'])} slots), chunk "
          f"{c['chunk']}: {b4['num_pairs']} pairs, gradients finite "
          f"{all(b4['finite'].values())}")
    check(not b4["misses"], f"the bench shape at a 4M budget: {b4['misses']}")
    ent = smoke.graft_entry(dev)
    print(f"[tpu_smoke] 3: entry() {ent['shape']} on the card against the "
          f"CPU: max |d| render {ent['render']:.3e} (atol "
          f"{smoke.ENTRY_RENDER_ATOL}), depth {ent['depth']:.3e} (atol "
          f"{smoke.ENTRY_DEPTH_ATOL})")
    check(not ent["misses"], f"entry(): {ent['misses']}")

    res = bench.run(device=dev)
    check(res["launches_per_step"] == dict.fromkeys(BLEND_KERNELS, 1.0),
          f"the bench step's launches {res['launches_per_step']}")
    rows = profile_step.run(device=dev)
    check(all(np.isfinite([r["wall_ms"], r["device_ms"]]).all() for r in rows),
          "a stage of the profile has no time")
    torch.cuda.synchronize()
    launches = counts()
    print(f"[chip programs] phase 16 in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    check(all(launches[k] > 0 for k in BLEND_KERNELS),
          f"a kernel was not launched in phase 16: {launches}")
    return launches


# ------------------------------------------------- phase 17: the last pieces

KNN_SAMPLE = 1000             # rows held against float64 at 400k and 1.2M
KNN_SMALL = 50_000            # every row held against the plain version
KNN_RTOL = 1e-5               # against float64 (three fp32 products, two sums)
# one squared distance: 3 subtractions, 3 products, 2 sums.  The function's
# bound counts the 3 distances each point returns (any exact method computes
# those; a KD-tree few more), so its bytes set it; the brute force that
# knn3_exact runs computes n (n - 1), its own bound, printed beside.
KNN_FLOPS_PER_PAIR = 8


def pcd_cloud(n, seed):
    """Phase 7's ``create_from_pcd`` cloud (seed 44: its 400k points), or
    another of ``n`` points: uniform in [-2, 2] x [-2, 2] x [2, 6]."""
    g = np.random.default_rng(seed)
    return g.uniform([-2, -2, 2], [2, 2, 6], (n, 3)).astype(np.float32)


def knn_float64(points, rows, row_block=1024, block=65536):
    """float64 mean of the 3 smallest squared distances from each of
    ``rows`` to the other points, by exact differences; missing ones 0."""
    p = points.double()
    out = []
    for r0 in range(0, rows.shape[0], row_block):
        qi = rows[r0:r0 + row_block]
        q = p[qi]
        best = torch.full((qi.shape[0], 3), float("inf"), dtype=torch.float64,
                          device=p.device)
        for c0 in range(0, p.shape[0], block):
            d = ((p[None, c0:c0 + block] - q[:, None]) ** 2).sum(-1)
            idx = torch.arange(c0, c0 + d.shape[1], device=p.device)
            d[idx[None] == qi[:, None]] = float("inf")
            blk = torch.topk(d, min(3, d.shape[1]), dim=1, largest=False).values
            best = torch.topk(torch.cat([best, blk], 1), 3, dim=1,
                              largest=False).values
        out.append(torch.where(torch.isfinite(best), best, 0.0).sum(1) / 3.0)
    return torch.cat(out)


def rel_err(out, ref):
    """max |out - ref| / |ref| (|ref| floored at 1e-30)."""
    return float(((out.double() - ref).abs() / ref.abs().clamp_min(1e-30)).max())


def kdtree_knn():
    """The code ``knn3_exact`` replaces, the JAX package's host KD-tree
    (``luciddreamer_tpu/native/knn_native.cpp``, one thread), compiled by
    g++ with that package's flags into ``build/kdtree/`` and called through
    ctypes; no Python module of that package is imported.  Returns a
    function (n, 3) float32 array -> (n,) float32 array."""
    src = ROOT / "luciddreamer_tpu" / "native" / "knn_native.cpp"
    lib_path = ROOT / "build" / "kdtree" / "_knn_native.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", str(src), "-o", str(lib_path)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).mean_sq_dist_3nn
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]

    def knn(points):
        pts = np.ascontiguousarray(points, np.float32)
        out = np.empty(pts.shape[0], np.float32)
        fn(pts.ctypes.data, pts.shape[0], out.ctypes.data)
        return out
    return knn


def exact_knn(dev, smi):
    """Phase 17 (a): ``knn3_exact`` through ``mean_sq_dist_3nn_exact`` on
    50k seeded points, phase 7's 400k cloud and 1.2M, held against its
    plain version and float64, with edge cases and times; returns its
    kernels-line row."""
    from luciddreamer_tpu_torch.points import knn_exact
    from luciddreamer_tpu_torch.points.knn import mean_sq_dist_3nn

    wrapper = knn_exact.mean_sq_dist_3nn_exact
    plain = knn_exact.mean_sq_dist_3nn_exact_torch
    clouds = {n: torch.as_tensor(pcd_cloud(n, 44 if n == PCD_POINTS else 45 + i),
                                 device=dev)
              for i, n in enumerate((KNN_SMALL, PCD_POINTS, CAPACITY))}
    # ---- the main path: the entry point on each cloud ----
    torch.cuda.synchronize()
    wrapper.launches = 0
    outs = {n: wrapper(p) for n, p in clouds.items()}
    torch.cuda.synchronize()
    launches = wrapper.launches
    check(launches == len(clouds), f"knn3_exact launched {launches} times for "
          f"{len(clouds)} clouds")

    # ---- against the plain version and float64 ----
    g = np.random.default_rng(46)
    worst = 0.0
    small = plain(clouds[KNN_SMALL])
    check(torch.equal(outs[KNN_SMALL], small),
          f"knn3_exact differs from its plain version at {KNN_SMALL} points")
    formula = {}
    for n, p in clouds.items():
        rows = torch.as_tensor(np.sort(g.choice(n, KNN_SAMPLE, replace=False)),
                               device=dev)
        ref = knn_float64(p, rows)
        got, want = outs[n][rows], plain(p, rows)
        eq = torch.equal(got, want)
        worst = max(worst, float((got - want).abs().max()))
        rk, rp = rel_err(got, ref), rel_err(want, ref)
        rf = "not run"
        if n != KNN_SMALL:      # one call, timed: it takes seconds
            f_ms, f_out = timed(lambda: mean_sq_dist_3nn(p), 1, once=True)
            formula[n] = f_ms
            rf = f"{rel_err(f_out[rows], ref):.3e}"
            del f_out
        print(f"[knn] {n} points: kernel against plain on {KNN_SAMPLE} "
              f"sampled rows bit-equal {eq}; max relative error against "
              f"float64: kernel {rk:.3e}, plain {rp:.3e}, the formula knn "
              f"(points/knn.py) {rf} (limit {KNN_RTOL})")
        check(eq and rk <= KNN_RTOL and rp <= KNN_RTOL,
              f"knn3_exact disagrees at {n} points")

    # ---- edge cases ----
    rng = np.random.default_rng(47)
    edge = {f"n={n}": rng.normal(size=(n, 3)) for n in range(5)}
    edge["duplicates"] = np.repeat(rng.normal(size=(2000, 3)), 3, axis=0)
    edge["far from the origin"] = rng.normal(size=(20_000, 3)) + 1e3
    for name, pts in edge.items():
        p = torch.as_tensor(pts.astype(np.float32), device=dev)
        got, want = wrapper(p), plain(p)
        torch.cuda.synchronize()
        eq = torch.equal(got, want) and got.shape == (p.shape[0],)
        rows = torch.arange(p.shape[0], device=dev)
        ref = knn_float64(p, rows) if p.shape[0] else got.double()
        ok = bool(((got.double() - ref).abs()
                   <= KNN_RTOL * ref.abs() + 1e-7).all())
        miss = ""
        if name == "far from the origin":
            miss = (f"; the formula knn's max relative error "
                    f"{rel_err(mean_sq_dist_3nn(p), ref):.3e}")
        print(f"[knn] edge case {name}: bit-equal to plain {eq}, within "
              f"{KNN_RTOL} of float64 {ok}{miss}")
        check(eq and ok, f"knn3_exact fails the edge case {name}")

    # ---- times (these launches are not the main path's) ----
    kdtree, times = kdtree_knn(), {}
    for n in (PCD_POINTS, CAPACITY):
        p = clouds[n]
        ms, _ = timed(lambda: wrapper(p), 5 if n == PCD_POINTS else 2)
        host = p.cpu().numpy()
        t0 = time.perf_counter()
        tree = kdtree(host)
        tree_ms = (time.perf_counter() - t0) * 1e3
        ref = outs[n].cpu().numpy()
        tree_ok = bool((np.abs(ref - tree) <= KNN_RTOL * np.abs(tree) + 1e-7).all())
        bound, by, parts = bound_of(16 * n, KNN_FLOPS_PER_PAIR * 3 * n, 0)
        brute_ms = KNN_FLOPS_PER_PAIR * n * (n - 1) / FP32_FLOPS_PER_S * 1e3
        times[n] = dict(ms=ms, bound_ms=bound, bound_by=by,
                        bytes_bound_ms=parts["bytes"],
                        operations_bound_ms=parts["operations"],
                        brute_force_bound_ms=brute_ms, kdtree_ms=tree_ms)
        print(f"[knn] {n} points: knn3_exact {ms:.4f} ms by events against "
              f"the function's bound {bound:.4f} ({by}; {ms and bound / ms:.4%} "
              f"of it) and the brute force's own bound {brute_ms:.4f} (n (n - "
              f"1) pairs of {KNN_FLOPS_PER_PAIR} fp32 operations; "
              f"{ms and brute_ms / ms:.1%} of it); the JAX package's host "
              f"KD-tree {tree_ms:.4f} ms (one call, one thread, host clock; "
              f"every row within {KNN_RTOL} of the kernel {tree_ok}); the "
              f"formula knn {formula[n]:.4f} ms (one call) | {smi}")
        check(tree_ok, f"knn3_exact disagrees with the KD-tree at {n} points")
    plain_ms, full = timed(lambda: plain(clouds[PCD_POINTS]), 1, once=True)
    check(torch.equal(full, outs[PCD_POINTS]),
          f"knn3_exact differs from its plain version at {PCD_POINTS} points")
    print(f"[knn] {PCD_POINTS} points, every row: the plain version "
          f"{plain_ms:.4f} ms (one call), bit-equal to the kernel | {smi}")
    return {"name": "knn3_exact", "route": "cuda",
            "source": "luciddreamer_tpu_torch/csrc/knn3_exact.cu",
            "replaces": "luciddreamer_tpu/native/knn_native.cpp:109",
            "note": "the JAX package's host C++ knn, not a TPU kernel",
            "launches": launches, "max_abs_err": worst,
            **times[PCD_POINTS], "plain_ms": plain_ms, "library_ms": None,
            "formula_knn_ms": formula[PCD_POINTS],
            "at_1.2M": dict(times[CAPACITY],
                            formula_knn_ms=formula[CAPACITY])}


def overlap_trace(dev, smi):
    """Phase 17 (b): ``grad_overlap.run`` (the twin of
    ``tools/grad_overlap.py``) at its own configuration in an NCCL world
    of one; returns K1-K3's launches in it."""
    import torch.distributed as dist

    from luciddreamer_tpu_torch import grad_overlap
    from luciddreamer_tpu_torch.parallel import make_mesh, multihost

    check(multihost.initialize(f"127.0.0.1:{free_port()}", num_processes=1,
                               process_id=0, device=dev),
          "initialize did not create a process group")
    try:
        mesh = make_mesh(1, 1, device=dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        rep = grad_overlap.run(mesh, dev)
        torch.cuda.synchronize()
        launches = counts()
        run_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    lines = grad_overlap.report_lines(rep)
    for line in lines:
        print(line)
    steps = sum(rep["steps_run"].values())
    print(f"[grad_overlap] {run_s:.1f} s host time, {steps} steps and "
          f"{rep['target_renders']} target render; launches {launches} | {smi}")
    check(launches == {"blend_fwd": steps + rep["target_renders"],
                       "blend_bwd": steps, "repack_cols": steps},
          f"launches {launches} for the twin's {steps} steps and "
          f"{rep['target_renders']} target renders")
    for name in ("batch", "overlapped"):
        r = rep[name]
        check(r["kernels"] == dict.fromkeys(BLEND_KERNELS, 1.0),
              f"the {name} step's trace has K1-K3 {r['kernels']} a step")
        check(not r["overflow"], f"the {name} step overflowed")
    check(not any("SendRecv" in w for w in rep["overlapped"]["window_names"]),
          "a ring window in a world of one")
    check(rep["agreement"]["ok"], "the overlapped step disagrees with the "
          f"batch step: {rep['agreement']}")
    check(lines[-1].startswith("VERDICT: "), "no verdict")
    return launches


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
    (ROOT / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            work = Path(tmp)
            print_build_report()
            bg = torch.zeros(3, device=dev)
            app, cams, k1 = serving(bg, dev, work / "scene.ply")

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
            dream, radial_dream_s = dream_to_video(dev)
            zoe = depth_model(dev, radial_dream_s)
            shard, shard_band, shard_errs = sharded_training(cams, dev, smi)
            depth_training(dev, smi)
            view = viewer(dev, work / "scene.ply")
            ui = gradio_ui(dev, work)
            adapt = model_adapters(dev, work)
            progs = chip_programs(dev)
            knn = exact_knn(dev, smi)
            ovl = overlap_trace(dev, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases in {time.time() - t_start:.1f} s")

    source = "luciddreamer_tpu_torch/csrc/{}.cu".format
    launches = {k: train["launches"][k] + dream[k] + zoe[k] + shard[k]
                + view[k] + ui[k] + adapt[k] + progs[k] + ovl[k]
                for k in BLEND_KERNELS}
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
        knn,
    ]
    print(f"[done] launches by path: serving {{'blend_fwd': "
          f"{k1['serve_launches']}}}, training {train['launches']}, dream to "
          f"video {dream}, dream with ZoeD_N {zoe}, sharded training "
          f"{shard}, viewer {view}, Gradio UI {ui}, model adapters {adapt}, "
          f"the JAX package's chip programs {progs}, the overlap twin "
          f"{ovl}, the exact knn {{'knn3_exact': {knn['launches']}}}; "
          f"K1-K3 on band "
          f"{shard_band}: max |d| {shard_errs}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
