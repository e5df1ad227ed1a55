"""The least time an H100 could take for the work of K1 (``csrc/blend_fwd.cu``),
K2 (``csrc/blend_bwd.cu``) and K3 (``csrc/repack_cols.cu``), and the
operations of a whole frame and training step, all counted from the inputs.

The counts read the pair stream through ``blend_cases.blend_work``, which
walks it as the plain version does, so they say what the inputs need and
not what a kernel does: a kernel that skips dead work leaves them
unchanged.  ``chip_smoke.py`` and the benchmark print their bounds from
here.
"""
from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 rate
# and fp32 rate outside the tensor cores.  The special-function rate (exp,
# reciprocal) is 16 MUFU ops/clk/SM (Hopper architecture white paper) x 132
# SMs x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

TILE_PIXELS = 256
RANGE_BYTES = 2 * 4                # a tile's int32 start and end
# K1 per evaluated (pair, pixel) product: dx, dy and power are 11 FLOPs;
# where power <= 0 one exp and one multiply; a commit adds 1-alpha, T*(..),
# w and five accumulations, 12 FLOPs.  Bytes per walked row (a row before
# its tile's last pixel is done; nothing after that reaches the output):
# the 11 channels read and its src entry (the table row it reads).  Per
# pixel it writes 7 state rows and n_contrib.
FLOPS_EVAL, FLOPS_EXP_PATH, FLOPS_COMMIT = 11, 1, 12
BYTES_PER_ROW = 11 * 4 + 4
K1_PIXEL_BYTES = 8 * 4
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
K3_BYTES_COUNT = 8                 # the live count
# Preprocess, per Gaussian, counted stage by stage in render/preprocess.py
# and core/{covariance,sh}.py as written: activations 19, cull 7,
# projection 31, 3D covariance 78, its EWA projection 145, conic 9, sigma
# 9, radius 2, the 1/255 level 13, tile rects 51, SH degree 3 to RGB 160.
PREPROCESS_FLOPS = 19 + 7 + 31 + 78 + 145 + 9 + 9 + 2 + 13 + 51 + 160
# Its backward (one kernel, csrc/preprocess_bwd.cu, on the card): about two
# operations per forward operation, each forward operation's derivative a
# multiply and an accumulate; a count of the function, not of the kernel.
PREPROCESS_BWD_FLOPS = 2 * PREPROCESS_FLOPS
# The binning VJP per live pair: one add into each of the 10 channels'
# prefix sums (K3 itself moves data and computes nothing).
VJP_FLOPS_PER_PAIR = 10


def bound_of(nbytes, flops, sfu_ops):
    """(bound ms, "bytes" or "operations", both bounds) on the published
    peaks."""
    bound = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(flops / FP32_FLOPS_PER_S, sfu_ops / SFU_OPS_PER_S) * 1e3,
    }
    by = max(bound, key=bound.get)
    return bound[by], by, bound


def k1_cost(work, num_tiles):
    """(bytes, fp32 FLOPs, SFU ops) K1's inputs need: ``work`` is
    ``blend_work`` of its pair stream."""
    nbytes = (int(work["walked"].sum()) * BYTES_PER_ROW
              + num_tiles * (RANGE_BYTES + TILE_PIXELS * K1_PIXEL_BYTES))
    flops = (work["evaluated"] * FLOPS_EVAL + work["exps"] * FLOPS_EXP_PATH
             + work["commits"] * FLOPS_COMMIT)
    return nbytes, flops, work["exps"]


def k1_staged_bytes(work, tile_start, tile_end):
    """The bytes K1's design reads: the batch in which a tile's last pixel
    is done and the one after it, already in flight, or the whole range."""
    lengths = (tile_end - tile_start).long()
    walked = work["walked"]
    staged = lengths.minimum(K1_BATCH * (-(-walked // K1_BATCH) + 1))
    return (int(staged.sum()) * K1_STAGED_ROW_BYTES
            + lengths.shape[0] * (RANGE_BYTES + TILE_PIXELS * K1_PIXEL_BYTES))


def k2_cost(work, num_pairs, num_tiles):
    """(bytes, fp32 FLOPs, SFU ops) K2's inputs need on a stream of
    ``num_pairs`` live pairs."""
    nbytes = (int(work["walked"].sum()) * K2_READ_PER_ROW
              + num_pairs * K2_WRITE_PER_PAIR
              + num_tiles * (RANGE_BYTES + TILE_PIXELS * K2_PIXEL_BYTES))
    flops = (work["evaluated"] * FLOPS_EVAL + work["exps"] * FLOPS_EXP_PATH
             + work["commits"] * FLOPS_K2_COMMIT)
    return nbytes, flops, work["exps"] + work["commits"]


def k3_cost(num_pairs, slots):
    """(bytes, fp32 FLOPs, SFU ops) of K3 on ``num_pairs`` live rows of
    ``slots``: it moves data only."""
    return (num_pairs * K3_BYTES_READ
            + slots * (K3_BYTES_ORDER + K3_BYTES_WRITE) + K3_BYTES_COUNT, 0, 0)


def frame_flops(num_gaussians, work, num_tiles):
    """fp32 operations of one forward frame: preprocess per Gaussian and
    K1's evaluated products and commits."""
    return num_gaussians * PREPROCESS_FLOPS + k1_cost(work, num_tiles)[1]


def step_flops(num_gaussians, work, num_pairs, num_tiles):
    """fp32 operations of one training step: the frame's, K2's, the binning
    VJP's per pair and the preprocess backward per Gaussian."""
    return (frame_flops(num_gaussians, work, num_tiles)
            + k2_cost(work, num_pairs, num_tiles)[1]
            + num_pairs * VJP_FLOPS_PER_PAIR
            + num_gaussians * PREPROCESS_BWD_FLOPS)
