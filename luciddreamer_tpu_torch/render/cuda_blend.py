"""Kernel K1, the forward tile blend, as a hand-written CUDA kernel for
Hopper (``csrc/blend_fwd.cu``).

Replaces ``luciddreamer_tpu/render/pallas_blend.py::_fwd_kernel``.  One
thread block per 16x16 tile, one thread per pixel; see the source for the
design and for what bounds it on the card.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout and loaded with ``ctypes``;
a failed build raises.  ``blend_tiles`` launches it for CUDA tensors and
counts each launch in ``blend_tiles.launches``.  For tensors on the CPU it
runs the plain PyTorch version (``torch_blend.blend_tiles_torch``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from luciddreamer_tpu_torch.render import blend_math, torch_blend
from luciddreamer_tpu_torch.render.binning import ATTR_DIM

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "blend_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
TILE_SIZE = 16
STATE_ROWS = 7

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the blend kernel cannot be built")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"blend_fwd_{digest}.so"


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library.
    The compiler's output, ptxas's register and shared-memory report
    included, is kept beside it as ``.log``."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.blend_fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.blend_fwd.restype = ctypes.c_int
    lib.blend_fwd_error_string.argtypes = [ctypes.c_int]
    lib.blend_fwd_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def blend_tiles(
    attrs: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    grid_x: int,
    tile_size: int = TILE_SIZE,
    chunk: int = 128,
) -> blend_math.BlendCarry:
    """Composite every tile's range of the sorted pair stream.

    Returns a carry of (num_tiles, 256) per-pixel fields, ``rgb`` being
    (num_tiles, 3, 256).  ``chunk`` is used only by the plain version.
    """
    if attrs.device.type == "cpu":
        return torch_blend.blend_tiles_torch(
            attrs, tile_start, tile_end, grid_x, tile_size, chunk
        )
    if attrs.device.type != "cuda":
        raise ValueError(f"blend_tiles: unsupported device {attrs.device}")
    if tile_size != TILE_SIZE:
        raise ValueError(f"the CUDA blend needs tile_size {TILE_SIZE}, got {tile_size}")
    if torch.is_grad_enabled() and attrs.requires_grad:
        raise RuntimeError(
            "the CUDA forward blend has no backward yet; call it under "
            "torch.no_grad() or use backend='torch'"
        )
    if (attrs.dtype != torch.float32 or attrs.dim() != 2
            or attrs.shape[1] != ATTR_DIM or not attrs.is_contiguous()):
        raise ValueError(
            f"attrs must be contiguous float32 (N, {ATTR_DIM}), got "
            f"{attrs.dtype} {tuple(attrs.shape)}"
        )
    if attrs.shape[0] >= 2**31:
        raise ValueError("pair capacity must be below 2^31 rows")
    num_tiles = tile_start.shape[0]
    for name, t in (("tile_start", tile_start), ("tile_end", tile_end)):
        if (t.dtype != torch.int32 or t.shape != (num_tiles,)
                or not t.is_contiguous() or t.device != attrs.device):
            raise ValueError(f"{name} must be contiguous int32 ({num_tiles},) "
                             f"on {attrs.device}")

    lib = build()
    npix = TILE_SIZE * TILE_SIZE
    state = torch.empty((num_tiles, STATE_ROWS, npix), dtype=torch.float32,
                        device=attrs.device)
    n_contrib = torch.empty((num_tiles, npix), dtype=torch.int32,
                            device=attrs.device)
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blend_fwd(
            attrs.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
            state.data_ptr(), n_contrib.data_ptr(), num_tiles, grid_x, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"blend_fwd launch failed: {lib.blend_fwd_error_string(err).decode()}"
        )
    blend_tiles.launches += 1
    return blend_math.BlendCarry(
        T=state[:, 0], rgb=state[:, 1:4], depth=state[:, 4], acc=state[:, 5],
        done=state[:, 6] > 0.5, n_contrib=n_contrib,
    )


blend_tiles.launches = 0
