"""Kernels K1 (forward tile blend, ``csrc/blend_fwd.cu``) and K2 (its
backward, ``csrc/blend_bwd.cu``) as hand-written CUDA kernels for Hopper,
tied together by a ``torch.autograd.Function``.

K1 replaces ``luciddreamer_tpu/render/pallas_blend.py::_fwd_kernel`` and K2
``_bwd_kernel``/``_bwd_chunk_body``; both run one thread block per 16x16
tile and one thread per pixel, see the sources for their design and what
bounds them on the card.  K2's launch function zero-fills its output and
then runs the kernel, which sums each pair's gradient only over the warps
where a pixel committed and loads its batches with ``cp.async``.  They are
built at first use by ``kernels``.

``blend_fwd`` and ``blend_bwd`` launch the kernels on CUDA tensors and
count each launch in ``blend_fwd.launches`` / ``blend_bwd.launches``.
``blend_tiles`` is the differentiable entry point: on CUDA tensors its
forward is K1 and its backward K2, with no fallback; on CPU tensors, or
with ``plain=True``, the same Function runs the plain versions
(``torch_blend.blend_tiles_torch`` and ``blend_tiles_bwd_torch``).
"""
from __future__ import annotations

import ctypes

import torch

from luciddreamer_tpu_torch.render import blend_math, kernels, torch_blend
from luciddreamer_tpu_torch.render.binning import ATTR_DIM

TILE_SIZE = 16
STATE_ROWS = 7          # T, r, g, b, depth, acc, done
_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P] * 5 + [_I, _I, _P]
_BWD_ARGS = [_P] * 6 + [ctypes.c_longlong, _I, _I, _P]


def _check_inputs(attrs, tile_start, tile_end, *states):
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
    shape = (num_tiles, STATE_ROWS, TILE_SIZE * TILE_SIZE)
    for t in states:
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != attrs.device):
            raise ValueError(f"state tensors must be contiguous float32 {shape} "
                             f"on {attrs.device}")
    return num_tiles


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def blend_fwd(attrs, tile_start, tile_end, grid_x):
    """Launch K1: returns the (num_tiles, 7, 256) state and the
    (num_tiles, 256) int32 n_contrib."""
    num_tiles = _check_inputs(attrs, tile_start, tile_end)
    npix = TILE_SIZE * TILE_SIZE
    state = attrs.new_empty((num_tiles, STATE_ROWS, npix))
    n_contrib = torch.empty((num_tiles, npix), dtype=torch.int32,
                            device=attrs.device)
    kernels.launch(
        "blend_fwd", _FWD_ARGS, attrs.data_ptr(), tile_start.data_ptr(),
        tile_end.data_ptr(), state.data_ptr(), n_contrib.data_ptr(),
        num_tiles, grid_x, _stream(attrs.device),
    )
    blend_fwd.launches += 1
    return state, n_contrib


def blend_bwd(attrs, tile_start, tile_end, state, d_state, grid_x):
    """Launch K2: returns the (pair_cap, 16) gradient of ``attrs``."""
    num_tiles = _check_inputs(attrs, tile_start, tile_end, state, d_state)
    d_attrs = torch.empty_like(attrs)
    kernels.launch(
        "blend_bwd", _BWD_ARGS, attrs.data_ptr(), tile_start.data_ptr(),
        tile_end.data_ptr(), state.data_ptr(), d_state.data_ptr(),
        d_attrs.data_ptr(), attrs.shape[0], num_tiles, grid_x,
        _stream(attrs.device),
    )
    blend_bwd.launches += 1
    return d_attrs


blend_fwd.launches = 0
blend_bwd.launches = 0


def blend_fwd_torch(attrs, tile_start, tile_end, grid_x, tile_size, chunk):
    """The plain forward, packed like K1's output."""
    c = torch_blend.blend_tiles_torch(attrs, tile_start, tile_end, grid_x,
                                      tile_size, chunk)
    state = torch.cat([c.T[:, None], c.rgb, c.depth[:, None], c.acc[:, None],
                       c.done[:, None].to(torch.float32)], dim=1)
    return state, c.n_contrib


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, tile_start, tile_end, grid_x, tile_size, chunk,
                plain):
        if plain:
            state, n_contrib = blend_fwd_torch(attrs, tile_start, tile_end,
                                               grid_x, tile_size, chunk)
        else:
            state, n_contrib = blend_fwd(attrs, tile_start, tile_end, grid_x)
        ctx.save_for_backward(attrs, tile_start, tile_end, state)
        ctx.args = (grid_x, tile_size, chunk, plain)
        ctx.mark_non_differentiable(n_contrib)
        return state, n_contrib

    @staticmethod
    def backward(ctx, d_state, _):
        attrs, tile_start, tile_end, state = ctx.saved_tensors
        grid_x, tile_size, chunk, plain = ctx.args
        d_state = d_state.contiguous()
        if plain:
            d_attrs = torch_blend.blend_tiles_bwd_torch(
                attrs, tile_start, tile_end, state, d_state, grid_x,
                tile_size, chunk)
        else:
            d_attrs = blend_bwd(attrs, tile_start, tile_end, state, d_state,
                                grid_x)
        return d_attrs, None, None, None, None, None, None


def blend_tiles(
    attrs: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    grid_x: int,
    tile_size: int = TILE_SIZE,
    chunk: int = 128,
    plain: bool = False,
) -> blend_math.BlendCarry:
    """Composite every tile's range of the sorted pair stream,
    differentiably in ``attrs``.

    Returns a carry of (num_tiles, 256) per-pixel fields, ``rgb`` being
    (num_tiles, 3, 256).  ``chunk`` is used only by the plain versions,
    which run for CPU tensors or when ``plain`` is set.
    """
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blend_tiles: unsupported device {attrs.device}")
    plain = plain or attrs.device.type == "cpu"
    if not plain and tile_size != TILE_SIZE:
        raise ValueError(f"the CUDA blend needs tile_size {TILE_SIZE}, got {tile_size}")
    state, n_contrib = _Blend.apply(attrs, tile_start, tile_end, grid_x,
                                    tile_size, chunk, plain)
    return blend_math.BlendCarry(
        T=state[:, 0], rgb=state[:, 1:4], depth=state[:, 4], acc=state[:, 5],
        done=state[:, 6] > 0.5, n_contrib=n_contrib,
    )
