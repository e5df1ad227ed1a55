"""Kernels K1 (forward tile blend, ``csrc/blend_fwd.cu``) and K2 (its
backward, ``csrc/blend_bwd.cu``) as hand-written CUDA kernels for Hopper,
tied together by a ``torch.autograd.Function``.

K1 replaces ``luciddreamer_tpu/render/pallas_blend.py::_fwd_kernel`` and K2
``_bwd_kernel``/``_bwd_chunk_body``; both run one thread block per 16x16
tile and one thread per pixel, see the sources for their design and what
bounds them on the card.  Both read row i of the sorted pair stream as
``table[src[i]]``, straight from the (P+1, 16) attribute table through the
pair sort's owner index, in ``cp.async`` batches; no stream-order copy of
the rows is made on the CUDA path.  K2's launch function zero-fills its
(pair_cap, 16) stream-order output and then runs the kernel, which sums
each pair's gradient only over the warps where a pixel committed.  They are
built at first use by ``kernels``.

``blend_fwd`` and ``blend_bwd`` launch the kernels on CUDA tensors and
count each launch in ``blend_fwd.launches`` / ``blend_bwd.launches``.
``blend_tiles`` is the differentiable entry point, in the attribute table
of a ``binning.TileBins``: on CUDA tensors its forward is K1 and its
backward K2 followed by ``binning.gather_vjp`` (K3, a prefix sum and a
boundary gather), with no fallback; on CPU tensors, or with
``plain=True``, the same Function runs the plain versions
(``torch_blend.blend_tiles_torch`` and ``blend_tiles_bwd_torch``) on the
rows ``binning.pair_rows`` builds.
"""
from __future__ import annotations

import ctypes

import torch

from luciddreamer_tpu_torch.render import binning, blend_math, kernels, torch_blend
from luciddreamer_tpu_torch.render.binning import ATTR_DIM

TILE_SIZE = 16
STATE_ROWS = 7          # T, r, g, b, depth, acc, done
_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P] * 6 + [_I, _I, _I, _P]
_BWD_ARGS = [_P] * 7 + [_I, ctypes.c_longlong, _I, _I, _P]


def _check_inputs(table, src, tile_start, tile_end, *states):
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != ATTR_DIM or not table.is_contiguous()):
        raise ValueError(
            f"table must be contiguous float32 (N, {ATTR_DIM}), got "
            f"{table.dtype} {tuple(table.shape)}"
        )
    if not 0 < table.shape[0] < 2**31:
        raise ValueError("the table must have between 1 and 2^31 - 1 rows")
    if (src.dtype != torch.int32 or src.dim() != 1 or not src.is_contiguous()
            or src.device != table.device):
        raise ValueError(f"src must be contiguous int32 (pair_cap,) on "
                         f"{table.device}, got {src.dtype} {tuple(src.shape)} "
                         f"on {src.device}")
    if src.shape[0] >= 2**31:
        raise ValueError("pair capacity must be below 2^31 rows")
    num_tiles = tile_start.shape[0]
    for name, t in (("tile_start", tile_start), ("tile_end", tile_end)):
        if (t.dtype != torch.int32 or t.shape != (num_tiles,)
                or not t.is_contiguous() or t.device != table.device):
            raise ValueError(f"{name} must be contiguous int32 ({num_tiles},) "
                             f"on {table.device}")
    shape = (num_tiles, STATE_ROWS, TILE_SIZE * TILE_SIZE)
    for t in states:
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != table.device):
            raise ValueError(f"state tensors must be contiguous float32 {shape} "
                             f"on {table.device}")
    return num_tiles


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def blend_fwd(table, src, tile_start, tile_end, grid_x):
    """Launch K1 on the stream whose row i is ``table[src[i]]``: returns the
    (num_tiles, 7, 256) state and the (num_tiles, 256) int32 n_contrib."""
    num_tiles = _check_inputs(table, src, tile_start, tile_end)
    npix = TILE_SIZE * TILE_SIZE
    state = table.new_empty((num_tiles, STATE_ROWS, npix))
    n_contrib = torch.empty((num_tiles, npix), dtype=torch.int32,
                            device=table.device)
    kernels.launch(
        "blend_fwd", _FWD_ARGS, table.data_ptr(), src.data_ptr(),
        tile_start.data_ptr(), tile_end.data_ptr(), state.data_ptr(),
        n_contrib.data_ptr(), table.shape[0], num_tiles, grid_x,
        _stream(table.device),
    )
    blend_fwd.launches += 1
    return state, n_contrib


def blend_bwd(table, src, tile_start, tile_end, state, d_state, grid_x):
    """Launch K2: returns the (pair_cap, 16) gradient of the stream's rows
    ``table[src]``, in stream order."""
    num_tiles = _check_inputs(table, src, tile_start, tile_end, state, d_state)
    d_rows = table.new_empty((src.shape[0], ATTR_DIM))
    kernels.launch(
        "blend_bwd", _BWD_ARGS, table.data_ptr(), src.data_ptr(),
        tile_start.data_ptr(), tile_end.data_ptr(), state.data_ptr(),
        d_state.data_ptr(), d_rows.data_ptr(), table.shape[0], src.shape[0],
        num_tiles, grid_x, _stream(table.device),
    )
    blend_bwd.launches += 1
    return d_rows


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
    def forward(ctx, table, src, order, offsets_p1, total, tile_start,
                tile_end, grid_x, tile_size, chunk, plain):
        if plain:
            state, n_contrib = blend_fwd_torch(
                binning.pair_rows(table, src), tile_start, tile_end,
                grid_x, tile_size, chunk)
        else:
            state, n_contrib = blend_fwd(table, src, tile_start, tile_end,
                                         grid_x)
        ctx.save_for_backward(table, src, order, offsets_p1, total,
                              tile_start, tile_end, state)
        ctx.args = (grid_x, tile_size, chunk, plain)
        ctx.mark_non_differentiable(n_contrib)
        return state, n_contrib

    @staticmethod
    def backward(ctx, d_state, _):
        (table, src, order, offsets_p1, total, tile_start, tile_end,
         state) = ctx.saved_tensors
        grid_x, tile_size, chunk, plain = ctx.args
        d_state = d_state.contiguous()
        if plain:
            d_rows = torch_blend.blend_tiles_bwd_torch(
                binning.pair_rows(table, src), tile_start, tile_end,
                state, d_state, grid_x, tile_size, chunk)
        else:
            d_rows = blend_bwd(table, src, tile_start, tile_end, state,
                               d_state, grid_x)
        d_table = binning.gather_vjp(d_rows, order, offsets_p1, total)
        return (d_table,) + (None,) * 10


def blend_tiles(
    bins: binning.TileBins,
    grid_x: int,
    tile_size: int = TILE_SIZE,
    chunk: int = 128,
    plain: bool = False,
) -> blend_math.BlendCarry:
    """Composite every tile's range of the sorted pair stream of ``bins``,
    differentiably in ``bins.table``.

    Returns a carry of (num_tiles, 256) per-pixel fields, ``rgb`` being
    (num_tiles, 3, 256).  ``chunk`` is used only by the plain versions,
    which run for CPU tensors or when ``plain`` is set.
    """
    table = bins.table
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blend_tiles: unsupported device {table.device}")
    plain = plain or table.device.type == "cpu"
    if not plain and tile_size != TILE_SIZE:
        raise ValueError(f"the CUDA blend needs tile_size {TILE_SIZE}, got {tile_size}")
    state, n_contrib = _Blend.apply(
        table, bins.src, bins.order, bins.offsets_p1, bins.num_pairs,
        bins.tile_start, bins.tile_end, grid_x, tile_size, chunk, plain)
    return blend_math.BlendCarry(
        T=state[:, 0], rgb=state[:, 1:4], depth=state[:, 4], acc=state[:, 5],
        done=state[:, 6] > 0.5, n_contrib=n_contrib,
    )
