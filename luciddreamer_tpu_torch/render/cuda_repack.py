"""Kernel K3, the blend cotangent's gradient columns in slot order, as a
hand-written CUDA kernel for Hopper (``csrc/repack_cols.cu``).

Replaces the inner kernel of ``luciddreamer_tpu/render/binning.py::
_repack_cols``, fused with the inverse of the pair sort: row i of the
(pair_cap, 16) cotangent lands at column position ``order[i]`` of a
(10, pair_cap) array, and rows at or past ``num_pairs`` give zeros.  On the
card it is a gather through the inverse permutation: one launch function
builds ``inv[order[i]] = i`` (-1 for dead rows) in int32 scratch and then
reads row ``inv[s]`` for each slot ``s``, so that the scattered access is
the 4-byte one and the 10-channel stores are coalesced.

``repack_cols`` launches the kernel for CUDA tensors and counts each launch
in ``repack_cols.launches`` (both passes are one launch); for CPU tensors it
runs the plain version ``repack_cols_torch``.
"""
from __future__ import annotations

import ctypes

import torch

from luciddreamer_tpu_torch.render import kernels

ATTR_DIM = 16           # row width of the pair stream (binning.ATTR_DIM)
N_GRAD_CH = 10          # attribute channels 0..9 carry gradient
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]


def repack_cols_torch(x: torch.Tensor, order: torch.Tensor,
                      num_pairs: torch.Tensor) -> torch.Tensor:
    """``x[:, :10].t()`` with rows at or past ``num_pairs`` zeroed, then
    scattered along slots by ``order``: (10, pair_cap)."""
    n = x.shape[0]
    live = torch.arange(n, device=x.device) < num_pairs
    rows = torch.where(live[:, None], x[:, :N_GRAD_CH], 0.0)
    cols = x.new_zeros((N_GRAD_CH, n))
    cols[:, order] = rows.t()
    return cols


def repack_cols(x: torch.Tensor, order: torch.Tensor,
                num_pairs: torch.Tensor) -> torch.Tensor:
    """(pair_cap, 16) cotangent -> (10, pair_cap) columns in slot order.
    ``order`` (pair_cap,) int64 must be a permutation of [0, pair_cap), as
    the pair sort's is (it is not checked: a slot that ``order`` does not
    name is left undefined on the card); ``num_pairs`` is a 0-d int64 tensor
    on the same device."""
    if x.device.type == "cpu":
        return repack_cols_torch(x, order, num_pairs)
    if x.device.type != "cuda":
        raise ValueError(f"repack_cols: unsupported device {x.device}")
    n = x.shape[0]
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != ATTR_DIM
            or not x.is_contiguous()):
        raise ValueError(f"x must be contiguous float32 (N, {ATTR_DIM})")
    if n >= 2**31:
        raise ValueError("pair capacity must be below 2^31 rows")
    if (order.dtype != torch.int64 or order.shape != (n,)
            or not order.is_contiguous() or order.device != x.device):
        raise ValueError(f"order must be contiguous int64 ({n},) on {x.device}")
    if (num_pairs.dtype != torch.int64 or num_pairs.numel() != 1
            or num_pairs.device != x.device):
        raise ValueError(f"num_pairs must be one int64 on {x.device}")
    num_pairs = num_pairs.contiguous()
    cols = x.new_empty((N_GRAD_CH, n))
    inv = torch.empty(n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    kernels.launch("repack_cols", _ARGS, x.data_ptr(), order.data_ptr(),
                   num_pairs.data_ptr(), inv.data_ptr(), cols.data_ptr(), n,
                   stream)
    repack_cols.launches += 1
    return cols


repack_cols.launches = 0
