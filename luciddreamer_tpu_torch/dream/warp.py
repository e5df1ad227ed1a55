"""Point-cloud warping ops of the dreaming loop (the twins of
``luciddreamer_tpu/dream/warp.py``): unprojection, projection, forward
splatting with a neighbour fill in place of Delaunay interpolation, and the
max/min-filter mask pipeline.

Plain torch ops on the device of their inputs.  The splat's scatter-add is
``index_add_``, whose float atomics on CUDA add in a different order from
run to run, so results agree with the JAX package within rounding, not bit
for bit.  The filters, the masks and the edge padding are exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_grid(H: int, W: int, device):
    """(x, y) float32 pixel coordinates, each (H, W)."""
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return x, y


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a small matrix without the host sync of an error check."""
    return torch.linalg.inv_ex(m)[0]


def edge_pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Pad the first two axes by repeating the edge rows and columns
    (``np.pad(mode="edge")``)."""
    H, W = x.shape[:2]
    ys = torch.arange(-before, H + after, device=x.device).clamp(0, H - 1)
    xs = torch.arange(-before, W + after, device=x.device).clamp(0, W - 1)
    return x[ys][:, xs]


def unproject(depth, K, R, T):
    """depth (H, W) -> world points (3, H*W): X = R^-1 (K^-1 [x d, y d, d] - T)."""
    H, W = depth.shape
    x, y = pixel_grid(H, W, depth.device)
    d = depth.reshape(-1)
    pix = torch.stack([x.reshape(-1) * d, y.reshape(-1) * d, d])
    cam = inverse(K) @ pix
    Rinv = inverse(R)
    return Rinv @ cam - Rinv @ T.reshape(3, 1)


def project(points, K, R, T, H: int, W: int):
    """World points (3, N) -> (pixel_xy (2, N), depth (N,), valid (N,)),
    valid meaning in front of the camera and inside the image."""
    pix = K @ (R @ points + T.reshape(3, 1))
    z = pix[2]
    zs = torch.where(z == 0, 1e-8, z)
    u = pix[0] / zs
    v = pix[1] / zs
    valid = (z > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return torch.stack([u, v]), z, valid


def splat_linear(points_xy, values, valid, H: int, W: int,
                 fill_iters: int = 8):
    """Forward-splat scattered (2, N) pixel coords carrying (N, C) values
    onto an (H, W, C) grid with bilinear weights; close holes by iterative
    4-neighbour averaging.  Returns (grid (H, W, C), weight (H, W))."""
    u, v = points_xy[0], points_xy[1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    dev = values.device
    acc = torch.zeros((H * W, values.shape[-1]), dtype=torch.float32, device=dev)
    wacc = torch.zeros((H * W,), dtype=torch.float32, device=dev)
    for dx, dy, w in (
        (0, 0, (1 - du) * (1 - dv)),
        (1, 0, du * (1 - dv)),
        (0, 1, (1 - du) * dv),
        (1, 1, du * dv),
    ):
        xi = torch.clamp(u0 + dx, 0, W - 1).long()
        yi = torch.clamp(v0 + dy, 0, H - 1).long()
        wi = torch.where(valid, w, 0.0)
        idx = yi * W + xi
        acc.index_add_(0, idx, wi[:, None] * values)
        wacc.index_add_(0, idx, wi)

    grid = (acc / torch.clamp_min(wacc[:, None], 1e-8)).reshape(H, W, -1)
    weight = wacc.reshape(H, W)
    for _ in range(fill_iters):
        gp = F.pad(grid * weight[..., None], (0, 0, 1, 1, 1, 1))
        wp = F.pad(weight, (1, 1, 1, 1))
        nsum = gp[:-2, 1:-1] + gp[2:, 1:-1] + gp[1:-1, :-2] + gp[1:-1, 2:]
        nw = wp[:-2, 1:-1] + wp[2:, 1:-1] + wp[1:-1, :-2] + wp[1:-1, 2:]
        filled = nsum / torch.clamp_min(nw[..., None], 1e-8)
        grid = torch.where(weight[..., None] > 0, grid, filled)
        weight = torch.where(weight > 0, weight, torch.clamp_max(nw, 1.0))
    return grid, weight


def max_filter(x, size: int):
    """(H, W) sliding-window maximum over size x size, outside the image
    counting as -inf (``scipy.ndimage.maximum_filter``)."""
    return F.max_pool2d(x[None, None], size, stride=1, padding=size // 2)[0, 0]


def min_filter(x, size: int):
    return -max_filter(-x, size)


def edge_blend(image, edge_n: int = 2):
    """Replace an edge_n-wide border with the replicated interior edge."""
    H, W = image.shape[:2]
    padded = edge_pad(image[1:-1, 1:-1], 1, 1)
    ys = torch.arange(H, device=image.device)
    xs = torch.arange(W, device=image.device)
    interior = (
        (ys[:, None] >= edge_n) & (ys[:, None] < H - edge_n)
        & (xs[None, :] >= edge_n) & (xs[None, :] < W - edge_n)
    )
    mask = interior.to(image.dtype)
    if image.ndim == 3:
        mask = mask[..., None]
    return mask * image + (1 - mask) * padded


def rounded_pixels(points_xy, H: int, W: int):
    """Nearest pixel (u, v) of each point, clamped into the image."""
    u = torch.clamp(torch.round(points_xy[0]), 0, W - 1).long()
    v = torch.clamp(torch.round(points_xy[1]), 0, H - 1).long()
    return u, v


def scatter_dot_mask(points_xy, valid, H: int, W: int):
    """(H, W) occupancy of the valid points' rounded pixels."""
    u, v = rounded_pixels(points_xy, H, W)
    m = torch.zeros(H * W, dtype=torch.float32, device=points_xy.device)
    m.scatter_reduce_(0, v * W + u, valid.to(torch.float32), "amax")
    return m.reshape(H, W)


def warp_masks(points_xy, valid, image, H: int, W: int):
    """A dreamed view's mask pipeline: dot mask -> 9x9 dilate -> gate the
    image (else -1) -> 11x11 erode of the 'any channel present' mask ->
    (image2, mask2)."""
    round_mask = max_filter(scatter_dot_mask(points_xy, valid, H, W), 9)[..., None]
    image = round_mask * image + (1 - round_mask) * (-1.0)
    mask2 = min_filter((torch.sum(image, -1) != -3.0).to(torch.float32), 11)
    return mask2[..., None] * image, mask2


def border_mask(mask2):
    """1 on the boundary pixels of mask2, else 0."""
    H, W = mask2.shape
    d = torch.abs(mask2[: H - 1, : W - 1] - mask2[1:, : W - 1]) + torch.abs(
        mask2[: H - 1, : W - 1] - mask2[: H - 1, 1:]
    )
    d = edge_pad(d, 0, 1)
    return torch.where(d < 0.3, 0.0, 1.0)


def idw_interpolate(anchor_xy, anchor_values, query_xy, k: int = 4,
                    eps: float = 1e-6, query_block: int = 8192):
    """Inverse-distance-weighted k-NN interpolation of scattered anchors at
    query pixels: anchor_xy (N, 2), anchor_values (N,), query_xy (M, 2) ->
    (M,).  Queries go in blocks, so that the (block, N) distance matrix
    stays small.

    Of anchors at equal distance the lower index wins, as in the JAX
    package's ``lax.top_k`` (symmetric clouds do tie): each distance's
    bits, monotonic for a non-negative float, are the high word of an
    int64 key whose low word is the anchor's index."""
    ax, ay = anchor_xy[:, 0], anchor_xy[:, 1]
    index = torch.arange(anchor_xy.shape[0], device=anchor_xy.device)
    out = []
    for q in torch.split(query_xy, query_block):
        d2 = (q[:, 0:1] - ax) ** 2 + (q[:, 1:2] - ay) ** 2
        key = (d2.view(torch.int32).to(torch.int64) << 32) | index
        idx = torch.topk(key, k, dim=1, largest=False).values & 0xFFFFFFFF
        near = torch.gather(d2, 1, idx)
        w = 1.0 / (torch.sqrt(near) + eps)
        out.append(torch.sum(w * anchor_values[idx], -1) / torch.sum(w, -1))
    return torch.cat(out)
