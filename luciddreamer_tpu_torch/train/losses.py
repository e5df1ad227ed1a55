"""Image losses: L1, L2/MSE, PSNR, the 11x11 sigma-1.5 SSIM and the
depth-smoothing and edge helpers (the twins of
``luciddreamer_tpu/train/losses.py``).

The SSIM window is a separable Gaussian, applied as two zero-padded 1-D
passes.  Each pass, like the 3x3 filters of ``near_mean_map`` and
``sobel_edge_mask``, is a sum of shifted slices rather than a convolution:
elementwise products and sums run in full fp32 on every device, forward
and backward, where a float32 cuDNN convolution would run in TF32 unless a
global flag said otherwise.  The five blurred maps share one stacked pass.
``image2canny`` is numpy on the host, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(x, y):
    return torch.mean(torch.abs(x - y))


def l2_loss(x, y):
    return torch.mean((x - y) ** 2)


def mse(img1, img2):
    return torch.mean((img1 - img2) ** 2)


def psnr(img1, img2):
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def _gaussian_window(window_size: int, sigma: float) -> list[float]:
    g = [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
         for x in range(window_size)]
    s = sum(g)
    return [v / s for v in g]


def _blur(x: torch.Tensor, window: list[float]) -> torch.Tensor:
    """Separable zero-padded 'same' filter over the last two axes."""
    w = len(window)
    pad = w // 2
    H, W = x.shape[-2:]
    xp = F.pad(x, (0, 0, pad, pad))
    x = sum(window[k] * xp[..., k:k + H, :] for k in range(w))
    xp = F.pad(x, (pad, pad))
    return sum(window[k] * xp[..., k:k + W] for k in range(w))


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         size_average: bool = True):
    """img1/img2: (C, H, W) in [0, 1]; zero-padded window, C1 = 0.01^2,
    C2 = 0.03^2."""
    window = _gaussian_window(window_size, sigma)
    blurred = _blur(
        torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2]),
        window,
    )
    mu1, mu2, e11, e22, e12 = blurred.unbind(0)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean() if size_average else ssim_map.mean(dim=(1, 2))


def _filter3x3(x: torch.Tensor, weights) -> torch.Tensor:
    """Zero-padded 'same' 3x3 cross-correlation of an (H, W) map: the sum
    of the shifted slices whose weight is not 0."""
    H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    return sum(weights[dy][dx] * xp[dy:dy + H, dx:dx + W]
               for dy in range(3) for dx in range(3) if weights[dy][dx])


_CROSS = ((0.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 0.0))
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = tuple(zip(*_SOBEL_X))


def near_mean_map(array, mask, kernelsize: int = 3):
    """Masked 4-neighbour mean of an (H, W) map, for depth-smoothing
    losses: the sum of the masked neighbours over their count."""
    assert kernelsize == 3
    num = _filter3x3(array * mask, _CROSS)
    cnt = _filter3x3(torch.ones_like(array) * mask, _CROSS)
    return num / (cnt + 1e-8)


def image2canny(image, thres1, thres2, isEdge1: bool = True):
    """Canny edge mask of an (H, W, 3) image in [0, 1] -> (H, W) float32,
    numpy on the host (the reference's cv2.Canny wrapper, computed per
    camera with (50, 150, isEdge1=False)):

    * 3x3 Sobel per channel on the 0..255 intensity scale, per-pixel
      gradient taken from the channel with the largest L1 magnitude
      (cv2's multi-channel behaviour, default L2gradient=False);
    * non-maximum suppression with 4-sector direction quantization;
    * double threshold + 8-connected hysteresis iterated to fixpoint.

    Thresholds are on the cv2 scale (image * 255 gradients).
    """
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    img = np.rint(img * 255.0).astype(np.float32)        # cv2 uint8 scale
    H, W, C = img.shape
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")

    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)
    gx = np.zeros((H, W, C), np.float32)
    gy = np.zeros((H, W, C), np.float32)
    for dy in range(3):
        for dx in range(3):
            sl = pad[dy : dy + H, dx : dx + W]
            gx += kx[dy, dx] * sl
            gy += ky[dy, dx] * sl
    mag_c = np.abs(gx) + np.abs(gy)                      # L1, per channel
    pick = np.argmax(mag_c, axis=-1)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = gx[ii, jj, pick]
    gy = gy[ii, jj, pick]
    mag = np.abs(gx) + np.abs(gy)

    # non-maximum suppression: quantize direction into 4 sectors
    ang = np.arctan2(gy, gx) % np.pi                     # [0, pi)
    sector = ((ang + np.pi / 8) // (np.pi / 4)).astype(np.int32) % 4
    offs = {0: (0, 1), 1: (1, 1), 2: (1, 0), 3: (1, -1)}
    magp = np.pad(mag, 1, mode="constant")
    keep = np.zeros((H, W), bool)
    for s, (oy, ox) in offs.items():
        n1 = magp[1 + oy : 1 + oy + H, 1 + ox : 1 + ox + W]
        n2 = magp[1 - oy : 1 - oy + H, 1 - ox : 1 - ox + W]
        keep |= (sector == s) & (mag >= n1) & (mag >= n2)

    lo, hi = float(min(thres1, thres2)), float(max(thres1, thres2))
    strong = keep & (mag > hi)
    weakm = keep & (mag > lo)

    # hysteresis: weak pixels 8-connected to strong survive
    out = strong.copy()
    while True:
        outp = np.pad(out, 1, mode="constant")
        grown = np.zeros((H, W), bool)
        for oy in (-1, 0, 1):
            for ox in (-1, 0, 1):
                grown |= outp[1 + oy : 1 + oy + H, 1 + ox : 1 + ox + W]
        new = out | (weakm & grown)
        if (new == out).all():
            break
        out = new

    canny = out.astype(np.float32)
    return canny if isEdge1 else 1.0 - canny


def sobel_edge_mask(image, threshold: float = 0.2, edge_is_one: bool = True):
    """Edge mask of a (C, H, W) image for depth-loss weighting: the 3x3
    Sobel magnitude of the channel mean, zero-padded, over ``threshold``
    (the device companion of ``image2canny``)."""
    gray = torch.mean(image, dim=0)
    mag = torch.sqrt(_filter3x3(gray, _SOBEL_X) ** 2
                     + _filter3x3(gray, _SOBEL_Y) ** 2)
    edge = (mag > threshold).to(torch.float32)
    return edge if edge_is_one else 1.0 - edge
