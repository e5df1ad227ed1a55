"""Image losses: L1, L2/MSE, PSNR and the 11x11 sigma-1.5 SSIM (the twins
of ``luciddreamer_tpu/train/losses.py``).

The SSIM window is a separable Gaussian, applied as two zero-padded 1-D
passes.  Each pass is a sum of shifted slices rather than a convolution:
elementwise products and sums run in full fp32 on every device, forward
and backward, where a float32 cuDNN convolution would run in TF32 unless a
global flag said otherwise.  The five blurred maps share one stacked pass.
"""
from __future__ import annotations

import math

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
