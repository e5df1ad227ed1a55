"""Monodepth training losses, the twins of
``luciddreamer_tpu/models/depth_losses.py`` (ports of the reference's
ZoeDepth/zoedepth/trainers/loss.py).

All take pred (B, H, W), gt (B, H, W) and a bool mask (B, H, W) (the
ordinal and NLL losses take per-bin probabilities (B, H, W, K)) and return
a scalar.
"""
from __future__ import annotations

import torch


def _masked(x, mask):
    w = mask.to(torch.float32)
    n = torch.clamp_min(torch.sum(w), 1.0)
    return x * w, w, n


def silog_loss(pred, gt, mask, beta: float = 0.15):
    """Scale-invariant log loss: 10 sqrt(var(g) + beta mean(g)^2),
    g = log(pred) - log(gt) over the mask (loss.py:42-93)."""
    pred = torch.clamp_min(pred, 1e-6)
    gt = torch.clamp_min(gt, 1e-6)
    g = torch.log(pred) - torch.log(gt)
    g, w, n = _masked(g, mask)
    mean = torch.sum(g) / n
    var = torch.sum(w * (g - mean) ** 2) / n
    return 10.0 * torch.sqrt(var + beta * mean**2)


def grad_l1_loss(pred, gt, mask):
    """L1 on the horizontal and vertical log-depth differences
    (loss.py GradL1Loss)."""
    pred = torch.log(torch.clamp_min(pred, 1e-6))
    gt = torch.log(torch.clamp_min(gt, 1e-6))

    def grads(x):
        return x[:, :, 1:] - x[:, :, :-1], x[:, 1:, :] - x[:, :-1, :]

    px, py = grads(pred)
    gx, gy = grads(gt)
    mx = mask[:, :, 1:] & mask[:, :, :-1]
    my = mask[:, 1:, :] & mask[:, :-1, :]
    lx, _, nx = _masked(torch.abs(px - gx), mx)
    ly, _, ny = _masked(torch.abs(py - gy), my)
    return torch.sum(lx) / nx + torch.sum(ly) / ny


def scale_and_shift_invariant_loss(pred, gt, mask):
    """MiDaS-style SSI MSE: per image the (s, t) minimising
    ||s pred + t - gt||^2 over the mask, then the residual MSE
    (loss.py ScaleAndShiftInvariantLoss)."""
    w = mask.to(torch.float32)
    dims = (1, 2)
    a00 = torch.sum(w * pred * pred, dim=dims)
    a01 = torch.sum(w * pred, dim=dims)
    a11 = torch.sum(w, dim=dims)
    b0 = torch.sum(w * pred * gt, dim=dims)
    b1 = torch.sum(w * gt, dim=dims)
    det = a00 * a11 - a01 * a01
    det = torch.where(torch.abs(det) < 1e-8, torch.ones_like(det), det)
    s = (a11 * b0 - a01 * b1) / det
    t = (-a01 * b0 + a00 * b1) / det
    res = (s[:, None, None] * pred + t[:, None, None] - gt) ** 2
    return torch.mean(torch.sum(res * w, dim=dims) / torch.clamp_min(a11, 1.0))


def ordinal_regression_loss(probs, gt, mask, bin_edges):
    """DORN-style ordinal regression over bin probabilities
    (loss.py OrdinalRegressionLoss): the cumulative probabilities should
    agree with the gt's bin index.  probs (B, H, W, K), bin_edges (K+1,)."""
    K = probs.shape[-1]
    # searchsorted(edges, gt) - 1 with numpy's left side
    gt_idx = torch.clamp(torch.searchsorted(bin_edges.contiguous(),
                                            gt.contiguous()) - 1, 0, K - 1)
    k = torch.arange(K, device=probs.device)
    ge = (k <= gt_idx[..., None]).to(torch.float32)
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    ll = ge * torch.log(p) + (1 - ge) * torch.log(1 - p)
    w = mask.to(torch.float32)[..., None]
    return -torch.sum(ll * w) / torch.clamp_min(torch.sum(w) * K, 1.0)


def discrete_nll_loss(probs, gt, mask, bin_centers):
    """Cross-entropy against the gt's nearest bin (loss.py DiscreteNLLLoss).
    probs (B, H, W, K), bin_centers (K,)."""
    idx = torch.argmin(torch.abs(gt[..., None] - bin_centers), dim=-1)
    p = torch.gather(torch.clamp(probs, 1e-7, 1.0), -1, idx[..., None])[..., 0]
    nll, _, n = _masked(-torch.log(p), mask)
    return torch.sum(nll) / n
