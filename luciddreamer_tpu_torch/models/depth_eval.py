"""Monodepth evaluation metrics, the port's own copy of
``luciddreamer_tpu/models/depth_eval.py`` (ZoeDepth/zoedepth/utils/
misc.py:159-248), in numpy.

``compute_metrics`` returns the standard nine: a1/a2/a3 (delta < 1.25^k),
abs_rel, sq_rel, rmse, rmse_log, log_10 and silog, with the optional garg
or eigen evaluation crop.
"""
from __future__ import annotations

import numpy as np

METRICS = ("a1", "a2", "a3", "abs_rel", "sq_rel", "rmse", "rmse_log",
           "log_10", "silog")


def _crop_mask(shape, kind: str | None):
    H, W = shape
    m = np.zeros((H, W), bool)
    if kind == "garg":
        m[int(0.40810811 * H) : int(0.99189189 * H),
          int(0.03594771 * W) : int(0.96405229 * W)] = True
    elif kind == "eigen":
        m[int(0.3324324 * H) : int(0.91351351 * H),
          int(0.0359477 * W) : int(0.96405229 * W)] = True
    else:
        m[:] = True
    return m


def compute_metrics(
    gt: np.ndarray,
    pred: np.ndarray,
    min_depth_eval: float = 1e-3,
    max_depth_eval: float = 10.0,
    crop: str | None = None,
) -> dict:
    pred = np.asarray(pred, np.float64).copy()
    gt = np.asarray(gt, np.float64)
    pred[pred < min_depth_eval] = min_depth_eval
    pred[pred > max_depth_eval] = max_depth_eval
    pred[np.isnan(pred)] = min_depth_eval
    pred[np.isinf(pred)] = max_depth_eval

    valid = (gt > min_depth_eval) & (gt < max_depth_eval)
    valid &= _crop_mask(gt.shape[-2:], crop)
    g = gt[valid]
    p = pred[valid]
    if g.size == 0:
        return {k: float("nan") for k in METRICS}

    thresh = np.maximum(g / p, p / g)
    d = np.log(p) - np.log(g)
    return {
        "a1": float((thresh < 1.25).mean()),
        "a2": float((thresh < 1.25**2).mean()),
        "a3": float((thresh < 1.25**3).mean()),
        "abs_rel": float(np.mean(np.abs(g - p) / g)),
        "sq_rel": float(np.mean(((g - p) ** 2) / g)),
        "rmse": float(np.sqrt(np.mean((g - p) ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(g) - np.log(p)) ** 2))),
        "log_10": float(np.mean(np.abs(np.log10(g) - np.log10(p)))),
        "silog": float(
            np.sqrt(max(np.mean(d**2) - np.mean(d) ** 2, 0.0)) * 100
        ),
    }
