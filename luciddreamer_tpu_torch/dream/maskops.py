"""Mask utilities of the inpainting path (the twins of
``luciddreamer_tpu/dream/maskops.py``): box-dilate a hole mask, and the
ControlNet inpaint conditioning image with the holes at -1."""
from __future__ import annotations

import torch

from luciddreamer_tpu_torch.dream.warp import max_filter


def pad_mask(mask, pad_amount: int = 1):
    """(H, W) 0/1 mask -> bool mask dilated by ``pad_amount`` pixels."""
    m = torch.as_tensor(mask, dtype=torch.float32)
    return max_filter(m, 2 * pad_amount + 1) > 0.0


def controlnet_inpaint_condition(image, mask):
    """image (H, W, 3) in [0, 1], mask (H, W) 1 = hole -> (1, 3, H, W)
    condition with the masked pixels at -1."""
    img = torch.as_tensor(image, dtype=torch.float32)
    m = torch.as_tensor(mask, dtype=torch.float32, device=img.device) > 0.5
    img = torch.where(m[..., None], -1.0, img)
    return img.permute(2, 0, 1)[None]
