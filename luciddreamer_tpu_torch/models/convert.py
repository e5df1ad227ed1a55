"""Reference ZoeDepth checkpoints -> the port's state dicts.

The port's modules carry the reference checkpoints' names (timm BEiT under
``core.core.pretrained.model``, MiDaS ``act_postprocess{k}`` and
``scratch``, the ZoeDepth heads), so a reference ZoeD_N/K/NK state dict
maps onto them key for key.  Three things remain to do, and this module
does them: unwrap ``{'model': ...}`` and drop DDP ``module.`` prefixes;
resize each rel-pos table to the token grid of the model's input size
(the released checkpoints were trained at 384x384); and split a packed
``qkv.bias`` into ``q_bias`` and ``v_bias`` where a checkpoint has one (the
k part is dropped exactly: it adds the same term to every key of a query,
and softmax cancels it).  Keys the model does not hold (the rel-pos index
buffers, ``k_bias``) are ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from luciddreamer_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig


def strip_prefixes(sd: dict) -> dict:
    """Unwrap {'model': ...} checkpoints and drop DDP 'module.' prefixes."""
    if "model" in sd and not hasattr(sd["model"], "shape"):
        sd = sd["model"]
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def _resize_rel_pos_table(table: np.ndarray, grid_hw: tuple[int, int]):
    """Resize a BEiT relative-position-bias table to a new token grid.

    The first (2h-1)(2w-1) rows form a 2D grid of biases, interpolated
    bilinearly with half-pixel centres (torch's align_corners=False, as
    MiDaS 3.1 resizes BEiT tables to non-square grids); the 3 trailing cls
    rows pass through unchanged.
    """
    h, w = grid_hw
    th, tw = 2 * h - 1, 2 * w - 1
    n_special = 3
    grid = table[:-n_special]
    heads = table.shape[1]
    if grid.shape[0] == th * tw:        # already at the target grid
        return table.astype(np.float32)
    src = int(round(np.sqrt(grid.shape[0])))
    if src * src != grid.shape[0]:
        raise ValueError(
            f"rel-pos table grid {grid.shape[0]} matches neither the target "
            f"{th}x{tw} nor a square source; cannot resize"
        )
    g = grid.reshape(src, src, heads)

    def interp_axis(a, n_out, axis):
        n_in = a.shape[axis]
        if n_in == n_out:
            return a
        pos = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5,
                      0.0, n_in - 1.0)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        t = (pos - lo).reshape([-1 if i == axis else 1 for i in range(a.ndim)])
        return np.take(a, lo, axis) * (1 - t) + np.take(a, hi, axis) * t

    g = interp_axis(interp_axis(g, th, 0), tw, 1)
    return np.concatenate(
        [g.reshape(th * tw, heads), table[-n_special:]], axis=0
    ).astype(np.float32)


def _f32(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.detach().to("cpu", torch.float32)


def map_state_dict(sd: dict, model_cls, cfg: ZoeDepthConfig) -> dict:
    """A reference state dict -> the state dict of ``model_cls(cfg)``.
    Raises KeyError for a weight the checkpoint lacks and ValueError for
    one whose shape differs."""
    with torch.device("meta"):
        wanted = model_cls(cfg).state_dict()
    sd = strip_prefixes(sd)
    ph, pw = (s // cfg.vit.patch_size for s in cfg.img_size)
    out = {}
    for key, ref in wanted.items():
        prefix, name = key.rsplit(".", 1)
        if key in sd:
            v = _f32(sd[key])
        elif name in ("q_bias", "v_bias") and f"{prefix}.qkv.bias" in sd:
            packed = _f32(sd[f"{prefix}.qkv.bias"])
            C = ref.shape[0]
            v = packed[:C] if name == "q_bias" else packed[2 * C:]
        else:
            raise KeyError(f"the checkpoint has no {key!r}")
        if name == "relative_position_bias_table":
            v = torch.from_numpy(_resize_rel_pos_table(v.numpy(), (ph, pw)))
        if v.shape != ref.shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(v.shape)}, "
                             f"model {tuple(ref.shape)}")
        out[key] = v
    return out


def convert_zoedepth_state_dict(sd: dict, cfg: ZoeDepthConfig) -> dict:
    """A reference ZoeD_N or ZoeD_K state dict -> ``ZoeDepth(cfg)``'s."""
    return map_state_dict(sd, ZoeDepth, cfg)


def convert_zoedepth_nk_state_dict(sd: dict, cfg: ZoeDepthConfig) -> dict:
    """A reference ZoeD_NK state dict -> ``ZoeDepthNK(cfg)``'s."""
    from luciddreamer_tpu_torch.models.zoedepth_nk import ZoeDepthNK

    return map_state_dict(sd, ZoeDepthNK, cfg)


def load_torch_state_dict(path: str) -> dict:
    """Read a reference .pt/.pth checkpoint into {name: tensor} on the CPU.
    Only weights are unpickled (``weights_only=True``): a checkpoint that
    pickles code is refused."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in strip_prefixes(sd).items()
            if isinstance(v, torch.Tensor)}
