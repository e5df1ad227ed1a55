"""Video rendering along preset camera paths (RGB + colorized depth)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from luciddreamer_tpu_torch.core.types import Camera, GaussianParams
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.render.tiled import render_tiled


def colorize_depth(
    depth: np.ndarray,
    cmap: str = "jet",
    vminp: float = 2.0,
    vmaxp: float = 98.0,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
) -> np.ndarray:
    """Percentile-normalized colormap depth image; invalid (<= 0) pixels
    map to black."""
    import matplotlib

    valid = depth > 0
    if vmin is None:
        vmin = float(np.percentile(depth[valid], vminp)) if valid.any() else 0.0
    if vmax is None:
        vmax = float(np.percentile(depth[valid], vmaxp)) if valid.any() else 1.0
    x = np.clip((depth - vmin) / max(vmax - vmin, 1e-8), 0.0, 1.0)
    cm = matplotlib.colormaps[cmap]
    rgba = cm(x, bytes=True)
    rgba[~valid] = 0
    return rgba[..., :3]


def render_frames(
    params: GaussianParams,
    cameras: list[Camera],
    bg,
    active_sh_degree: int = 3,
    backend: str = "cuda",
    chunk: int = 128,
    pair_cap: int | None = None,
    device=None,
):
    """Render a camera path on ``device`` (default: the CUDA device);
    returns (rgb frames as uint8 (H, W, 3), depth frames as float (H, W)).

    ``params`` is moved to ``device`` in place (``nn.Module.to``).  Raises
    if a frame overflows the pair capacity: its image would be truncated.
    """
    dev = resolve_device(device)
    params = params.to(dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    rgbs, depths = [], []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            out = render_tiled(
                params, cam.to(dev), bg, active_sh_degree=active_sh_degree,
                chunk=chunk, pair_cap=pair_cap, backend=backend,
            )
            if bool(out["overflow"]):
                raise RuntimeError(
                    f"frame {i}: {int(out['num_pairs'])} pairs overflow the "
                    f"pair capacity; pass a larger pair_cap"
                )
            rgb = np.clip(out["render"].cpu().numpy(), 0.0, 1.0)
            rgbs.append((rgb.transpose(1, 2, 0) * 255).astype(np.uint8))
            depths.append(out["depth"].cpu().numpy())
    return rgbs, depths


def write_videos(
    rgbs: list[np.ndarray],
    depths: list[np.ndarray],
    outdir: str,
    name: str,
    fps: int = 60,
    quality: int = 8,
):
    """{name}.mp4 + depth_{name}.mp4; animated GIFs where no mp4 encoder
    is installed."""
    import imageio

    os.makedirs(outdir, exist_ok=True)
    alld = np.stack(depths)
    pos = alld[alld > 0]
    vmin = float(np.percentile(pos, 2)) if pos.size else 0.0
    vmax = float(np.percentile(pos, 98)) if pos.size else 1.0
    depth_frames = [colorize_depth(d, vmin=vmin, vmax=vmax) for d in depths]

    def write(base, frames):
        path = os.path.join(outdir, base + ".mp4")
        try:
            imageio.mimwrite(path, frames, fps=fps, quality=quality)
            return path
        except Exception:
            import warnings

            path = os.path.join(outdir, base + ".gif")
            warnings.warn("no mp4 encoder available; writing GIF instead")
            imageio.mimwrite(path, frames, duration=1000.0 / fps, loop=0)
            return path

    rgb_path = write(name, rgbs)
    depth_path = write(f"depth_{name}", depth_frames)
    return rgb_path, depth_path
