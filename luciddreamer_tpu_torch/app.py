"""Orchestrator, serving half: load a Gaussian scene and render preset
videos.  Scene creation and training come with the training port."""
from __future__ import annotations

import os
from typing import Optional

from luciddreamer_tpu_torch import video as videolib
from luciddreamer_tpu_torch.config import CameraConfig, GSConfig
from luciddreamer_tpu_torch.core.transforms import focal2fov, fov2focal
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.model import ply as plyio
from luciddreamer_tpu_torch.scene import frame_to_camera
from luciddreamer_tpu_torch.trajectory import get_camera_paths


class LucidDreamerTPU:
    def __init__(
        self,
        gs_config: Optional[GSConfig] = None,
        cam_config: Optional[CameraConfig] = None,
        save_dir: str = "./output",
        device=None,
    ):
        self.opt = gs_config or GSConfig()
        self.cam = cam_config or CameraConfig()
        self.save_dir = save_dir
        self.device = resolve_device(device)
        self.params = None

    def preset_cameras(self, preset: str = "llff"):
        """The preset path's cameras at the configured resolution, with the
        preset field of view (fov * 1.2)."""
        H, W = self.cam.image_height, self.cam.image_width
        fovx = self.cam.fov_x * 1.2
        fovy = focal2fov(fov2focal(fovx, W), H)
        return [
            frame_to_camera(fr["transform_matrix"], fovx, fovy, W, H,
                            device=self.device)
            for fr in get_camera_paths()[preset]["frames"]
        ]

    def render_video(self, preset: str = "llff"):
        if self.params is None:
            raise RuntimeError("No Gaussians loaded; call load_ply first")
        bg = [1.0, 1.0, 1.0] if self.opt.white_background else [0.0, 0.0, 0.0]
        rgbs, depths = videolib.render_frames(
            self.params, self.preset_cameras(preset), bg,
            active_sh_degree=self.opt.sh_degree, device=self.device,
        )
        return videolib.write_videos(rgbs, depths, self.save_dir, preset)

    def save_ply(self, path: str):
        """Write the scene to ``path``; an existing file there is loaded
        instead, as the JAX package does."""
        if os.path.exists(path):
            self.params = plyio.load_ply(path, device=self.device)
            return path
        plyio.save_ply(self.params, path)
        return path

    def load_ply(self, path: str, capacity: Optional[int] = None):
        self.params = plyio.load_ply(path, capacity=capacity, device=self.device)
        return self.params
