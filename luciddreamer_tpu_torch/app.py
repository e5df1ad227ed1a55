"""Top-level orchestrator: single image + text -> 3D Gaussian scene ->
videos (the twin of ``luciddreamer_tpu/app.py``).

``create`` dreams a point cloud, bakes Gaussians and saves a PLY file;
``render_video`` renders a preset camera path; ``run`` does both.
Everything runs on ``device`` (default: the CUDA device).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from luciddreamer_tpu_torch import video as videolib
from luciddreamer_tpu_torch.config import CameraConfig, GSConfig
from luciddreamer_tpu_torch.core.transforms import focal2fov, fov2focal
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.dream import DreamConfig, generate_pcd
from luciddreamer_tpu_torch.model import ply as plyio
from luciddreamer_tpu_torch.model.gaussians import create_from_pcd
from luciddreamer_tpu_torch.points.morton import morton_subsample
from luciddreamer_tpu_torch.scene import Scene, frame_to_camera
from luciddreamer_tpu_torch.train.loop import Trainer
from luciddreamer_tpu_torch.trajectory import get_camera_paths
from luciddreamer_tpu_torch.utils.profiling import PhaseTimer

MAX_PCD_POINTS = 400_000      # the dreamed cloud is subsampled to this
MAX_CAPACITY = 1_200_000      # the largest Gaussian buffer a scene gets
MAX_PAIR_CAP = 6_000_000      # the largest pair budget of a training step


class LucidDreamerTPU:
    def __init__(
        self,
        gs_config: Optional[GSConfig] = None,
        cam_config: Optional[CameraConfig] = None,
        dream_config: Optional[DreamConfig] = None,
        save_dir: str = "./output",
        capacity_multiplier: float = 4.0,
        seed: int = 1,
        device=None,
    ):
        self.opt = gs_config or GSConfig()
        self.cam = cam_config or CameraConfig()
        self.dream_cfg = dream_config or DreamConfig()
        self.save_dir = save_dir
        self.capacity_multiplier = capacity_multiplier
        self.seed = seed
        self.device = resolve_device(device)
        self.scene: Optional[Scene] = None
        self.trainer: Optional[Trainer] = None
        self.params = None
        self.traindata = None

    # ---- pipeline stages ----

    def create(self, rgb_cond, txt: str = "", neg_txt: str = "",
               pcdgenpath: str = "lookdown", seed: Optional[int] = None,
               diff_steps: int = 30, progress_callback=None,
               timer: Optional[PhaseTimer] = None):
        """Dream, bake, and write ``gsplat.ply`` into ``save_dir``; returns
        its path.  ``timer`` gets the host time of each stage, the device's
        work included: "dream" (``generate_pcd``), "scene", "bake_setup"
        (the Morton subsample, ``create_from_pcd`` and the Trainer),
        "bake" (with "train_step" per step) and "save_ply"."""
        seed = self.seed if seed is None else seed
        timer = timer or PhaseTimer()
        with timer.phase("dream"):
            self.traindata = generate_pcd(
                rgb_cond, txt, neg_txt, pcdgenpath, seed, diff_steps,
                cam=self.cam, config=self.dream_cfg,
                progress_callback=progress_callback, device=self.device,
            )
        with timer.phase("scene"):
            self.scene = Scene(self.traindata, device=self.device)
        self.training(progress_callback=progress_callback, timer=timer)
        os.makedirs(self.save_dir, exist_ok=True)
        with timer.phase("save_ply"):
            return self.save_ply(os.path.join(self.save_dir, "gsplat.ply"))

    def training(self, progress_callback=None,
                 timer: Optional[PhaseTimer] = None):
        """Bake Gaussians from the scene's cloud on its training views;
        ``timer`` as in ``create``."""
        if self.scene is None:
            raise RuntimeError("Build the 3D scene first (call create)")
        dev = self.device
        timer = timer or PhaseTimer()
        pts = torch.as_tensor(self.scene.pcd_points, device=dev)
        cols = torch.as_tensor(np.clip(self.scene.pcd_colors, 0.0, 1.0),
                               device=dev)
        with timer.phase("bake_setup", block_on=pts):
            if pts.shape[0] > MAX_PCD_POINTS:
                idx = morton_subsample(pts, MAX_PCD_POINTS)
                pts, cols = pts[idx], cols[idx]
            capacity = min(int(pts.shape[0] * self.capacity_multiplier),
                           MAX_CAPACITY)
            params = create_from_pcd(pts, cols, sh_degree=self.opt.sh_degree,
                                     capacity=capacity)
            self.trainer = Trainer(
                params, self.opt, cameras_extent=self.scene.cameras_extent,
                # 8x capacity can reach tens of millions of slots for lifted
                # clouds, far beyond what a 512^2 frame uses
                pair_cap=min(8 * capacity, MAX_PAIR_CAP),
                seed=self.seed, device=dev,
            )
        # the dream stage's warped depths ride along when the depth loss is
        # on; the Trainer skips the term for views without one
        use_depth = self.opt.lambda_depth > 0.0 or self.opt.use_depth
        views = [(v.camera, v.image, v.depth if use_depth else None)
                 for v in self.scene.get_train_views()]
        cb = None
        if progress_callback:
            cb = lambda it, st, l: progress_callback("bake", it, self.opt.iterations)
        with timer.phase("bake", block_on=params.xyz):
            self.trainer.run(views, callback=cb, timer=timer)
        self.params = self.trainer.state.params
        return self.params

    def preset_cameras(self, preset: str = "llff"):
        """The preset path's cameras: the scene's where one was built, else
        made at the configured resolution with the preset field of view
        (fov * 1.2)."""
        if self.scene is not None:
            return self.scene.get_preset_cameras(preset)
        H, W = self.cam.image_height, self.cam.image_width
        fovx = self.cam.fov_x * 1.2
        fovy = focal2fov(fov2focal(fovx, W), H)
        return [
            frame_to_camera(fr["transform_matrix"], fovx, fovy, W, H,
                            device=self.device)
            for fr in get_camera_paths()[preset]["frames"]
        ]

    def render_video(self, preset: str = "llff", progress_callback=None):
        """Render the preset path and write its RGB and depth videos into
        ``save_dir``; returns their paths.  ``progress_callback`` is
        accepted and not called, as in the JAX package."""
        if self.params is None:
            raise RuntimeError("No trained Gaussians; call create or load_ply first")
        bg = [1.0, 1.0, 1.0] if self.opt.white_background else [0.0, 0.0, 0.0]
        rgbs, depths = videolib.render_frames(
            self.params, self.preset_cameras(preset), bg,
            active_sh_degree=self.opt.sh_degree, device=self.device,
        )
        return videolib.write_videos(rgbs, depths, self.save_dir, preset)

    def run(self, rgb_cond, txt, neg_txt, pcdgenpath, seed, diff_steps,
            render_preset: str = "llff"):
        self.create(rgb_cond, txt, neg_txt, pcdgenpath, seed, diff_steps)
        return self.render_video(render_preset)

    # ---- checkpointing ----

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
