"""Dataset readers: COLMAP reconstructions and NeRF-synthetic (Blender)
scenes (the twins of ``luciddreamer_tpu/scene/datasets.py``).  Each returns
what a training run consumes: train views (Camera + image), a point cloud
and the scene extent.  Images are read with Pillow; cameras are built on
``device`` (default: the CUDA device).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from luciddreamer_tpu_torch.core.transforms import focal2fov, fov2focal, make_camera
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.scene.colmap import qvec2rotmat, read_model
from luciddreamer_tpu_torch.scene.scene import TrainView, _nerfpp_radius


@dataclass
class SceneData:
    views: list
    points: np.ndarray        # (N, 3)
    colors: np.ndarray        # (N, 3) in [0, 1]
    cameras_extent: float


def _load_image(path):
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def _extent(views) -> float:
    return _nerfpp_radius(np.stack([v.camera.campos.cpu().numpy()
                                    for v in views]))


def read_colmap_scene(root: str, images_dir: str = "images",
                      device=None) -> SceneData:
    """A ``sparse/0`` (or ``sparse``) reconstruction and its images; only
    undistorted pinhole cameras."""
    dev = resolve_device(device)
    sparse = os.path.join(root, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(root, "sparse")
    cams, images, (xyz, rgb, _err) = read_model(sparse)

    views = []
    for im in sorted(images.values(), key=lambda i: i.name):
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model} "
                "(undistort the images first)"
            )
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        camera = make_camera(np.linalg.inv(w2c), focal2fov(fx, cam.width),
                             focal2fov(fy, cam.height), cam.width, cam.height,
                             device=dev)
        img_path = os.path.join(root, images_dir, im.name)
        image = _load_image(img_path) if os.path.exists(img_path) else None
        views.append(TrainView(camera=camera, image=image))

    return SceneData(
        views=views,
        points=xyz.astype(np.float32),
        colors=rgb.astype(np.float32) / 255.0,
        cameras_extent=_extent(views),
    )


def read_nerf_synthetic(root: str, white_background: bool = False,
                        split: str = "train", device=None) -> SceneData:
    """``transforms_{split}.json`` Blender scenes, with a random initial
    cloud of 100k points in [-1.3, 1.3]^3 (seed 0), as the original does
    where no PLY exists."""
    from PIL import Image

    dev = resolve_device(device)
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])

    views = []
    for fr in meta["frames"]:
        path = os.path.join(root, fr["file_path"])
        for ext in ("", ".png", ".jpg"):
            if os.path.exists(path + ext):
                path = path + ext
                break
        im = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
        bg = 1.0 if white_background else 0.0
        rgb = im[..., :3] * im[..., 3:4] + bg * (1 - im[..., 3:4])
        H, W = rgb.shape[:2]
        c2w = np.array(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1                   # OpenGL -> COLMAP
        fovy = focal2fov(fov2focal(fovx, W), H)
        views.append(TrainView(
            camera=make_camera(c2w, fovx, fovy, W, H, device=dev),
            image=rgb.transpose(2, 0, 1).astype(np.float32),
        ))

    rng = np.random.default_rng(0)
    pts = (rng.random((100_000, 3), dtype=np.float32) * 2.6 - 1.3)
    cols = rng.random((100_000, 3), dtype=np.float32)
    return SceneData(views=views, points=pts, colors=cols,
                     cameras_extent=_extent(views))


SCENE_LOADERS = {
    "colmap": read_colmap_scene,
    "blender": read_nerf_synthetic,
}
