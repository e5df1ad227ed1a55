"""Scene binding: traindata dict -> training views, preset cameras and the
point cloud (the twin of ``luciddreamer_tpu/scene/scene.py``).

* traindata schema (built by the dreaming loop):
  {"camera_angle_x": fovx, "W": int, "H": int,
   "pcd_points": (3, N) float, "pcd_colors": (N, 3) float in [0, 1],
   "frames": [{"image": H x W x 3 float/uint8 array or PIL image,
               "transform_matrix": 4x4 Blender c2w[, "depth": (H, W)]}, ...]}
* per frame: the c2w y/z columns are sign-flipped (OpenGL -> COLMAP axes)
  and inverted to w2c;
* preset render paths get fov * 1.2;
* scene extent = 1.1 * the largest camera-centre distance from their
  centroid.

Images, depths and the cloud stay numpy arrays on the host; cameras are
built on ``device`` (default: the CUDA device).
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from luciddreamer_tpu_torch.core.transforms import focal2fov, fov2focal, make_camera
from luciddreamer_tpu_torch.core.types import Camera
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.train.losses import image2canny
from luciddreamer_tpu_torch.trajectory import get_camera_paths


@dataclass
class TrainView:
    """A training camera plus its ground-truth image (3, H, W) float32, and
    the dream stage's warped metric depth (H, W) where the traindata has
    one."""

    camera: Camera
    image: np.ndarray
    depth: np.ndarray | None = None
    _canny: np.ndarray | None = None

    @property
    def canny_mask(self) -> np.ndarray:
        """(H, W) float32 inverse-Canny mask of the image, computed on first
        use with the reference's per-camera parameters: thresholds
        (50, 150), isEdge1=False."""
        if self._canny is None:
            hwc = np.asarray(self.image).transpose(1, 2, 0)
            self._canny = image2canny(hwc, 50, 150, isEdge1=False)
        return self._canny


def frame_to_camera(transform_matrix, fovx, fovy, W, H, device=None) -> Camera:
    """Blender/OpenGL c2w (y up, z back) -> renderer Camera (COLMAP axes)."""
    c2w = np.array(transform_matrix, dtype=np.float64)
    c2w[:3, 1:3] *= -1
    return make_camera(c2w, fovx, fovy, W, H, device=device)


def _to_image_array(image) -> np.ndarray:
    """-> (3, H, W) float32 in [0, 1], clamped; alpha premultiplied."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 3 and arr.shape[-1] in (3, 4):
        if arr.shape[-1] == 4:
            arr = arr[..., :3] * arr[..., 3:4]
        arr = arr.transpose(2, 0, 1)
    return np.clip(arr.astype(np.float32), 0.0, 1.0)


def _nerfpp_radius(centers: np.ndarray) -> float:
    center = centers.mean(axis=0, keepdims=True)
    diagonal = float(np.linalg.norm(centers - center, axis=1).max())
    return diagonal * 1.1


class Scene:
    """Binds traindata to train views, preset cameras and the point cloud."""

    def __init__(self, traindata: dict, presets: dict | None = None,
                 device=None):
        dev = resolve_device(device)
        fovx = float(traindata["camera_angle_x"])
        frames = traindata["frames"]
        first = _to_image_array(frames[0]["image"])
        H, W = first.shape[1], first.shape[2]
        fovy = focal2fov(fov2focal(fovx, W), H)

        self.train_views: list[TrainView] = []
        for fr in frames:
            depth = fr.get("depth")
            self.train_views.append(TrainView(
                camera=frame_to_camera(fr["transform_matrix"], fovx, fovy, W,
                                       H, device=dev),
                image=_to_image_array(fr["image"]),
                depth=None if depth is None else np.asarray(depth, np.float32),
            ))

        centers = np.stack(
            [v.camera.campos.cpu().numpy() for v in self.train_views]
        )
        self.cameras_extent = _nerfpp_radius(centers)

        presets = presets if presets is not None else get_camera_paths()
        pfovx = fovx * 1.2
        pfovy = focal2fov(fov2focal(pfovx, W), H)
        self.preset_cameras: dict[str, list[Camera]] = {
            name: [frame_to_camera(fr["transform_matrix"], pfovx, pfovy, W, H,
                                   device=dev)
                   for fr in data["frames"]]
            for name, data in presets.items()
        }

        self.pcd_points = np.asarray(traindata["pcd_points"], np.float32).T
        self.pcd_colors = np.asarray(traindata["pcd_colors"], np.float32)

    def get_train_views(self):
        return self.train_views

    def get_preset_cameras(self, name: str):
        return self.preset_cameras[name]


def load_camera_json(path: str, H: int = 512, W: int = 512, device=None):
    """A camera-path JSON (``camera_angle_x`` and frames of 3x4 or 4x4
    Blender c2w matrices) -> Camera list; fovy from fovx by equal focal
    lengths."""
    with open(path) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])
    fovy = focal2fov(fov2focal(fovx, W), H)
    cams = []
    for fr in meta["frames"]:
        m = np.array(fr["transform_matrix"], dtype=np.float64)
        if m.shape == (3, 4):
            m = np.concatenate([m, np.array([[0.0, 0, 0, 1]])], axis=0)
        cams.append(frame_to_camera(m, fovx, fovy, W, H, device=device))
    return cams
