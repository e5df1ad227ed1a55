"""Scene plumbing used by the render path: Blender-convention frames to
cameras.  The rest of the scene binding (training views, datasets) comes
with the training port."""
from __future__ import annotations

import numpy as np

from luciddreamer_tpu_torch.core.transforms import make_camera
from luciddreamer_tpu_torch.core.types import Camera


def frame_to_camera(transform_matrix, fovx, fovy, W, H, device=None) -> Camera:
    """Blender/OpenGL c2w (y up, z back) -> renderer Camera (COLMAP axes)."""
    c2w = np.array(transform_matrix, dtype=np.float64)
    c2w[:3, 1:3] *= -1
    return make_camera(c2w, fovx, fovy, W, H, device=device)
