"""Camera-path JSON export: the sweep behind the shipped ``cameras/*.json``
presets (the twin of ``luciddreamer_tpu/trajectory/export.py``).

Writes the Blender-style schema the loaders read:
{"camera_angle_x": fov, "frames": [{"transform_matrix": 3x4 c2w}, ...]}.
Run ``python -m luciddreamer_tpu_torch.trajectory.export [outdir]`` to
write every preset (default ``cameras/``).
"""
from __future__ import annotations

import json
import os

import numpy as np

from luciddreamer_tpu_torch.trajectory import poses as P
from luciddreamer_tpu_torch.trajectory.poses import w2c_pose_to_c2w

# the shipped intrinsics: focal 582.69 at W = 512
FOV_X = 2.0 * float(np.arctan(512 / (2 * 5.8269e2)))          # 0.827910
FOV_X_12 = FOV_X * 1.2                                        # 0.993492

# name -> (generator, kwargs, camera_angle_x): the 22 shipped presets;
# 360 == rotate360, 1440 == rotate1440 and back == back_and_forth are
# shipped as duplicate files
EXPORTABLE = {
    "back_and_forth": (P.back_and_forth, {}, FOV_X),
    "back": (P.back_and_forth, {}, FOV_X),
    "llff": (P.llff, dict(degree=5, n_views=400, rounds=4, d=1), FOV_X),
    "llff_d0.25": (P.llff, dict(degree=5, n_views=400, rounds=4, d=0.25), FOV_X),
    "llff_d0.5": (P.llff, dict(degree=5, n_views=400, rounds=4, d=0.5), FOV_X),
    "llff_d1": (P.llff, dict(degree=5, n_views=400, rounds=4, d=1), FOV_X),
    "llff_d2": (P.llff, dict(degree=5, n_views=400, rounds=4, d=2), FOV_X_12),
    "llff_d4": (P.llff, dict(degree=5, n_views=400, rounds=4, d=4), FOV_X_12),
    "llff_d6": (P.llff, dict(degree=5, n_views=400, rounds=4, d=6), FOV_X_12),
    "llff_d8": (P.llff, dict(degree=5, n_views=400, rounds=4, d=8), FOV_X_12),
    "headbanging": (P.headbanging, dict(maxdeg=20, n_views_per_round=180,
                                        rounds=3, fullround=0), FOV_X_12),
    "headbanging_r2": (P.headbanging, dict(maxdeg=15, n_views_per_round=180,
                                           rounds=2, fullround=0), FOV_X_12),
    "headbanging_r3": (P.headbanging, dict(maxdeg=15, n_views_per_round=180,
                                           rounds=3, fullround=0), FOV_X_12),
    "headbanging_circle": (P.headbanging, dict(maxdeg=5, n_views_per_round=180,
                                               rounds=2, fullround=0), FOV_X),
    "rotate360": (P.rotate360, dict(viewangle=360.0, n_views=720), FOV_X),
    "360": (P.rotate360, dict(viewangle=360.0, n_views=720), FOV_X),
    "rotate360_fov1.2": (P.rotate360, dict(viewangle=360.0, n_views=720),
                         FOV_X_12),
    "360_fov1.2": (P.rotate360, dict(viewangle=360.0, n_views=720), FOV_X_12),
    "rotate1440": (P.rotate360, dict(viewangle=360.0, n_views=1440), FOV_X),
    "1440": (P.rotate360, dict(viewangle=360.0, n_views=1440), FOV_X),
    "lookaround": (P.lookaround_tour, {}, FOV_X),
    "lookdown": (P.lookdown, {}, FOV_X),
}


def export_camera_json(name: str, path: str,
                       camera_angle_x: float | None = None) -> str:
    """Write preset ``name`` to ``path``; ``camera_angle_x`` overrides its
    field of view.  Returns ``path``."""
    gen, kw, fov = EXPORTABLE[name]
    frames = [
        {"transform_matrix": w2c_pose_to_c2w(p)[:3].tolist()}
        for p in gen(**kw)
    ]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {"camera_angle_x": fov if camera_angle_x is None else camera_angle_x,
             "frames": frames}, f
        )
    return path


def export_all(outdir: str, camera_angle_x: float | None = None) -> list[str]:
    """Every preset as ``<outdir>/<name>.json``; returns the paths."""
    return [
        export_camera_json(name, os.path.join(outdir, f"{name}.json"),
                           camera_angle_x)
        for name in EXPORTABLE
    ]


if __name__ == "__main__":
    import sys

    export_all(sys.argv[1] if len(sys.argv) > 1 else "cameras")
