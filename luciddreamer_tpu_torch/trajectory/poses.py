"""Camera-pose generators for dreaming and rendering.

Vectorized equivalents of the reference generators
(utils/trajectory.py:168-534).  All functions return (N, 3, 4) world->camera
poses [R | t] in the reference's convention: yaw about +y (note the two sign
conventions below), pitch about +x, camera at -R^-1 t.

``w2c_pose_to_c2w`` reproduces the Blender-json conversion used both by the
dreaming loop (luciddreamer.py:560-567) and the preset generator
(utils/trajectory.py:503-534): flip the y/z axes (OpenGL <-> COLMAP) and
invert.
"""
from __future__ import annotations

import numpy as np

D2R = np.pi / 180.0


def _yaw(th_deg, sign=-1.0):
    """R_y; the seed presets use [[c,0,-s],[0,1,0],[s,0,c]] (sign=-1,
    utils/trajectory.py:205), rotate360 uses the transpose (sign=+1, :173)."""
    th = np.asarray(th_deg, dtype=np.float64) * D2R
    c, s = np.cos(th), np.sin(th)
    R = np.zeros(th.shape + (3, 3))
    R[..., 0, 0] = c
    R[..., 0, 2] = sign * s
    R[..., 1, 1] = 1.0
    R[..., 2, 0] = -sign * s
    R[..., 2, 2] = c
    return R


def _pitch(phi_deg):
    phi = np.asarray(phi_deg, dtype=np.float64) * D2R
    c, s = np.cos(phi), np.sin(phi)
    R = np.zeros(phi.shape + (3, 3))
    R[..., 0, 0] = 1.0
    R[..., 1, 1] = c
    R[..., 1, 2] = -s
    R[..., 2, 1] = s
    R[..., 2, 2] = c
    return R


def _poses(R, t=None):
    N = R.shape[0]
    out = np.zeros((N, 3, 4))
    out[:, :3, :3] = R
    if t is not None:
        out[:, :3, 3] = t
    return out


def rotate360(viewangle: float = 360.0, n_views: int = 10) -> np.ndarray:
    """generate_seed_360 (:168-176): evenly spaced yaw, zero translation."""
    th = (viewangle / n_views) * np.arange(n_views)
    return _poses(_yaw(th, sign=+1.0))


def _rowscan(phi_rows, degsum=60.0):
    """The 0..+60 then 0..-60 yaw sweep per pitch row (:194-208)."""
    ths = np.concatenate(
        [np.linspace(0, degsum, 4), np.linspace(0, -degsum, 4)[1:]]
    )
    th = np.tile(ths, len(phi_rows))
    phi = np.repeat(np.asarray(phi_rows, dtype=np.float64), len(ths))
    return _poses(_yaw(th) @ _pitch(phi))


def lookaround() -> np.ndarray:
    """generate_seed_preset (:194-208): 3 pitch rows x 7 yaws = 21 poses."""
    return _rowscan([0.0, -22.5, 22.5])


def lookdown() -> np.ndarray:
    """generate_seed_newpreset (:211-225): 2 pitch rows x 7 yaws = 14 poses."""
    return _rowscan([0.0, 22.5])


def moveright() -> np.ndarray:
    """generate_seed_horizon (:228-236)."""
    m = np.linspace(0, 5, 11)
    t = np.stack([-m, np.zeros_like(m), np.zeros_like(m)], axis=-1)
    return _poses(np.broadcast_to(np.eye(3), (11, 3, 3)).copy(), t)


def moveback() -> np.ndarray:
    """generate_seed_backward (:239-245)."""
    m = np.linspace(0, 5, 11)
    t = np.stack([np.zeros_like(m), np.zeros_like(m), m], axis=-1)
    return _poses(np.broadcast_to(np.eye(3), (11, 3, 3)).copy(), t)


def _orbit_translation(th_deg, phi_deg, d):
    """The hemisphere/arc/llff orbit translation (:263,:279): camera orbits
    the point (0, 0, d)."""
    th = np.asarray(th_deg) * D2R
    phi = np.asarray(phi_deg) * D2R
    tx = d * np.sin(th)
    ty = d * np.sin(phi)
    tz = (d - d * np.cos(th)) + (d - d * np.cos(phi))
    return np.stack([tx, ty, tz], axis=-1)


def arc(degree: float = 5.0, d: float = 4.3) -> np.ndarray:
    """generate_seed_arc (:248-263).  NB the reference's th list reduces to
    the single angle 0 (np.arange(0, 5, 5) + np.arange(0, -5, 5)[1:] -> [0])."""
    th = np.arange(0, degree, 5)[: max(0, len(np.arange(0, -degree, -5)) - 0)]
    th = np.array([0.0])  # faithful to the reference's degenerate expression
    phi = np.zeros_like(th)
    return _poses(_yaw(th) @ _pitch(phi), _orbit_translation(th, phi, d))


def hemisphere(center_depth: float, degree: float = 5.0) -> np.ndarray:
    """generate_seed_hemisphere (:266-283): 5 poses orbiting (0,0,depth)."""
    th = np.array([degree, 0.0, 0.0, 0.0, -degree])
    phi = np.array([0.0, -degree, 0.0, degree, 0.0])
    return _poses(
        _yaw(th) @ _pitch(phi), _orbit_translation(th, phi, center_depth)
    )


def back_and_forth() -> np.ndarray:
    """generate_seed_back (:411-428): z 0 -> 5 -> 0, 201 poses, identity R."""
    m = np.concatenate([np.linspace(0, 5, 101), np.linspace(5, 0, 101)[1:]])
    t = np.stack([np.zeros_like(m), np.zeros_like(m), m], axis=-1)
    return _poses(np.broadcast_to(np.eye(3), (len(m), 3, 3)).copy(), t)


def llff(degree: float = 5.0, n_views: int = 400, rounds: int = 4,
         d: float = 2.0) -> np.ndarray:
    """generate_seed_llff (:431-446): spiral of ``rounds`` turns with a slow
    z oscillation."""
    assert rounds % 4 == 0
    s = np.linspace(0, 2 * np.pi * rounds, n_views)
    th = degree * np.sin(s)
    phi = degree * np.cos(s)
    # NB: the reference's z sweep ends at (2*pi*rounds)//4 — floor division
    # binds AFTER the multiply (utils/trajectory.py:435), i.e. 6.0 for
    # rounds=4, not 2*pi — reproduced faithfully for artifact parity
    z = d / 15 * np.sin(np.linspace(0, (2 * np.pi * rounds) // 4, n_views))
    t = _orbit_translation(th, phi, d)
    t[:, 2] -= 2 * z          # the -z appears in both orbit terms (:445)
    return _poses(_yaw(th) @ _pitch(phi), t)


def lookaround_tour(degsum: float = 60.0, pitchmax: float = 22.5) -> np.ndarray:
    """generate_seed_lookaround (:325-391): a 406-pose raster-scan tour —
    top row left->right, down the right edge, middle row right->left, down
    the left edge, bottom row left->right.  Rotation-only poses.  This is
    the generator behind the shipped cameras/lookaround.json (406 frames),
    distinct from the 21-pose ``lookaround`` dreaming preset.

    The edge legs descend in ``pitchmax/22``-degree steps (22 frames each),
    matching the reference's hardcoded edge density; row length scales with
    ``degsum`` (one frame per half degree)."""
    n = int(2 * degsum) + 1
    ne = 22  # reference edge-leg frame count (one per ~1.02 deg at defaults)
    legs = [
        (np.linspace(-degsum, degsum, n), np.full(n, pitchmax)),
        (np.full(ne, degsum), np.linspace(pitchmax, 0, ne + 1)[1:]),
        (np.linspace(degsum, -degsum, n)[1:], np.zeros(n - 1)),
        (np.full(ne, -degsum), np.linspace(0, -pitchmax, ne + 1)[1:]),
        (np.linspace(-degsum, degsum, n), np.full(n, -pitchmax)),
    ]
    th = np.concatenate([leg[0] for leg in legs])
    phi = np.concatenate([leg[1] for leg in legs])
    return _poses(_yaw(th) @ _pitch(phi))


def headbanging(maxdeg: float = 15.0, n_views_per_round: int = 180,
                rounds: int = 2, fullround: int = 0) -> np.ndarray:
    """generate_seed_headbanging (:449-463): spiral-in-spiral look-around.
    generate_seed_headbanging_circle (:466-479) is numerically the same
    function — the shipped headbanging_circle.json is this with maxdeg=5."""
    total = rounds + fullround + rounds
    radius = np.concatenate([
        np.linspace(0, maxdeg, n_views_per_round * rounds),
        maxdeg * np.ones(n_views_per_round * fullround),
        np.linspace(maxdeg, 0, n_views_per_round * rounds),
    ])
    s = np.linspace(0, 2 * np.pi * total, n_views_per_round * total)
    th = 2.66 * radius * np.sin(s)
    phi = radius * np.cos(s)
    return _poses(_yaw(th) @ _pitch(phi))


PCDGEN_PATHS = ("rotate360", "lookaround", "lookdown", "moveright",
                "moveback", "arc", "hemisphere")
RENDER_PATHS = ("back_and_forth", "llff", "headbanging")


def get_pcdgen_poses(name: str, argdict: dict | None = None) -> np.ndarray:
    """get_pcdGenPoses dispatch (utils/trajectory.py:483-500)."""
    argdict = argdict or {}
    if name == "rotate360":
        return rotate360(360.0, 10)
    if name == "lookaround":
        return lookaround()
    if name == "lookdown":
        return lookdown()
    if name == "moveright":
        return moveright()
    if name == "moveback":
        return moveback()
    if name == "arc":
        return arc()
    if name == "hemisphere":
        return hemisphere(argdict["center_depth"])
    raise ValueError(f"unknown pcdgen path {name!r}")


_YZ_REVERSE = np.diag([1.0, -1.0, -1.0])


def w2c_pose_to_c2w(pose: np.ndarray) -> np.ndarray:
    """(3,4) w2c [R|t] -> 4x4 Blender-convention c2w: flip y/z, invert
    (utils/trajectory.py:514-524, luciddreamer.py:560-567)."""
    Rw2i = pose[:3, :3]
    Tw2i = pose[:3, 3:4]
    Ri2w = (_YZ_REVERSE @ Rw2i).T
    Ti2w = -Ri2w @ (_YZ_REVERSE @ Tw2i)
    out = np.eye(4)
    out[:3, :3] = Ri2w
    out[:3, 3:4] = Ti2w
    return out


def get_camera_paths() -> dict:
    """get_camerapaths (:502-534): Blender-json frames for the 3 render
    presets (back_and_forth 201, llff 400, headbanging 720 poses)."""
    out = {}
    gens = {
        "back_and_forth": back_and_forth,
        "llff": lambda: llff(5, 400, rounds=4, d=2),
        "headbanging": lambda: headbanging(15, 180, rounds=2, fullround=0),
    }
    for name, gen in gens.items():
        frames = [
            {"transform_matrix": w2c_pose_to_c2w(p).tolist()}
            for p in gen()
        ]
        out[name] = {"frames": frames}
    return out
