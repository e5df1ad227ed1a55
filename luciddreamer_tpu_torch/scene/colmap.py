"""COLMAP reconstruction readers and writers, binary and text: cameras,
images (extrinsics) and points3D, with the quaternion <-> rotation helpers.
Numpy only; a copy of ``luciddreamer_tpu/scene/colmap.py``, which the port
does not import.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    """(w, x, y, z) -> 3x3 (colmap_loader.py:43-55)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
    ])


def rotmat2qvec(R):
    """3x3 -> (w, x, y, z) (colmap_loader.py:58-67)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, 24, "iiQQ")
            name, np_ = CAMERA_MODELS[mid]
            params = np.array(_read(f, 8 * np_, "d" * np_))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, 8, "Q")
            # (x, y) float64 and the point3D id int64 (-1: none) per point
            data = np.frombuffer(f.read(24 * npts), dtype=[
                ("xy", "<f8", (2,)), ("id", "<i8")])
            xys = data["xy"].copy()
            ids = data["id"].astype(np.int64)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode(), xys, ids)
    return images


def read_points3D_binary(path):
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyzs = np.empty((n, 3))
        rgbs = np.empty((n, 3), np.uint8)
        errors = np.empty(n)
        for i in range(n):
            _read(f, 8, "Q")
            xyzs[i] = _read(f, 24, "ddd")
            rgbs[i] = _read(f, 3, "BBB")
            errors[i] = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyzs, rgbs, errors


def read_cameras_text(path):
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(
            cid, parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]),
        )
    return cams


def read_images_text(path):
    images = {}
    lines = [l.strip() for l in open(path)
             if l.strip() and not l.startswith("#")]
    for head, pts in zip(lines[0::2], lines[1::2]):
        e = head.split()
        iid = int(e[0])
        qvec = np.array([float(x) for x in e[1:5]])
        tvec = np.array([float(x) for x in e[5:8]])
        cam_id = int(e[8])
        name = e[9]
        vals = pts.split()
        xys = np.array(
            [(float(vals[i]), float(vals[i + 1]))
             for i in range(0, len(vals), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(vals[i + 2]) for i in range(0, len(vals), 3)])
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3D_text(path):
    xyzs, rgbs, errors = [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        xyzs.append([float(x) for x in e[1:4]])
        rgbs.append([int(x) for x in e[4:7]])
        errors.append(float(e[7]))
    return (np.array(xyzs), np.array(rgbs, np.uint8), np.array(errors))


def read_model(sparse_dir: str):
    """Load (cameras, images, points3D) preferring binary files
    (dataset_readers.py:148-157 semantics)."""
    def pick(base, bin_fn, txt_fn):
        b = os.path.join(sparse_dir, base + ".bin")
        t = os.path.join(sparse_dir, base + ".txt")
        return bin_fn(b) if os.path.exists(b) else txt_fn(t)

    cams = pick("cameras", read_cameras_binary, read_cameras_text)
    images = pick("images", read_images_binary, read_images_text)
    pts = pick("points3D", read_points3D_binary, read_points3D_text)
    return cams, images, pts


def write_cameras_text(cams: dict, path: str):
    with open(path, "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            p = " ".join(str(float(x)) for x in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {p}\n")


def write_images_text(images: dict, path: str):
    with open(path, "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            q = " ".join(str(float(x)) for x in im.qvec)
            t = " ".join(str(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{x} {y} {i}" for (x, y), i in zip(im.xys, im.point3D_ids)
            ) + "\n")
