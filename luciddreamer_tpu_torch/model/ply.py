"""PLY save/load, byte-compatible with the 3DGS ecosystem schema and with
``luciddreamer_tpu.model.ply``.

binary_little_endian float properties
x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..(3K-1),opacity,scale_0..2,rot_0..3;
the f_rest block is channel-major.
"""
from __future__ import annotations

import numpy as np
import torch

from luciddreamer_tpu_torch.core.types import GaussianParams
from luciddreamer_tpu_torch.device import resolve_device


def _attribute_names(n_rest: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(params: GaussianParams, path: str) -> int:
    """Write alive Gaussians; returns the point count."""
    host = lambda t: t.detach().cpu().numpy()
    alive = host(params.alive)
    xyz = host(params.xyz)[alive]
    P = xyz.shape[0]
    n_rest = params.features_rest.shape[1]

    f_dc = host(params.features_dc)[alive]                  # (P, 1, 3)
    f_rest = host(params.features_rest)[alive]              # (P, K, 3)
    f_dc_flat = f_dc.transpose(0, 2, 1).reshape(P, 3)
    f_rest_flat = f_rest.transpose(0, 2, 1).reshape(P, 3 * n_rest)

    cols = np.concatenate(
        [
            xyz,
            np.zeros((P, 3), np.float32),                   # normals
            f_dc_flat,
            f_rest_flat,
            host(params.opacity)[alive],
            host(params.scaling)[alive],
            host(params.rotation)[alive],
        ],
        axis=1,
    ).astype("<f4")

    names = _attribute_names(n_rest)
    dtype = np.dtype([(n, "<f4") for n in names])
    rec = np.rec.fromarrays(cols.T, dtype=dtype)

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {P}\n"
        + "".join(f"property float {n}\n" for n in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)
    return P


def load_ply(path: str, capacity: int | None = None, device=None) -> GaussianParams:
    """Read a 3DGS ply; rows past the point count up to ``capacity`` are
    dead (zero parameters, ``alive`` False)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a ply file")
        names, count = [], 0
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"format" and parts[1] != b"binary_little_endian":
                raise ValueError(f"{path}: only binary_little_endian supported")
            if parts[0] == b"element" and parts[1] == b"vertex":
                count = int(parts[2])
            if parts[0] == b"property":
                names.append(parts[2].decode())
        dtype = np.dtype([(n, "<f4") for n in names])
        rec = np.fromfile(f, dtype=dtype, count=count)

    def block(prefix, n):
        return np.stack([rec[f"{prefix}_{i}"] for i in range(n)], axis=1)

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    n_rest = sum(1 for n in names if n.startswith("f_rest_")) // 3
    f_dc = block("f_dc", 3)[:, None, :]                      # (P, 1, 3)
    if n_rest:
        f_rest = (
            block("f_rest", 3 * n_rest)
            .reshape(count, 3, n_rest)
            .transpose(0, 2, 1)
        )
    else:
        f_rest = np.zeros((count, 0, 3), np.float32)

    P = count
    capacity = capacity or P

    def pad(x):
        x = np.pad(x, [(0, capacity - P)] + [(0, 0)] * (x.ndim - 1))
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    return GaussianParams(
        xyz=pad(xyz),
        features_dc=pad(f_dc),
        features_rest=pad(f_rest),
        scaling=pad(block("scale", 3)),
        rotation=pad(block("rot", 4)),
        opacity=pad(rec["opacity"][:, None]),
        alive=torch.as_tensor(np.arange(capacity) < P, device=dev),
    )
