"""The dreaming loop: lift a single image to a 3D point cloud by iterative
warp -> inpaint -> depth-lift, then build the traindata dict (the twin of
``luciddreamer_tpu/dream/pipeline.py``).

The host drives the per-view loop; the cloud and every geometry op
(projection, splatting, mask morphology, depth alignment, border
compensation) stay on the device.  Random draws come from one
``torch.Generator`` seeded from ``seed``, so they differ from the JAX
package's, which splits a PRNG key per call.

Behaviours kept from the JAX package:
* ``align="reference"`` keeps the depth scale at 1.0, as the original
  LucidDreamer's per-view Adam loop does (its scale is detached from the
  graph); ``"closed_form"`` (default) solves the same least-squares problem
  exactly, and ``"adam"`` runs its 100 steps for real;
* Delaunay interpolation -> forward splat + neighbour fill (dream/warp.py);
* the border-depth compensation's scattered interpolation -> k-NN
  inverse-distance weighting over at most ANCHOR_CAP border anchors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from luciddreamer_tpu_torch.config import CameraConfig
from luciddreamer_tpu_torch.device import resolve_device
from luciddreamer_tpu_torch.dream import warp
from luciddreamer_tpu_torch.dream.protocols import (
    get_depth_estimator,
    get_inpainter,
)
from luciddreamer_tpu_torch.trajectory import get_pcdgen_poses, w2c_pose_to_c2w

ANCHOR_CAP = 8192      # most border anchors the compensation interpolates


@dataclasses.dataclass
class DreamConfig:
    inpainter: str = "classic"
    depth_estimator: str = "radial"
    model_name: str | None = None  # checkpoint for backends that take one
    align: str = "closed_form"     # "closed_form" | "adam" | "reference"
    fill_iters: int = 8
    store_frame_depth: bool = True  # keep each frame's warped depth, so
    #                                 training can use the depth loss


def _to_image01(rgb_cond) -> np.ndarray:
    arr = np.asarray(rgb_cond)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return np.clip(arr.astype(np.float32), 0.0, 1.0)


def _condition_input(image01, cam: CameraConfig, inpainter, prompt,
                     negative_prompt, steps, rng, device):
    """Centre-crop, or outpaint, the conditioning image to H x W; returns
    an (H, W, 3) tensor on ``device``.  The image is quantised to 8 bits
    as the JAX package does; Pillow resizes only where the size differs."""
    h_in, w_in = image01.shape[:2]
    H, W = cam.image_height, cam.image_width

    if w_in / h_in > 1.1 or h_in / w_in > 1.1:
        from PIL import Image

        # aspect far from square: paste on a square canvas, outpaint borders
        res = max(w_in, h_in)
        canvas = np.zeros((res, res, 3), np.float32)
        mask = np.ones((res, res), np.float32)
        y0 = int(res / 2 - h_in / 2)
        x0 = int(res / 2 - w_in / 2)
        canvas[y0 : y0 + h_in, x0 : x0 + w_in] = image01
        mask[y0 : y0 + h_in, x0 : x0 + w_in] = 0.0
        canvas = np.asarray(
            Image.fromarray((canvas * 255).astype(np.uint8)).resize((W, H))
        ).astype(np.float32) / 255.0
        mask = np.asarray(
            Image.fromarray((mask * 255).astype(np.uint8)).resize((W, H))
        ).astype(np.float32) / 255.0
        return inpainter(torch.as_tensor(canvas, device=device),
                         torch.as_tensor(mask, device=device),
                         prompt, negative_prompt, steps, rng)
    # nearly square: centre crop + resize
    if w_in > h_in:
        crop = image01[:, int(w_in / 2 - h_in / 2) : int(w_in / 2 + h_in / 2)]
    else:
        crop = image01[int(h_in / 2 - w_in / 2) : int(h_in / 2 + w_in / 2), :]
    q = (crop * 255).astype(np.uint8)
    if q.shape[:2] != (H, W):
        from PIL import Image

        q = np.asarray(Image.fromarray(q).resize((W, H)))
    return torch.as_tensor(q.astype(np.float32) / 255.0, device=device)


def _warp_view(points, colors, K, R, T, H, W, fill_iters):
    """Project the cloud into (R, T); splat colour and depth images and run
    the mask pipeline: one dreamed or aligned view's geometry."""
    pix, z, valid = warp.project(points, K, R, T, H, W)
    img, _ = warp.splat_linear(pix, colors, valid, H, W, fill_iters)
    img = warp.edge_blend(img)
    image2, mask2 = warp.warp_masks(pix, valid, img, H, W)
    dimg, _ = warp.splat_linear(pix, z[:, None], valid, H, W, fill_iters)
    depth2 = warp.edge_blend(dimg)[:, :, 0]
    mask_hf = warp.border_mask(mask2)
    return image2, mask2, depth2, mask_hf, pix, z, valid


def _correspondences(pix, depth, K, R, T):
    """The measured depth at each point's rounded pixel, lifted along that
    pixel's ray to world space: (3, N)."""
    H, W = depth.shape
    u, v = warp.rounded_pixels(pix, H, W)
    d = depth[v, u]
    rays = torch.stack([u.to(torch.float32) * d, v.to(torch.float32) * d, d])
    Rinv = warp.inverse(R)
    return Rinv @ (warp.inverse(K) @ rays) - Rinv @ T.reshape(3, 1)


def _align_scale(mode, points, pix, valid, depth, K, R, T):
    """Depth-scale factor sc minimising ||pcd - sc * unproject(depth)||^2
    over the re-projected correspondences; a 0-d tensor."""
    if mode == "reference":
        return torch.tensor(1.0, device=points.device)
    world = _correspondences(pix, depth, K, R, T)
    w = valid.to(torch.float32)
    num = torch.sum(points * world * w)
    den = torch.sum(world * world * w) + 1e-12
    if mode == "closed_form":
        return num / den
    if mode != "adam":
        raise ValueError(f"unknown align mode {mode!r}")
    # 100 Adam steps (lr 1e-3, torch defaults) on the mean squared residual
    count = torch.clamp_min(torch.sum(w) * 3, 1.0)
    sc = torch.tensor(1.0, device=points.device)
    m = torch.zeros_like(sc)
    vv = torch.zeros_like(sc)
    for t in range(1, 101):
        diff = (points - sc * world) * w
        gr = -2.0 * torch.sum(diff * world * w) / count
        m = 0.9 * m + 0.1 * gr
        vv = 0.999 * vv + 0.001 * gr * gr
        mh = m / (1 - 0.9**t)
        vh = vv / (1 - 0.999**t)
        sc = sc - 1e-3 * mh / (torch.sqrt(vh) + 1e-8)
    return sc


def _border_compensation(points, pix, valid, border_sel, depth, mask2, sc,
                         K, R, T, H, W):
    """New-point lift with border-depth compensation: measure, at the mask
    boundary's correspondences, the camera-depth offset between the cloud
    and the newly lifted surface; interpolate that offset over every pixel;
    lift the pixels at sc * depth + offset.  Returns (new points
    (3, H*W), hole (H*W,) bool: the pixels to add)."""
    Kinv = warp.inverse(K)
    Rinv = warp.inverse(R)
    Tc = T.reshape(3, 1)
    cam_origin = -Rinv @ Tc                                   # (3, 1)

    # anchors: the first ANCHOR_CAP valid border correspondences in index
    # order (the JAX package's stable top_k over the 0/1 mask), then the
    # four image corners at offset 0
    sel = torch.nonzero(border_sel & valid).flatten()[:ANCHOR_CAP]
    corr_world = sc * _correspondences(pix[:, sel], depth, K, R, T)
    vec_cam = corr_world - cam_origin
    vec_pcd = points[:, sel] - cam_origin
    coeff = torch.sum(vec_pcd * vec_cam, 0) / torch.clamp_min(
        torch.sum(vec_cam * vec_cam, 0), 1e-12
    )
    comp_world = cam_origin + vec_cam * coeff[None, :]
    comp_depth = (R @ comp_world + Tc)[2] - (R @ corr_world + Tc)[2]

    dev = points.device
    corners = torch.tensor(
        [[0.0, 0.0], [0.0, H - 1.0], [W - 1.0, 0.0], [W - 1.0, H - 1.0]],
        device=dev,
    )
    anchor_xy = torch.cat([pix[:, sel].T, corners])
    anchor_val = torch.cat([comp_depth, torch.zeros(4, device=dev)])

    xg, yg = warp.pixel_grid(H, W, dev)
    px, py = xg.reshape(-1), yg.reshape(-1)
    new_depth = warp.idw_interpolate(anchor_xy, anchor_val,
                                     torch.stack([px, py], -1))
    d_flat = depth.reshape(-1)
    cam1 = Kinv @ torch.stack([px * d_flat, py * d_flat, d_flat])
    cam2 = Kinv @ torch.stack([px * new_depth, py * new_depth, new_depth])
    world = sc * (Rinv @ (cam1 + cam2) - Rinv @ Tc)
    hole = (1.0 - mask2.reshape(-1)) > 0.5
    return world, hole


def _pose(p, device):
    """(R (3, 3), T (3, 1)) float32 tensors of a (3, 4) w2c pose."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return f32(p[:3, :3]), f32(p[:3, 3:4])


def generate_pcd(
    rgb_cond,
    prompt: str = "",
    negative_prompt: str = "",
    pcdgenpath: str = "lookdown",
    seed: int = 1,
    diff_steps: int = 30,
    cam: Optional[CameraConfig] = None,
    inpainter=None,
    depth_estimator=None,
    config: Optional[DreamConfig] = None,
    progress_callback=None,
    device=None,
):
    """Single image + prompt -> traindata dict: pcd_points (3, N),
    pcd_colors (N, 3), frames with the warped images (uint8), Blender c2w
    matrices and the warped depths, all numpy arrays.  Runs on ``device``
    (default: the CUDA device)."""
    dev = resolve_device(device)
    cfg = config or DreamConfig()
    cam = cam or CameraConfig()
    inpainter = inpainter or get_inpainter(cfg.inpainter,
                                           model=cfg.model_name, device=dev)
    depth_estimator = depth_estimator or get_depth_estimator(
        cfg.depth_estimator, device=dev)
    H, W = cam.image_height, cam.image_width
    K = torch.as_tensor(cam.K, device=dev)
    rng = torch.Generator(device=dev).manual_seed(seed)

    image_curr = _condition_input(_to_image01(rgb_cond), cam, inpainter,
                                  prompt, negative_prompt, diff_steps, rng, dev)
    render_poses = get_pcdgen_poses(pcdgenpath)
    depth_curr = depth_estimator(image_curr)
    cd = depth_curr[H // 2 - 10 : H // 2 + 10, W // 2 - 10 : W // 2 + 10]
    center_depth = float(torch.mean(cd))

    # ---- initialise the cloud from view 0 ----
    pts = warp.unproject(depth_curr, K, *_pose(render_poses[0], dev))
    cols = image_curr.reshape(-1, 3)

    # ---- dreaming loop ----
    for i in range(1, len(render_poses)):
        if progress_callback:
            progress_callback("dream", i, len(render_poses))
        R, T = _pose(render_poses[i], dev)
        image2, mask2, _, mask_hf, pix, _, valid = _warp_view(
            pts, cols, K, R, T, H, W, cfg.fill_iters
        )
        image_curr = inpainter(image2, 1.0 - mask2, prompt, negative_prompt,
                               diff_steps, rng)
        depth_curr = depth_estimator(image_curr)
        sc = _align_scale(cfg.align, pts, pix, valid, depth_curr, K, R, T)
        u, v = warp.rounded_pixels(pix, H, W)
        border_sel = mask_hf[v, u] > 0.5
        new_world, hole = _border_compensation(
            pts, pix, valid, border_sel, depth_curr, mask2, sc,
            K, R, T, H, W,
        )
        pts = torch.cat([pts, new_world[:, hole]], 1)
        cols = torch.cat([cols, image_curr.reshape(-1, 3)[hole]], 0)

    # ---- traindata + aligning loop ----
    traindata = {
        "camera_angle_x": cam.fov_x,
        "W": W,
        "H": H,
        "pcd_points": pts.cpu().numpy(),
        "pcd_colors": cols.cpu().numpy(),
        "frames": [],
    }
    internal_poses = get_pcdgen_poses("hemisphere", {"center_depth": center_depth})
    for i in range(len(render_poses)):
        if progress_callback:
            progress_callback("align", i, len(render_poses))
        Rw2i = render_poses[i, :3, :3]
        Tw2i = render_poses[i, :3, 3:4]
        for j in range(len(internal_poses)):
            Ri2j = internal_poses[j, :3, :3]
            Ti2j = internal_poses[j, :3, 3:4]
            pose = np.concatenate([Ri2j @ Rw2i, Ri2j @ Tw2i + Ti2j], axis=1)
            imagej, maskj, depthj, *_ = _warp_view(
                pts, cols, K, *_pose(pose, dev), H, W, cfg.fill_iters,
            )
            frame = {
                "image": torch.round(imagej * 255).to(torch.uint8).cpu().numpy(),
                "transform_matrix": w2c_pose_to_c2w(pose).tolist(),
            }
            if cfg.store_frame_depth:
                frame["depth"] = (depthj * maskj).cpu().numpy()
            traindata["frames"].append(frame)

    return traindata
