"""Monodepth data pipeline: augmentations and dataset adapters, the port's
own copy of ``luciddreamer_tpu/models/depth_data.py`` (numpy, scipy and
Pillow only; Pillow and scipy are imported inside the functions that use
them).

Functional port of the ZoeDepth data machinery (ZoeDepth/zoedepth/data/
transforms.py random crop/rotate/flip/colour jitter, data_mono.py loaders,
RepetitiveRoundRobinDataLoader for mixed-dataset training).  Datasets are
plain iterables of (image (H, W, 3) in [0, 1], depth (H, W) metres) numpy
pairs; the adapters read the standard folder layouts when present.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class AugmentConfig:
    """transforms.py defaults: rotate +-2.5 deg (degree), random crop,
    horizontal flip p=0.5, color jitter gamma/brightness/color."""

    crop_h: int = 416
    crop_w: int = 544
    rotate_deg: float = 2.5
    hflip_p: float = 0.5
    gamma_range: tuple = (0.9, 1.1)
    brightness_range: tuple = (0.9, 1.1)
    color_range: tuple = (0.9, 1.1)


def augment_sample(image, depth, rng: np.random.Generator,
                   cfg: AugmentConfig | None = None):
    """Random rotate -> crop -> flip -> photometric jitter, applied jointly
    to (image, depth) (transforms.py train path)."""
    cfg = cfg or AugmentConfig()
    H, W = depth.shape

    # rotate (nearest for depth, bilinear for image) via scipy
    angle = rng.uniform(-cfg.rotate_deg, cfg.rotate_deg)
    if abs(angle) > 1e-3:
        from scipy.ndimage import rotate as ndrotate

        image = ndrotate(image, angle, axes=(0, 1), reshape=False, order=1,
                         mode="nearest")
        depth = ndrotate(depth, angle, reshape=False, order=0,
                         mode="nearest")

    # random crop
    ch = min(cfg.crop_h, H)
    cw = min(cfg.crop_w, W)
    y0 = rng.integers(0, H - ch + 1)
    x0 = rng.integers(0, W - cw + 1)
    image = image[y0 : y0 + ch, x0 : x0 + cw]
    depth = depth[y0 : y0 + ch, x0 : x0 + cw]

    # horizontal flip
    if rng.random() < cfg.hflip_p:
        image = image[:, ::-1]
        depth = depth[:, ::-1]

    # photometric jitter (image only)
    image = np.clip(image, 1e-4, 1.0) ** rng.uniform(*cfg.gamma_range)
    image = image * rng.uniform(*cfg.brightness_range)
    image = image * rng.uniform(*cfg.color_range, size=(1, 1, 3))
    return np.clip(image, 0.0, 1.0).astype(np.float32), depth.astype(np.float32)


def batched(dataset, batch_size: int, rng: np.random.Generator,
            augment: AugmentConfig | None = None, repeat: bool = True):
    """Yield (image (B,H,W,3), depth (B,H,W)) batches with augmentation."""
    items = list(dataset)
    while True:
        order = rng.permutation(len(items))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            ims, ds = [], []
            for j in order[i : i + batch_size]:
                im, d = items[j]
                if augment is not None:
                    im, d = augment_sample(im, d, rng, augment)
                ims.append(im)
                ds.append(d)
            yield np.stack(ims), np.stack(ds)
        if not repeat:
            return


def round_robin(*loaders):
    """RepetitiveRoundRobinDataLoader (data_mono.py:181-238): alternate
    batches from several dataset loaders, repeating shorter ones."""
    iters = [iter(l) for l in loaders]
    for i in itertools.count():
        yield next(iters[i % len(iters)])


def load_nyu_folder(root: str, split_file: str | None = None,
                    max_items: int | None = None):
    """NYUv2 folder adapter (data_mono.py nyu paths): pairs of
    rgb_*.jpg/png + sync_depth_*.png (depth in millimeters / 1000)."""
    from PIL import Image

    pairs = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.startswith("rgb_") and f.rsplit(".", 1)[-1] in ("jpg", "png"):
                stem = f.split("rgb_")[1].rsplit(".", 1)[0]
                dpath = os.path.join(dirpath, f"sync_depth_{stem}.png")
                if os.path.exists(dpath):
                    pairs.append((os.path.join(dirpath, f), dpath))
    if max_items:
        pairs = pairs[:max_items]
    for ipath, dpath in pairs:
        img = np.asarray(Image.open(ipath).convert("RGB"), np.float32) / 255.0
        depth = np.asarray(Image.open(dpath), np.float32) / 1000.0
        yield img, depth


def load_kitti_folder(root: str, max_items: int | None = None):
    """KITTI adapter: image_02/data/*.png + proj_depth/groundtruth
    (depth png / 256)."""
    from PIL import Image

    pairs = []
    for dirpath, _dirs, files in os.walk(root):
        if "image_02" not in dirpath:
            continue
        for f in sorted(files):
            if not f.endswith(".png"):
                continue
            d = dirpath.replace("image_02/data",
                                "proj_depth/groundtruth/image_02")
            dpath = os.path.join(d, f)
            if os.path.exists(dpath):
                pairs.append((os.path.join(dirpath, f), dpath))
    if max_items:
        pairs = pairs[:max_items]
    for ipath, dpath in pairs:
        img = np.asarray(Image.open(ipath).convert("RGB"), np.float32) / 255.0
        depth = np.asarray(Image.open(dpath), np.float32) / 256.0
        yield img, depth


def _read_rgb(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _emit_pairs(pairs, max_items, read_depth):
    pairs = sorted(pairs)
    if max_items:
        pairs = pairs[:max_items]
    for ipath, dpath in pairs:
        yield _read_rgb(ipath), read_depth(dpath).astype(np.float32)


def load_diode_folder(root: str, max_items: int | None = None):
    """DIODE adapter (diode.py:82-121): <root>/scene_#/scan_#/*.png with
    sibling *_depth.npy (meters) + *_depth_mask.npy; invalid pixels -> 0."""
    import glob

    pairs = [
        (f, f.replace(".png", "_depth.npy"))
        for f in glob.glob(os.path.join(root, "*", "*", "*.png"))
        if not f.endswith("_depth.png")
        and os.path.exists(f.replace(".png", "_depth.npy"))
    ]

    def read(dpath):
        depth = np.squeeze(np.load(dpath))
        mpath = dpath.replace("_depth.npy", "_depth_mask.npy")
        if os.path.exists(mpath):
            depth = depth * (np.squeeze(np.load(mpath)) > 0)
        return depth

    yield from _emit_pairs(pairs, max_items, read)


def load_ddad_folder(root: str, max_items: int | None = None):
    """DDAD adapter (ddad.py:82-115): flat <root>/*_rgb.png with sibling
    *_depth.npy in meters."""
    import glob

    pairs = [
        (f, f.replace("_rgb.png", "_depth.npy"))
        for f in glob.glob(os.path.join(root, "*_rgb.png"))
        if os.path.exists(f.replace("_rgb.png", "_depth.npy"))
    ]
    yield from _emit_pairs(pairs, max_items,
                           lambda d: np.squeeze(np.load(d)))


def load_sunrgbd_folder(root: str, max_items: int | None = None):
    """SUN RGB-D adapter (sun_rgbd_loader.py:78-104): rgb/rgb/*.jpg with
    gt/gt/*.png (uint16 mm / 1000; depth > 8 m marked invalid as 0 —
    the reference uses -1, normalized here to this pipeline's 0-invalid
    convention)."""
    import glob
    from PIL import Image

    pairs = []
    for f in glob.glob(os.path.join(root, "rgb", "rgb", "*")):
        d = f.replace(os.path.join("rgb", "rgb"),
                      os.path.join("gt", "gt")).replace("jpg", "png")
        if os.path.exists(d):
            pairs.append((f, d))

    def read(dpath):
        depth = np.asarray(Image.open(dpath), np.float32) / 1000.0
        return np.where(depth > 8.0, 0.0, depth)

    yield from _emit_pairs(pairs, max_items, read)


def load_diml_indoor_folder(root: str, max_items: int | None = None):
    """DIML indoor adapter (diml_indoor_test.py:81-120):
    LR/<scene>/color/*_c.png with depth_filled/*_depth_filled.png
    (uint16 mm / 1000)."""
    import glob
    from PIL import Image

    pairs = []
    for f in glob.glob(os.path.join(root, "LR", "*", "color", "*.png")):
        d = f.replace("color", "depth_filled").replace(
            "_c.png", "_depth_filled.png")
        if os.path.exists(d):
            pairs.append((f, d))
    yield from _emit_pairs(
        pairs, max_items,
        lambda d: np.asarray(Image.open(d), np.float32) / 1000.0,
    )


def load_diml_outdoor_folder(root: str, max_items: int | None = None):
    """DIML outdoor adapter (diml_outdoor_test.py:78-109):
    <root>/*/outleft/*.png with depthmap/*.png (uint16 mm / 1000)."""
    import glob
    from PIL import Image

    pairs = []
    for f in glob.glob(os.path.join(root, "*", "outleft", "*.png")):
        d = f.replace("outleft", "depthmap")
        if os.path.exists(d):
            pairs.append((f, d))
    yield from _emit_pairs(
        pairs, max_items,
        lambda d: np.asarray(Image.open(d), np.float32) / 1000.0,
    )


def load_ibims_folder(root: str, max_items: int | None = None):
    """iBims-1 adapter (ibims.py:34-79): imagelist.txt naming rgb/ +
    depth/ (uint16 * 50 / 65535 m) + mask_invalid/ + mask_transp/; masked
    pixels -> 0 (reference uses -1)."""
    from PIL import Image

    with open(os.path.join(root, "imagelist.txt")) as f:
        names = f.read().split()
    if max_items:
        names = names[:max_items]
    for base in names:
        img = _read_rgb(os.path.join(root, "rgb", base + ".png"))
        depth = np.asarray(
            Image.open(os.path.join(root, "depth", base + ".png")),
            np.float32,
        ) * 50.0 / 65535.0
        for mdir in ("mask_invalid", "mask_transp"):
            mpath = os.path.join(root, mdir, base + ".png")
            if os.path.exists(mpath):
                depth = depth * (np.asarray(Image.open(mpath)) > 0)
        yield img, depth.astype(np.float32)


def load_vkitti2_folder(root: str, max_items: int | None = None):
    """Virtual KITTI 2 adapter (vkitti2.py:83-140):
    rgb/**/frames/rgb/Camera_0/rgb_*.jpg with the mirrored
    depth/.../depth_*.png (16-bit cm / 100)."""
    import glob
    from PIL import Image

    pairs = []
    for f in glob.glob(
        os.path.join(root, "rgb", "**", "frames", "rgb", "Camera_0",
                     "*.jpg"),
        recursive=True,
    ):
        d = f.replace(f"{os.sep}rgb{os.sep}", f"{os.sep}depth{os.sep}").replace(
            "rgb_", "depth_").replace(".jpg", ".png")
        if os.path.exists(d):
            pairs.append((f, d))
    yield from _emit_pairs(
        pairs, max_items,
        lambda d: np.asarray(Image.open(d), np.float32) / 100.0,
    )


def hypersim_distance_to_depth(distance, focal: float = 886.81):
    """Euclidean ray distance -> planar depth (hypersim.py:36-49)."""
    H, W = distance.shape[:2]
    xs = np.linspace(-0.5 * W + 0.5, 0.5 * W - 0.5, W, dtype=np.float32)
    ys = np.linspace(-0.5 * H + 0.5, 0.5 * H - 0.5, H, dtype=np.float32)
    norm = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + focal * focal)
    return distance * focal / norm


def load_hypersim_folder(root: str, max_items: int | None = None):
    """HyperSim adapter (hypersim.py:98-136):
    <scene>/images/scene_cam_*_final_preview/*.tonemap.jpg with hdf5 ray
    distances converted to planar depth.  Needs h5py (import-gated)."""
    import glob

    import h5py  # gated: not a base dependency

    pairs = []
    for f in glob.glob(
        os.path.join(root, "*", "images", "scene_cam_*_final_preview",
                     "*.tonemap.jpg")
    ):
        d = f.replace("_final_preview", "_geometry_hdf5").replace(
            ".tonemap.jpg", ".depth_meters.hdf5")
        if os.path.exists(d):
            pairs.append((f, d))

    def read(dpath):
        with h5py.File(dpath, "r") as fd:
            dist = np.array(fd["dataset"], np.float32)
        return hypersim_distance_to_depth(dist)

    yield from _emit_pairs(pairs, max_items, read)


# name -> folder loader; the registry role of data_mono.DepthDataLoader's
# dataset dispatch (data_mono.py + the 9 adapter modules)
DATASETS = {
    "nyu": load_nyu_folder,
    "kitti": load_kitti_folder,
    "diode": load_diode_folder,
    "ddad": load_ddad_folder,
    "sunrgbd": load_sunrgbd_folder,
    "diml_indoor": load_diml_indoor_folder,
    "diml_outdoor": load_diml_outdoor_folder,
    "ibims": load_ibims_folder,
    "vkitti2": load_vkitti2_folder,
    "hypersim": load_hypersim_folder,
}


def get_depth_dataset(name: str, root: str, max_items: int | None = None):
    """Named dataset dispatch (data_mono.py DepthDataLoader role)."""
    if name not in DATASETS:
        raise KeyError(f"unknown depth dataset {name!r}; have "
                       f"{sorted(DATASETS)}")
    return DATASETS[name](root, max_items=max_items)
