"""CLI: single image + prompt -> 3D Gaussian scene -> videos, on the CUDA
device (the twin of ``luciddreamer_tpu/cli.py``, with the same flags).

    python -m luciddreamer_tpu_torch.cli --image ex.png --text "a lake house" \
        --campath_gen lookdown --campath_render llff
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Arguments for LucidDreamer-TPU")
    p.add_argument("--image", "-img", type=str, required=True,
                   help="Input image for scene generation")
    p.add_argument("--text", "-t", type=str, default="",
                   help="Text prompt (inline or path to .txt)")
    p.add_argument("--neg_text", "-nt", type=str, default="",
                   help="Negative text prompt (inline or path to .txt)")
    p.add_argument("--campath_gen", "-cg", type=str, default="lookdown",
                   choices=["lookdown", "lookaround", "rotate360"],
                   help="Camera trajectory for scene generation")
    p.add_argument("--campath_render", "-cr", type=str, default="llff",
                   choices=["back_and_forth", "llff", "headbanging"],
                   help="Camera trajectory for video rendering")
    p.add_argument("--inpainter", type=str, default="classic",
                   help="Inpainting backend (classic | registered name; "
                        "sd, lama and sd_controlnet are not ported yet)")
    p.add_argument("--model_name", "-m", type=str, default=None,
                   help="Checkpoint for inpainters that take one: hub id, "
                        "local diffusers dir, or a .safetensors file "
                        "(converted once)")
    p.add_argument("--depth_model", type=str, default="radial",
                   help="Depth backend (radial | registered name; zoedepth "
                        "and zoedepth_flax are not ported yet)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--diff_steps", type=int, default=50,
                   help="Inpainting inference steps")
    p.add_argument("--save_dir", "-s", type=str, default="")
    p.add_argument("--iterations", type=int, default=None,
                   help="Override 3DGS optimization iterations")
    p.add_argument("--lambda_depth", type=float, default=0.0,
                   help="Weight of the masked depth L1 term (0 = off)")
    p.add_argument("--image_size", type=int, default=512,
                   help="Working resolution (the focal length scales with "
                        "it, so the field of view is kept)")
    return p


def read_text(arg: str) -> str:
    if arg.endswith(".txt") and os.path.exists(arg):
        with open(arg) as f:
            return f.readline().strip()
    return arg


def main(argv=None, device=None):
    """Run the CLI on ``device`` (default: the CUDA device, which must be
    present)."""
    args = build_parser().parse_args(argv)
    from PIL import Image

    from luciddreamer_tpu_torch.app import LucidDreamerTPU
    from luciddreamer_tpu_torch.config import CameraConfig, GSConfig
    from luciddreamer_tpu_torch.device import resolve_device
    from luciddreamer_tpu_torch.dream import DreamConfig, resolve_sd_checkpoint
    from luciddreamer_tpu_torch.dream.protocols import inpainter_factory

    # before anything is written or a checkpoint converted
    device = resolve_device(device)
    inpainter_factory(args.inpainter, args.model_name)

    rgb_cond = Image.open(args.image).convert("RGB")
    txt = read_text(args.text)
    neg = read_text(args.neg_text)

    if not args.save_dir:
        img_name = os.path.splitext(os.path.basename(args.image))[0]
        args.save_dir = f"./outputs/{img_name}_{args.campath_gen}_{args.seed}"
    os.makedirs(args.save_dir, exist_ok=True)

    gs_cfg = GSConfig()
    if args.iterations is not None:
        gs_cfg.iterations = args.iterations
        gs_cfg.position_lr_max_steps = args.iterations
    if args.lambda_depth > 0.0:
        gs_cfg.lambda_depth = args.lambda_depth
        gs_cfg.use_depth = True

    s = args.image_size
    focal = 5.8269e02 * s / 512.0
    ld = LucidDreamerTPU(
        gs_config=gs_cfg,
        cam_config=CameraConfig(image_width=s, image_height=s,
                                focal=(focal, focal)),
        dream_config=DreamConfig(
            inpainter=args.inpainter, depth_estimator=args.depth_model,
            model_name=resolve_sd_checkpoint(
                args.model_name,
                out_root=os.path.join(args.save_dir, "stablediffusion"),
            ),
        ),
        save_dir=args.save_dir,
        seed=args.seed,
        device=device,
    )

    def progress(stage, i, n):
        print(f"[{stage}] {i}/{n}", flush=True)

    ld.create(rgb_cond, txt, neg, args.campath_gen, args.seed,
              args.diff_steps, progress_callback=progress)
    paths = ld.render_video(args.campath_render)
    print("wrote:", *paths)


if __name__ == "__main__":
    main()
