"""Gradio UI for the port (the twin of ``luciddreamer_tpu/app_gradio.py``).

Image and prompt inputs, camera-path radios, run / create / render
buttons, video outputs, a backend selector over the dream registries and
an examples quick-load gallery fed from ``examples/``.  ``gradio`` is
imported inside ``build_demo`` only.  Run
``python -m luciddreamer_tpu_torch.app_gradio`` where gradio is installed;
the app runs on the CUDA device.
"""
from __future__ import annotations

import glob
import os

from luciddreamer_tpu_torch.device import resolve_device

# backend choices shown in the UI: the dream registries' names.  The
# adapters (sd, sd_controlnet, lama, zoedepth) run on the app's device and
# need their packages and checkpoints: a missing package raises ImportError
# when a button runs one.
INPAINTER_CHOICES = ["classic", "sd", "sd_controlnet", "lama"]
DEPTH_CHOICES = ["radial", "zoedepth_flax", "zoedepth"]

# SD checkpoint choices for the sd / sd_controlnet backends, as HF repo ids
SD_CHECKPOINTS = {
    "SD1.5 (default)": None,
    "Blazing Drive V11m": "ironjr/BlazingDriveV11m",
    "RealCartoon-Pixar V5": "ironjr/RealCartoon-PixarV5",
    "Realistic Vision V5.1": "ironjr/RealisticVisionV5-1",
}


def find_examples(root: str | None = None):
    """[(image_path, prompt, negative_prompt)] from an examples/ directory
    of <name>.png|jpg + <name>.txt + <name>_negative.txt triples."""
    if root is None:
        root = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "examples",
        )
    out = []
    for img in sorted(
        glob.glob(os.path.join(root, "*.png"))
        + glob.glob(os.path.join(root, "*.jpg"))
    ):
        stem = os.path.splitext(img)[0]
        prompt, neg = "", ""
        if os.path.exists(stem + ".txt"):
            with open(stem + ".txt") as f:
                prompt = f.readline().strip()
        if os.path.exists(stem + "_negative.txt"):
            with open(stem + "_negative.txt") as f:
                neg = f.readline().strip()
        out.append((img, prompt, neg))
    return out


def build_demo(save_dir: str = "./gradio_output", device=None):
    """The Blocks app; its pipelines run on ``device`` (default: the CUDA
    device, which must exist)."""
    import gradio as gr

    from luciddreamer_tpu_torch.app import LucidDreamerTPU
    from luciddreamer_tpu_torch.dream import DreamConfig

    device = resolve_device(device)
    state = {"ld": None, "backends": None, "has_scene": False}

    def get_ld(inpainter, depth_model, ckpt_label):
        key = (inpainter, depth_model, ckpt_label)
        if state["ld"] is None or state["backends"] != key:
            state["ld"] = LucidDreamerTPU(
                dream_config=DreamConfig(
                    inpainter=inpainter, depth_estimator=depth_model,
                    model_name=SD_CHECKPOINTS.get(ckpt_label),
                ),
                save_dir=save_dir, device=device,
            )
            state["backends"] = key
            state["has_scene"] = False
        return state["ld"]

    def create_only(image, prompt, neg_prompt, campath_gen, seed,
                    diff_steps, inpainter, depth_model, ckpt_label):
        ld = get_ld(inpainter, depth_model, ckpt_label)
        out = ld.create(image, prompt, neg_prompt, campath_gen, int(seed),
                        int(diff_steps))
        state["has_scene"] = True
        return out

    def render_only(campath_render, inpainter, depth_model, ckpt_label):
        # changing a backend dropdown rebuilds the pipeline and discards
        # any baked scene: say so instead of rendering an empty scene
        key = (inpainter, depth_model, ckpt_label)
        if state["ld"] is None or state["backends"] != key or not (
            state["has_scene"]
        ):
            raise gr.Error(
                "No scene is baked for the selected backends — run "
                "'Create scene' first (changing a model dropdown resets "
                "the pipeline)."
            )
        rgb_path, depth_path = state["ld"].render_video(campath_render)
        return rgb_path, depth_path

    def run_all(image, prompt, neg_prompt, campath_gen, campath_render,
                seed, diff_steps, inpainter, depth_model, ckpt_label):
        create_only(image, prompt, neg_prompt, campath_gen, seed,
                    diff_steps, inpainter, depth_model, ckpt_label)
        return render_only(campath_render, inpainter, depth_model,
                           ckpt_label)

    with gr.Blocks(title="LucidDreamer-TPU") as demo:
        gr.Markdown("# LucidDreamer-TPU: image + text -> 3D Gaussian scene")
        with gr.Row():
            with gr.Column():
                image = gr.Image(type="pil", label="Input image")
                prompt = gr.Textbox(label="Text prompt")
                neg = gr.Textbox(label="Negative prompt")
                inpainter = gr.Dropdown(
                    INPAINTER_CHOICES, value="classic",
                    label="Inpainting model",
                )
                sd_ckpt = gr.Dropdown(
                    list(SD_CHECKPOINTS), value="SD1.5 (default)",
                    label="SD checkpoint (sd / sd_controlnet backends)",
                )
                depth_model = gr.Dropdown(
                    DEPTH_CHOICES, value="radial", label="Depth model",
                )
                campath_gen = gr.Radio(
                    ["lookdown", "lookaround", "rotate360"],
                    value="lookdown", label="Generation camera path",
                )
                campath_render = gr.Radio(
                    ["back_and_forth", "llff", "headbanging"],
                    value="llff", label="Render camera path",
                )
                seed = gr.Number(value=1, label="Seed", precision=0)
                steps = gr.Slider(1, 50, value=30, step=1,
                                  label="Inpainting steps")
                btn_run = gr.Button("Run all")
                btn_create = gr.Button("Create scene")
                btn_render = gr.Button("Render video")
                examples = find_examples()
                if examples:
                    gr.Examples(
                        examples=[list(e) for e in examples],
                        inputs=[image, prompt, neg],
                        label="Examples (quick load)",
                    )
            with gr.Column():
                vid_rgb = gr.Video(label="RGB video")
                vid_depth = gr.Video(label="Depth video")
                ply_file = gr.File(label="Gaussian splat (.ply)")

        btn_run.click(
            run_all,
            [image, prompt, neg, campath_gen, campath_render, seed, steps,
             inpainter, depth_model, sd_ckpt],
            [vid_rgb, vid_depth],
        )
        btn_create.click(
            create_only,
            [image, prompt, neg, campath_gen, seed, steps, inpainter,
             depth_model, sd_ckpt],
            [ply_file],
        )
        btn_render.click(
            render_only, [campath_render, inpainter, depth_model, sd_ckpt],
            [vid_rgb, vid_depth],
        )
    return demo


def main():
    demo = build_demo()
    demo.launch()


if __name__ == "__main__":
    main()
