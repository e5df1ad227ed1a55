"""PyTorch/CUDA port of ``luciddreamer_tpu`` for NVIDIA Hopper.

This package holds the whole app (``app.LucidDreamerTPU`` and ``cli``: one
image and a prompt -> a dreamed point cloud (``dream/``) -> baked Gaussians
-> videos), the serving path (load a Gaussian scene from a PLY file and
render a camera path through the tiled renderer), the training path
(``train.loop.Trainer``: render, loss, backward, Adam, densify/prune), its
multi-device form on ``torch.distributed`` (``parallel/``: tile-row bands
over a (data, tiles) mesh of processes, ``ShardedTrainer``), and ZoeDepth
inference and training (``models/``: ZoeD_N, ZoeD_K, ZoeD_NK,
``depth_trainer``), the SIBR live-viewer bridge (``viewer``) and the
Gradio UI (``app_gradio``), and the programs that measure and gate it on
the card (``bench``, ``profile_step``, ``smoke``, ``entry``).  The
renderer's forward and backward tile blend and the cotangent column repack
of its binning are hand-written CUDA kernels (``csrc/blend_fwd.cu``,
``csrc/blend_bwd.cu``, ``csrc/repack_cols.cu``).  It imports ``torch``,
numpy and the standard library at module level; Pillow and imageio only
inside the functions that read or write images, gradio only inside
``app_gradio.build_demo``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""

__version__ = "0.1.0"
