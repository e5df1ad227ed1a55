"""PyTorch/CUDA port of ``luciddreamer_tpu`` for NVIDIA Hopper.

This package holds the whole app (``app.LucidDreamerTPU`` and ``cli``: one
image and a prompt -> a dreamed point cloud (``dream/``) -> baked Gaussians
-> videos), the serving path (load a Gaussian scene from a PLY file and
render a camera path through the tiled renderer) and the training path
(``train.loop.Trainer``: render, loss, backward, Adam, densify/prune).  The
renderer's forward and backward tile blend and the cotangent column repack
of its binning are hand-written CUDA kernels (``csrc/blend_fwd.cu``,
``csrc/blend_bwd.cu``, ``csrc/repack_cols.cu``).  It imports ``torch``,
numpy and the standard library at module level; Pillow and imageio only
inside the functions that read or write images.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""
