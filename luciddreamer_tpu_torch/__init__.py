"""PyTorch/CUDA port of ``luciddreamer_tpu`` for NVIDIA Hopper.

This package holds the serving path (load a Gaussian scene from a PLY file
and render a camera path through the tiled renderer) and the training path
(``train.loop.Trainer``: render, loss, backward, Adam, densify/prune).  The
renderer's forward and backward tile blend and the cotangent column repack
of its binning are hand-written CUDA kernels (``csrc/blend_fwd.cu``,
``csrc/blend_bwd.cu``, ``csrc/repack_cols.cu``).  It imports ``torch``,
numpy and the standard library only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""
