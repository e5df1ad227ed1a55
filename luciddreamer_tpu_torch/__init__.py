"""PyTorch/CUDA port of ``luciddreamer_tpu`` for NVIDIA Hopper.

This package holds the serving path: load a Gaussian scene from a PLY file
and render a camera path through the tiled renderer, whose forward tile
blend is a hand-written CUDA kernel (``csrc/blend_fwd.cu``).  It imports
``torch``, numpy and the standard library only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""
