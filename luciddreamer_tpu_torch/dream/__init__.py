from luciddreamer_tpu_torch.dream.pipeline import generate_pcd, DreamConfig
from luciddreamer_tpu_torch.dream.protocols import (
    Inpainter,
    DepthEstimator,
    ClassicInpainter,
    RadialDepth,
    get_inpainter,
    get_depth_estimator,
    resolve_sd_checkpoint,
)

__all__ = [
    "generate_pcd",
    "DreamConfig",
    "Inpainter",
    "DepthEstimator",
    "ClassicInpainter",
    "RadialDepth",
    "get_inpainter",
    "get_depth_estimator",
    "resolve_sd_checkpoint",
]
