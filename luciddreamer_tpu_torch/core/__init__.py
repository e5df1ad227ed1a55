from luciddreamer_tpu_torch.core.types import Camera, GaussianParams, ProcessedGaussians
from luciddreamer_tpu_torch.core import transforms, sh, covariance

__all__ = [
    "Camera",
    "GaussianParams",
    "ProcessedGaussians",
    "transforms",
    "sh",
    "covariance",
]
