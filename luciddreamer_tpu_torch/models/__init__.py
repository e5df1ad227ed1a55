"""Neural models: the ZoeDepth monodepth stack (inference, and training in
``depth_trainer`` with ``depth_losses``, ``depth_eval`` and ``depth_data``).

``ZoeDepth`` mirrors the JAX package's ``FlaxZoeDepth``, ``ZoeDepthNK``
its ``FlaxZoeDepthNK`` and ``ZoeDepthEstimator`` its
``FlaxZoeDepthEstimator``."""

from luciddreamer_tpu_torch.models.zoedepth import (
    ZoeDepthConfig,
    ZoeDepth,
    ZoeDepthEstimator,
)

__all__ = ["ZoeDepthConfig", "ZoeDepth", "ZoeDepthEstimator"]
