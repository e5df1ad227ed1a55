"""Neural models: the ZoeDepth monodepth stack (inference).

``ZoeDepth`` mirrors the JAX package's ``FlaxZoeDepth``, ``ZoeDepthNK``
its ``FlaxZoeDepthNK`` and ``ZoeDepthEstimator`` its
``FlaxZoeDepthEstimator``."""

from luciddreamer_tpu_torch.models.zoedepth import (
    ZoeDepthConfig,
    ZoeDepth,
    ZoeDepthEstimator,
)

__all__ = ["ZoeDepthConfig", "ZoeDepth", "ZoeDepthEstimator"]
