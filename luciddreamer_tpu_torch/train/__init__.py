from luciddreamer_tpu_torch.train.losses import (
    l1_loss, l2_loss, near_mean_map, psnr, ssim)
from luciddreamer_tpu_torch.train.loop import Trainer, TrainState

__all__ = ["l1_loss", "l2_loss", "ssim", "psnr", "near_mean_map", "Trainer",
           "TrainState"]
