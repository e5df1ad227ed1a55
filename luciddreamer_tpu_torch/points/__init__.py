from luciddreamer_tpu_torch.points.knn import mean_sq_dist_3nn

__all__ = ["mean_sq_dist_3nn"]
