from luciddreamer_tpu_torch.points.knn import mean_sq_dist_3nn
from luciddreamer_tpu_torch.points.knn_exact import mean_sq_dist_3nn_exact

__all__ = ["mean_sq_dist_3nn", "mean_sq_dist_3nn_exact"]
