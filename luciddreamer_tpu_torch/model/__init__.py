from luciddreamer_tpu_torch.model.ply import load_ply, save_ply

__all__ = ["load_ply", "save_ply"]
