from luciddreamer_tpu_torch.scene.scene import (
    Scene,
    TrainView,
    frame_to_camera,
    load_camera_json,
)

__all__ = ["Scene", "TrainView", "frame_to_camera", "load_camera_json"]
