from luciddreamer_tpu_torch.trajectory.poses import (
    get_pcdgen_poses,
    get_camera_paths,
    w2c_pose_to_c2w,
    PCDGEN_PATHS,
    RENDER_PATHS,
)

__all__ = [
    "get_pcdgen_poses",
    "get_camera_paths",
    "w2c_pose_to_c2w",
    "PCDGEN_PATHS",
    "RENDER_PATHS",
]
