"""Port of the JAX package's `estimator` modules."""

from cerberus_tpu_torch.estimator.packing import pack_window_data, whiten_chol  # noqa: F401
from cerberus_tpu_torch.estimator.initial_sfm import (  # noqa: F401
    calibrate_ex_rotation,
    global_sfm,
    relative_pose_ransac,
    visual_imu_alignment,
)
