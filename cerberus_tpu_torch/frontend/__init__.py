"""Port of the JAX package's `frontend` modules: the legged EKF, the
OpenCV tracker copy and the device KLT tracker."""

from cerberus_tpu_torch.frontend.ekf import (EKFParams, EKFState, LeggedEKF,  # noqa: F401
                                             ekf_init, ekf_step)
