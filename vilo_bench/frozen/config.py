"""Configuration (frozen copy of the parts of `cerberus_tpu_torch/config.py`
that the window generator reads).

Mirrors the reference's YAML key set (reference: src/utils/parameters.{h,cpp},
config/a1_config/hardware_a1_vilo_config.yaml) as typed dataclasses instead of
~50 mutable globals. Sizes (window length, leg counts, state dims) are module
constants because they fix the shapes of every tensor of the window problem.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# ----------------------------------------------------------------------------
# Static dimensions (reference: src/utils/parameters.h:22-24, 93-102).
# These are *shape* constants of the window problem.
# ----------------------------------------------------------------------------
WINDOW_SIZE = 10          # sliding-window keyframe count (window holds W+1 frames)
NUM_FRAMES = WINDOW_SIZE + 1
NUM_OF_LEG = 4
NUM_OF_DOF = 12           # 3 joints x 4 legs
RHO_OPT_SIZE = 1          # optimized kinematic params per leg (calf length)
TOTAL_RHO_OPT_SIZE = NUM_OF_LEG * RHO_OPT_SIZE
RHO_FIX_SIZE = 4          # fixed kinematic params per leg: [off_x, off_y, motor_off, upper_len]
RESIDUAL_STATE_SIZE = 31  # 3*9 + 4*RHO_OPT_SIZE  (p, theta, v, eps1..4, ba, bg, rho1..4)
NOISE_SIZE = 46           # 3*14 + 4*RHO_OPT_SIZE
FOCAL_LENGTH = 460.0      # virtual focal length used for pixel-unit thresholds

# Error-state slot offsets (reference: parameters.h:135-150).
ILO_P, ILO_R, ILO_V = 0, 3, 6
ILO_EPS = 9               # eps_j at ILO_EPS + 3*j
ILO_BA, ILO_BG = 21, 24
ILO_RHO = 27              # rho_j at ILO_RHO + RHO_OPT_SIZE*j

# Noise slot offsets (reference: parameters.h:152-172).
ILNO_AI, ILNO_GI, ILNO_AI1, ILNO_GI1 = 0, 3, 6, 9
ILNO_BA, ILNO_BG = 12, 15
ILNO_PHI, ILNO_PHI1, ILNO_DPHI, ILNO_DPHI1 = 18, 21, 24, 27
ILNO_V = 30               # leg-velocity noise for leg j at ILNO_V + 3*j
ILNO_NRHO = 42            # rho random walk for leg j at ILNO_NRHO + j

# Per-window capacity knobs (static shapes; reference caps features at
# NUM_OF_F=1000 but tracks max_cnt<=250 per frame).
MAX_FEATURES = 160        # feature slots carried by one window problem
FOOT_VAR_WINDOW_SIZE = 5  # foot-force variance window (imu_leg_integration_base.h:20)


@dataclass(frozen=True)
class RobotModel:
    """Leg geometry of a quadruped (reference: estimator.cpp:140-171).

    Leg order: 0-FL, 1-FR, 2-RL, 3-RR.
    """

    name: str = "a1"
    leg_offset_x: tuple = (0.1805, 0.1805, -0.1805, -0.1805)
    leg_offset_y: tuple = (0.047, -0.047, 0.047, -0.047)
    motor_offset: tuple = (0.0838, -0.0838, 0.0838, -0.0838)
    upper_leg_length: tuple = (0.21, 0.21, 0.21, 0.21)
    lower_leg_length: float = 0.21  # initial rho_opt (config key: lower_leg_length)
    # IMU frame (b) <- robot body frame (r) transform (estimator.cpp:139-142)
    p_br: tuple = (0.0, 0.0, 0.0)
    R_br: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))

    def rho_fix(self) -> np.ndarray:
        """(NUM_OF_LEG, RHO_FIX_SIZE) fixed kinematic params per leg."""
        return np.stack(
            [
                np.array([self.leg_offset_x[i], self.leg_offset_y[i],
                          self.motor_offset[i], self.upper_leg_length[i]])
                for i in range(NUM_OF_LEG)
            ]
        )

    def rho_init(self) -> np.ndarray:
        """(NUM_OF_LEG * RHO_OPT_SIZE,) initial optimized params (calf lengths)."""
        return np.full((TOTAL_RHO_OPT_SIZE,), self.lower_leg_length)


GO1 = RobotModel(name="go1", lower_leg_length=0.21)
A1 = RobotModel(name="a1", lower_leg_length=0.21)


@dataclass(frozen=True)
class NoiseConfig:
    """Sensor noise densities (reference YAML keys kept verbatim)."""

    acc_n: float = 0.9          # accelerometer white noise (x, y)
    acc_n_z: float = 2.5        # accelerometer white noise (z)
    gyr_n: float = 0.05         # gyro white noise
    acc_w: float = 0.0004       # accel bias random walk
    gyr_w: float = 0.0002       # gyro bias random walk
    joint_angle_n: float = 1e-5     # phi_n
    joint_velocity_n: float = 1e-5  # dphi_n
    leg_bias_c_n: float = 1e-8      # rho random walk (in contact)
    leg_bias_nc_n: float = 1e-11    # rho random walk (no contact)
    # contact / leg-odometry velocity noise model
    v_n_force_thres_ratio: float = 0.8
    v_n_min_xy: float = 0.001
    v_n_min_z: float = 0.005
    v_n_min: float = 0.005
    v_n_max: float = 900.0
    v_n_term1_steep: float = 10.0
    v_n_term2_var_rescale: float = 1e-6
    v_n_term3_distance_rescale: float = 1e-3
    # LO-consistency guard for binary contact models 0/1 (see
    # PreintParams.lo_guard): variance added per (v_leg - delta_v)^2; at
    # 0.1, a 1 m/s kinematic disagreement inflates a claimed-stance leg's
    # variance ~100x over v_n_min_xy. 0 restores exact reference
    # semantics (reference trusts binary flags blindly).
    contact_lo_guard_rescale: float = 0.1



@dataclass(frozen=True)
class EstimatorConfig:
    """The estimator settings the generator reads (reference:
    parameters.cpp:92-276): the robot, the noise densities, the contact
    model, gravity and the stereo camera's image size and extrinsics."""

    robot: RobotModel = A1
    noise: NoiseConfig = NoiseConfig()
    num_of_cam: int = 2
    contact_sensor_type: int = 0   # 0 EKF contacts | 1 plan contacts | 2 raw foot force
    g_norm: float = 9.805

    # camera intrinsics/extrinsics (body_T_cam of realsense on A1 by default)
    image_width: int = 640
    image_height: int = 480
    body_T_cam0: tuple = (
        (0.0, 0.0, 1.0, 0.10076),
        (-1.0, 0.0, 0.0, 0.025),
        (0.0, -1.0, 0.0, 0.1114),
        (0.0, 0.0, 0.0, 1.0),
    )
    body_T_cam1: tuple = (
        (0.0, 0.0, 1.0, 0.10076),
        (-1.0, 0.0, 0.0, -0.025),
        (0.0, -1.0, 0.0, 0.1114),
        (0.0, 0.0, 0.0, 1.0),
    )

    def ric_tic(self, n: int | None = None):
        """Returns ((n,3,3) R_imu_cam, (n,3) t_imu_cam); n defaults to
        num_of_cam."""
        Ts = [np.array(self.body_T_cam0), np.array(self.body_T_cam1)][: n or self.num_of_cam]
        ric = np.stack([T[:3, :3] for T in Ts])
        tic = np.stack([T[:3, 3] for T in Ts])
        return ric, tic
