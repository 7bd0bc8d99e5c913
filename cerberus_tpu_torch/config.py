"""Configuration system (the port's own copy; it imports nothing of the JAX
package).

Mirrors the reference's YAML key set (reference: src/utils/parameters.{h,cpp},
config/a1_config/hardware_a1_vilo_config.yaml) as typed dataclasses instead of
~50 mutable globals. Sizes (window length, leg counts, state dims) are module
constants because they fix the shapes of every tensor of the window problem.
"""

from __future__ import annotations

import dataclasses
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
    # legged-EKF noise (the reference's kalmanFilter submodule is not
    # vendored, so these keys are this framework's own; defaults tuned on the
    # simulator — loadable from YAML like every other noise key)
    ekf_acc_n: float = 0.05
    ekf_gyr_n: float = 0.005
    ekf_foot_walk_contact: float = 1e-4
    ekf_foot_walk_swing: float = 10.0
    ekf_meas_fk_n: float = 1e-3
    ekf_meas_vel_n: float = 5e-2
    ekf_meas_height_n: float = 1e-2
    ekf_contact_force_thresh: float = 30.0
    # IMU bias random walks (the EKF estimates ba/bg online; without bias
    # states unmodeled gyro bias integrates into unbounded yaw drift —
    # measured 2.0% EKF-only drift at 60 s vs 0.5% with bias states)
    ekf_acc_bias_walk: float = 2e-3
    ekf_gyr_bias_walk: float = 2e-4
    # innovation-gated slip rejection: a leg whose whitened velocity
    # innovation exceeds this chi^2_3 value gets its measurements inflated
    # proportionally (one-step M-estimator); 0 disables
    ekf_slip_gate_chi2: float = 11.34
    # stance measurement-noise inflation per unit of normalized
    # short-window force variance (slipping/transient stance phases carry
    # high force variance); 0 disables. Default off: on the slip-realistic
    # config-1 sweep it consistently measured WORSE (1.18 vs 1.04 % drift
    # at rescale 25 — gait-periodic force variance de-weights healthy
    # stance too); kept for force sensors whose variance actually
    # discriminates slip
    ekf_force_var_rescale: float = 0.0


@dataclass(frozen=True)
class EstimatorConfig:
    """Full estimator configuration (reference: parameters.cpp:92-276)."""

    robot: RobotModel = A1
    noise: NoiseConfig = NoiseConfig()

    use_imu: bool = True
    use_leg_odom: bool = True
    optimize_leg_bias: bool = True
    stereo: bool = True
    num_of_cam: int = 2
    contact_sensor_type: int = 0   # 0 EKF contacts | 1 plan contacts | 2 raw foot force

    estimate_extrinsic: bool = True
    estimate_td: bool = False
    # PnP pose recovery when vision strongly disagrees with dead-reckoning
    # (reference only runs PnP in NON_LINEAR when !USE_IMU,
    # estimator.cpp:806-808; the recovery gate is this framework's addition)
    pnp_fallback: bool = True
    # drop the inertial factor of an interval whose IMU samples contain a
    # long bitwise-identical run (hung driver); False restores exact
    # reference semantics (the reference integrates the hang)
    stale_imu_guard: bool = True
    # keep camera-IMU time-offset information in the marginalization prior.
    # The reference does (td is a parameter block of every marginalized
    # projection factor) — but that anchors td at its early estimate: with a
    # 10 ms injected offset the estimate stalls at ~1/3 of the truth
    # (measured), because every marginalization re-pins the stale value.
    # Default False: td information lives only in the active window (plus
    # the standing calib prior), which converges to ~90% of an injected
    # offset within 8 s. Set True for reference-faithful behavior.
    marg_td_info: bool = False
    # initial camera-IMU time offset (image clock + td = IMU clock). Neutral
    # 0.0 default: intervals are drained to t + td (the exposure instant
    # under the running estimate), so a nonzero td asserts a REAL offset in
    # the data. The reference's hardware YAMLs set 0.0024 (a1/go1 yaml:99)
    # and load_yaml picks that up; synthetic zero-offset data must not.
    td: float = 0.0
    g_norm: float = 9.805

    # standing weak prior bounding the wander of the weakly-observable
    # calibration states (extrinsics/td) along near-null directions; excluded
    # from marginalization so its information never accumulates
    # (ops/factors.WindowData.calib_*). 0 disables.
    ex_prior_sigma_t: float = 0.05      # m
    ex_prior_sigma_r: float = 0.035     # rad (~2 deg)
    td_prior_sigma: float = 0.02        # s

    # solver budget (reference: yaml max_solver_time/max_num_iterations)
    max_solver_time: float = 0.1
    max_num_iterations: int = 12

    # keyframe selection
    keyframe_parallax: float = 10.0   # pixels; MIN_PARALLAX = this / FOCAL_LENGTH

    # feature tracker knobs
    max_cnt: int = 120
    min_dist: int = 10
    f_threshold: float = 1.0
    flow_back: bool = True

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

    # static capacity knobs of the window problem
    max_imu_per_interval: int = 48   # 500 Hz / ~12.5 Hz keyframes, padded
    max_features: int = MAX_FEATURES

    # compute dtype for the estimation core ("float32" | "float64")
    dtype: str = "float64"

    init_depth: float = 5.0
    min_parallax: float = dataclasses.field(init=False, default=0.0)

    def __post_init__(self):
        object.__setattr__(self, "min_parallax",
                           self.keyframe_parallax / FOCAL_LENGTH)

    @property
    def gravity(self) -> np.ndarray:
        return np.array([0.0, 0.0, self.g_norm])

    def ric_tic(self, n: int | None = None):
        """Returns ((n,3,3) R_imu_cam, (n,3) t_imu_cam); n defaults to
        num_of_cam. The estimator packs n=2 regardless of mode (static
        shapes; mono masks the cam-1 residuals instead of shrinking)."""
        Ts = [np.array(self.body_T_cam0), np.array(self.body_T_cam1)][: n or self.num_of_cam]
        ric = np.stack([T[:3, :3] for T in Ts])
        tic = np.stack([T[:3, 3] for T in Ts])
        return ric, tic

    def replace(self, **kw) -> "EstimatorConfig":
        return dataclasses.replace(self, **kw)
