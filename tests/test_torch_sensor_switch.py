"""The estimator's sensor swaps and its PnP recovery in the port against
the JAX package, f64 on the CPU, max_features = 48 and max_num_iterations
= 4, each run driven through the entry points (input_imu_leg,
input_image, change_sensor_type, via replay) with the inputs of
cerberus_tpu_torch.evals.robustness.branch_inputs:

  * mono_swap: stereo -> mono at 0.8 s of 1.6 s (seed 51; the JAX test
    `test_mono_swap_mid_run`'s swap, at its midpoint, after the
    initialization at 0.73 s);
  * imu_off_on: the IMU off at 0.67 s, on again at 1.0 s of 2.0 s (seed
    51): vision only, then a restart (reboots + 1, clear_state) and a new
    initialization;
  * vision_only: use_imu, leg odometry, extrinsic and td estimation off
    (`test_vision_only_mode_runs`'s config), 1.3 s (seed 52);
  * pnp_recovery: the +/-25 m/s^2 accelerometer square wave of
    `test_pnp_recovers_from_corrupted_dead_reckoning` for 0.4 s at 0.8 s
    of 1.6 s (seed 43), pnp_fallback on.

Held, each: the same frames published, equal counts (solves, keyframes,
reboots, dispatches, deferred, stalled and stale intervals), equal
failure_reasons and final sensor set and solver flag, positions within
1e-8 m (as test_torch_streaming.py's replay). No run here adopts a
placeholder step (estimator_runs.py), so every frame is held.
"""

import pytest
import torch

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.estimator.estimator import Estimator
from estimator_runs import assert_runs_match, branch_both

KW = dict(max_features=48, max_num_iterations=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_guard_rejects_no_sensors():
    """`test_sensor_switch.py::test_guard_rejects_no_sensors`: neither IMU
    nor stereo raises."""
    est = Estimator(EstimatorConfig(**KW), device="cpu")
    with pytest.raises(ValueError):
        est.change_sensor_type(False, False)


@pytest.mark.parametrize("name, duration", [
    ("mono_swap", 1.6), ("imu_off_on", 2.0), ("vision_only", 1.3),
    ("pnp_recovery", 1.6)])
def test_branch_follows_jax(name, duration):
    runs = branch_both(name, duration, KW)
    n, held = assert_runs_match(name, runs, hold_all=True)
    tout = runs["port"][0]
    est = tout["estimator"]
    assert n == held >= 5 and est.stats["solves"] > 0
    assert est.solver_flag == est.NON_LINEAR
    if name == "mono_swap":
        assert not est.cfg.stereo and est.stats["reboots"] == 0
    if name == "imu_off_on":
        assert est.cfg.use_imu and est.stats["reboots"] == 1
    if name == "vision_only":
        assert not est.cfg.use_imu
    if name == "pnp_recovery":
        assert est.stats["reboots"] == 0
