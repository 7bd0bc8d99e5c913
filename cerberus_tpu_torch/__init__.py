"""cerberus_tpu_torch — the PyTorch/CUDA port of cerberus_tpu.

A second package beside the JAX one, with the same module paths: the
sliding-window VILO problem (IMU+leg preintegration, stereo projection
factors, structured Gauss-Newton assembly), its batched Levenberg-Marquardt
solve and the per-frame streaming estimator (`estimator/estimator.py`,
`data/replay.py`), the image front-end and legged EKF (`frontend/`), the
loop-closure back-end (`loop/`), the initial SfM and the batched, pooled
(also across processes) and fleet solves (`parallel/`), on torch tensors;
and the runtime around them: logged data (`data/rosbag.py`,
`data/log_adapter.py`), the replay command line
(`python -m cerberus_tpu_torch.data.replay`), the C++ sensor sync and CSV
writer (`native.py`, built with g++), metrics, checkpoints, profiling and
plots (`utils/`). The solve's dense
Cholesky step is a hand-written CUDA kernel for Hopper
(`csrc/lane_cholesky.cu`, f32 and f64),
as is the damped Cholesky solve of `ops/cholesky_solve.py`
(`csrc/cholesky_solve.cu`); both are built with `nvcc` on first use and
loaded with `ctypes` (`_build.py`).

The port imports neither JAX nor anything of `cerberus_tpu`. Entry points
that make tensors put them on the card unless the caller names another
device.
"""

__version__ = "0.1.0"

from cerberus_tpu_torch.config import EstimatorConfig, NoiseConfig, RobotModel  # noqa: E402,F401
