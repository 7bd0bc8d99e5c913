"""Port of the JAX package's `ops` modules."""

from cerberus_tpu_torch.ops.preintegration import (  # noqa: F401
    ImuPreint, ILPreint, PreintParams,
    imu_preintegrate, il_preintegrate, il_preintegrate_parallel,
    il_residual, imu_residual,
)
