"""Port of the JAX package's `parallel` modules: batched and pooled window
solves over a list of devices, and the fleet benchmark's problems."""

from cerberus_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
from cerberus_tpu_torch.parallel.batched import (  # noqa: F401
    batched_solve, pooled_calibration_step,
)
