"""Port of the JAX package's `data` modules."""

from cerberus_tpu_torch.data.simulator import SimConfig, simulate  # noqa: F401
