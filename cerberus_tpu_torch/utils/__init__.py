"""Port of the JAX package's `utils` modules."""

from cerberus_tpu_torch.utils import lie  # noqa: F401
