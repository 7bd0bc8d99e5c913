"""Port of the JAX package's `utils` modules."""
