"""Port of the JAX package's `estimator` modules."""
