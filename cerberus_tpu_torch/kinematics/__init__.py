"""Port of the JAX package's `kinematics` modules."""
