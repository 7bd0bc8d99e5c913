"""Port of the JAX package's `loop` modules: the 4-DoF pose graph, the
place-recognition descriptors and the loop closer."""

from cerberus_tpu_torch.loop.posegraph import PoseGraph, optimize_pose_graph  # noqa: F401
