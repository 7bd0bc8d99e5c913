"""Port of the JAX package's `kinematics` modules."""

from cerberus_tpu_torch.kinematics.leg import (  # noqa: F401
    leg_fk, leg_jac, leg_dfk_drho, leg_dJ_dq, leg_dJ_drho, all_legs_fk_jac,
)
