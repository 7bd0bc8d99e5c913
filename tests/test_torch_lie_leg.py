"""The port's utils/lie.py and kinematics/leg.py against the JAX package, f64
on the CPU, from numpy-seeded inputs. Tolerance 1e-12: the two evaluate the
same closed forms term for term, so only the last bits may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.kinematics import leg as jleg
from cerberus_tpu.utils import lie as jlie
from cerberus_tpu_torch.kinematics import leg as tleg
from cerberus_tpu_torch.utils import lie as tlie
from torch_port_util import assert_close

TOL = dict(rtol=1e-12, atol=1e-12)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rots(rng, n):
    return np.array(jlie.quat_to_rot(jnp.asarray(_unit_quats(rng, n))))


# name -> numpy input makers (all inputs share a leading batch of 7)
LIE_CASES = {
    "quat_mul": lambda r: (_unit_quats(r, 7), _unit_quats(r, 7)),
    "quat_conj": lambda r: (_unit_quats(r, 7),),
    "quat_normalize": lambda r: (r.normal(size=(7, 4)),),
    "quat_rotate": lambda r: (_unit_quats(r, 7), r.normal(size=(7, 3))),
    "quat_to_rot": lambda r: (_unit_quats(r, 7),),
    "rot_to_quat": lambda r: (_rots(r, 7),),
    "delta_q": lambda r: (r.normal(size=(7, 3)) * 0.1,),
    "so3_exp_quat": lambda r: (np.concatenate(
        [r.normal(size=(6, 3)), np.zeros((1, 3))]),),
    "quat_log": lambda r: (_unit_quats(r, 7),),
    "skew": lambda r: (r.normal(size=(7, 3)),),
    "quat_left": lambda r: (_unit_quats(r, 7),),
    "quat_right": lambda r: (_unit_quats(r, 7),),
    "rot_to_ypr": lambda r: (_rots(r, 7),),
    "ypr_to_rot": lambda r: (r.uniform(-180, 180, size=(7, 3)),),
    "g_to_rot": lambda r: (r.normal(size=(7, 3)) + np.array([0, 0, 9.8]),),
    "rot_x": lambda r: (r.uniform(-3, 3, size=(7,)),),
    "rot_y": lambda r: (r.uniform(-3, 3, size=(7,)),),
    "rot_z": lambda r: (r.uniform(-3, 3, size=(7,)),),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    args = LIE_CASES[name](np.random.default_rng(11))
    want = getattr(jlie, name)(*map(jnp.asarray, args))
    got = getattr(tlie, name)(*map(torch.as_tensor, args))
    assert_close(f"lie.{name}", got.numpy(), want, **TOL)


def test_quat_identity_and_cross():
    np.testing.assert_array_equal(tlie.quat_identity(device="cpu").numpy(),
                                  np.asarray(jlie.quat_identity()))
    rng = np.random.default_rng(12)
    a, b = rng.normal(size=(2, 5, 3))
    np.testing.assert_allclose(
        tlie.cross(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.cross(a, b), **TOL)


def _leg_inputs(seed, lead=(6,)):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(-1.5, 1.5, size=lead + (4, 3))
    rho = 0.21 + 0.01 * rng.normal(size=lead + (4, 1))
    from cerberus_tpu.config import A1
    return phi, rho, A1.rho_fix()


def test_leg_fk_matches_jax():
    phi, rho, rho_fix = _leg_inputs(21)
    want = jleg.leg_fk(jnp.asarray(phi), jnp.asarray(rho), jnp.asarray(rho_fix))
    got = tleg.leg_fk(torch.as_tensor(phi), torch.as_tensor(rho),
                      torch.as_tensor(rho_fix))
    assert_close("leg.leg_fk", got.numpy(), want, **TOL)


@pytest.mark.parametrize("key", ["fk", "J", "dfk_drho", "dJ_dq", "dJ_drho"])
@pytest.mark.parametrize("lead", [(), (6,), (2, 3)])
def test_all_legs_fk_jac_matches_jax(key, lead):
    phi, rho, rho_fix = _leg_inputs(22, lead)
    want = jleg.all_legs_fk_jac(jnp.asarray(phi), jnp.asarray(rho),
                                jnp.asarray(rho_fix))[key]
    got = tleg.all_legs_fk_jac(torch.as_tensor(phi), torch.as_tensor(rho),
                               torch.as_tensor(rho_fix))[key]
    assert tuple(got.shape) == tuple(want.shape)
    assert_close(f"leg.all_legs_fk_jac.{key}", got.numpy(), want, **TOL)


def test_single_leg_derivatives_match_jax():
    phi, rho, rho_fix = _leg_inputs(23, ())
    q, r, f = phi[1], rho[1], rho_fix[1]
    for name in ("leg_jac", "leg_dfk_drho", "leg_dJ_dq", "leg_dJ_drho"):
        want = getattr(jleg, name)(jnp.asarray(q), jnp.asarray(r),
                                   jnp.asarray(f))
        got = getattr(tleg, name)(torch.as_tensor(q), torch.as_tensor(r),
                                  torch.as_tensor(f))
        assert_close(f"leg.{name}", got.numpy(), want, **TOL)
