"""The port's own copies of config.py and data/simulator.py, and its
ops/preintegration.py, against the JAX package on the CPU in f64.

The simulator copy must give exactly the same arrays from the same seed
(both are NumPy code). Preintegration runs ~100 midpoint steps in another
order of summation (eager torch ops against XLA's fused scan), so it is held
to 1e-10, relative to each array's scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu import config as jC
from cerberus_tpu.data.simulator import SimConfig as jSimConfig
from cerberus_tpu.data.simulator import simulate as jsimulate
from cerberus_tpu.ops import preintegration as jpre
from cerberus_tpu_torch import config as tC
from cerberus_tpu_torch.data.simulator import SimConfig as tSimConfig
from cerberus_tpu_torch.data.simulator import simulate as tsimulate
from cerberus_tpu_torch.ops import preintegration as tpre
from torch_port_util import assert_rel


def test_config_copy_matches():
    for name in ("WINDOW_SIZE", "NUM_FRAMES", "NUM_OF_LEG", "RHO_OPT_SIZE",
                 "RESIDUAL_STATE_SIZE", "NOISE_SIZE", "FOCAL_LENGTH",
                 "ILO_EPS", "ILO_BA", "ILO_BG", "ILO_RHO", "ILNO_V",
                 "ILNO_NRHO", "MAX_FEATURES", "FOOT_VAR_WINDOW_SIZE"):
        assert getattr(tC, name) == getattr(jC, name), name
    tcfg, jcfg = tC.EstimatorConfig(), jC.EstimatorConfig()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for a, b in zip(tcfg.ric_tic(), jcfg.ric_tic()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcfg.robot.rho_fix(), jcfg.robot.rho_fix())


@pytest.mark.parametrize("path", ["arc", "figure8"])
def test_simulate_copy_is_exact(path):
    kw = dict(duration=1.5, speed=0.5, seed=5, path=path, n_landmarks=120)
    t = tsimulate(tSimConfig(**kw))
    j = jsimulate(jSimConfig(**kw))
    assert set(t) == set(j)
    for key in t:
        if key in ("features", "sim_cfg"):
            continue
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert len(t["features"]) == len(j["features"])
    for ft, fj in zip(t["features"], j["features"]):
        assert ft.keys() == fj.keys()
        for lid in ft:
            for a, b in zip(ft[lid], fj[lid]):
                if a is None or b is None:
                    assert a is None and b is None
                else:
                    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def interval():
    """One simulated keyframe interval (samples 300..400 at 500 Hz)."""
    sim = jsimulate(jSimConfig(duration=1.0, speed=0.5, seed=3,
                               n_landmarks=50))
    sl = slice(300, 401)
    n = 101
    mask = np.ones(n, bool)
    mask[0] = False
    mask[-7:] = False          # padded tail: the carry passes through
    return dict(dt=np.full(n, 1.0 / 500.0), acc=sim["acc"][sl],
                gyr=sim["gyr"][sl], phi=sim["phi"][sl], dphi=sim["dphi"][sl],
                contacts=sim["contacts"][sl], forces=sim["foot_forces"][sl],
                mask=mask, ba=np.array([0.01, -0.02, 0.03]),
                bg=np.array([0.001, 0.0, -0.002]), rho=np.full(4, 0.212))


def _run_both(iv, contact_type):
    c = iv["contacts"] if contact_type in (0, 1) else iv["forces"]
    jcfg = jC.EstimatorConfig(contact_sensor_type=contact_type)
    tcfg = tC.EstimatorConfig(contact_sensor_type=contact_type)
    args = (iv["dt"], iv["acc"], iv["gyr"], iv["phi"], iv["dphi"], c)
    jout = jpre.il_preintegrate(
        *map(jnp.asarray, args), jnp.asarray(iv["mask"]),
        jnp.asarray(iv["ba"]), jnp.asarray(iv["bg"]), jnp.asarray(iv["rho"]),
        jpre.PreintParams.from_config(jcfg))
    tout = tpre.il_preintegrate(
        *map(torch.as_tensor, args), torch.as_tensor(iv["mask"]),
        torch.as_tensor(iv["ba"]), torch.as_tensor(iv["bg"]),
        torch.as_tensor(iv["rho"]),
        tpre.PreintParams.from_config(tcfg, torch.float64, device="cpu"))
    return tout, jout


@pytest.mark.parametrize("contact_type", [0, 2])
def test_il_preintegrate_matches_jax(interval, contact_type):
    tout, jout = _run_both(interval, contact_type)
    assert tout._fields == jout._fields
    for name, a, b in zip(tout._fields, tout, jout):
        assert_rel(f"preintegration.il_preintegrate[{contact_type}].{name}",
                   a.numpy(), b, 1e-10)


def test_il_step_full_matches_jax(interval):
    """One step's carry, F (31x31), V (31x46) and noise diagonal."""
    iv = interval
    k = 40
    jparams = jpre.PreintParams.from_config(jC.EstimatorConfig())
    tparams = tpre.PreintParams.from_config(tC.EstimatorConfig(),
                                            torch.float64, device="cpu")
    carry_args = (iv["acc"][k - 1], iv["gyr"][k - 1], iv["phi"][k - 1],
                  iv["dphi"][k - 1], iv["contacts"][k - 1])
    inp = (iv["dt"][k], iv["acc"][k], iv["gyr"][k], iv["phi"][k],
           iv["dphi"][k], iv["contacts"][k], True)
    lin = (iv["ba"], iv["bg"], iv["rho"])
    jres = jpre.il_step_full(jpre.il_init_carry(*map(jnp.asarray, carry_args)),
                             tuple(map(jnp.asarray, inp)),
                             *map(jnp.asarray, lin), jparams)
    tres = tpre.il_step_full(
        tpre.il_init_carry(*map(torch.as_tensor, carry_args)),
        tuple(map(torch.as_tensor, inp)), *map(torch.as_tensor, lin), tparams)
    for name, a, b in zip(tres[0]._fields, tres[0], jres[0]):
        assert_rel(f"preintegration.il_step_full.{name}", a.numpy(), b, 1e-10)
    for name, a, b in zip(("F", "V", "noise"), tres[1:], jres[1:]):
        assert_rel(f"preintegration.il_step_full.{name}", a.numpy(), b, 1e-10)
