"""The port's legged EKF (frontend/ekf.py) and moving-window filter
(utils/filters.py) against the JAX package, f64 on the CPU.

Inputs: SimConfig(duration=1.0, speed=0.5, seed=12) — the sequence of
tests/test_ekf.py::test_ekf_contact_estimation — and, for single steps, the
JAX filter's state after 200 of its samples carried to the port
(convert.ekf_state_from_numpy) with inputs made from a numpy seed.

Tolerances, and why:
  * MovingWindowFilter: exact (the same NumPy code);
  * moving_average_batch: 1e-12 relative (cumulative sums in another order);
  * ekf_step and 400 steps of LeggedEKF: state and P within 1e-10 relative
    — the same formulas, with 27x27 products and 28x28 solves that sum in
    another order; the contacts' hard decision (> 0.5) exactly equal.
"""

import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.frontend import ekf as jekf
from cerberus_tpu.utils import filters as jfilters
from cerberus_tpu_torch import convert
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.frontend import ekf as tekf
from cerberus_tpu_torch.utils import filters as tfilters
from torch_port_util import assert_rel, np_tree

TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Hundreds of tiny ops per step: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    return simulate(SimConfig(duration=1.0, speed=0.5, seed=12))


def _feed(ekf, sim, k):
    ekf.update_filter(sim["t"][k], sim["acc"][k], sim["gyr"][k],
                      sim["phi"][k], dphi=sim["dphi"][k],
                      foot_force=sim["foot_forces"][k])


def _state_np(state):
    return {k: np.asarray(v) for k, v in np_tree(state).items()}


def test_moving_window_filter_exact():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(40, 3)) * 10.0 ** rng.integers(-3, 4, size=(40, 1))
    for window in (1, 4, 7):
        j, t = jfilters.MovingWindowFilter(window, 3), \
            tfilters.MovingWindowFilter(window, 3)
        for x in xs:
            np.testing.assert_array_equal(t.update(x), j.update(x))
        np.testing.assert_array_equal(t.average, j.average)
    with pytest.raises(ValueError):
        tfilters.MovingWindowFilter(0)
    x = rng.normal(size=(30, 2, 3))
    for window in (1, 5, 40):
        assert_rel(f"moving_average_batch[{window}]",
                   tfilters.moving_average_batch(torch.tensor(x),
                                                 window).numpy(),
                   np.asarray(jfilters.moving_average_batch(x, window)),
                   1e-12)


@pytest.fixture(scope="module")
def jax_mid_state(sim):
    """The JAX filter's state after 200 samples of the sequence."""
    ekf = jekf.LeggedEKF(jConfig(), filter_window=4)
    ekf.init_filter(sim["t"][0], sim["acc"][0], sim["gyr"][0], sim["phi"][0])
    for k in range(1, 200):
        _feed(ekf, sim, k)
    return ekf.state


def _step_inputs(sim, case):
    """One sample's inputs: stance (the simulated sample), a leg in swing
    (its force dropped), or a slipping leg (force high, its joint speeds
    x25, so its velocity innovation fails the chi^2 gate)."""
    k = 200
    ff = np.array(sim["foot_forces"][k], float)
    dphi = np.array(sim["dphi"][k], float).reshape(4, 3)
    if case == "swing":
        ff[1] = 0.0
    if case == "slip":
        leg = int(np.argmax(ff))
        dphi[leg] *= 25.0
    return dict(dt=0.002, acc=np.array(sim["acc"][k], float),
                gyr=np.array(sim["gyr"][k], float),
                phi=np.array(sim["phi"][k], float), dphi=dphi.reshape(-1),
                foot_force=ff)


@pytest.mark.parametrize("case", ["stance", "swing", "slip"])
def test_ekf_step(sim, jax_mid_state, case):
    import jax.numpy as jnp

    x = _step_inputs(sim, case)
    jp = jekf.EKFParams.from_config(jConfig())
    want = jekf.ekf_step(jax_mid_state, *(jnp.asarray(x[k]) for k in x), jp)
    tp = tekf.EKFParams.from_config(tConfig(), device="cpu")
    s0 = convert.ekf_state_from_numpy(
        type(jax_mid_state)(*(np.asarray(v) for v in jax_mid_state)),
        device="cpu")
    args = [torch.tensor(x[k], dtype=torch.float64) for k in x]
    got = tekf.ekf_step(s0, *args, tp)
    g, w = _state_np(convert.ekf_state_to_numpy(got)), _state_np(want)
    assert g.keys() == w.keys()
    for k in g:
        if w[k].dtype.kind in "iu":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert_rel(f"ekf_step[{case}].{k}", g[k], w[k], TOL)
    np.testing.assert_array_equal(g["contacts"] > 0.5, w["contacts"] > 0.5)
    # the slip case goes through the gate: without it the update differs
    ungated = tekf.ekf_step(s0, *args, tp._replace(
        slip_gate_chi2=torch.zeros((), dtype=torch.float64)))
    moved = float((ungated.v - got.v).abs().max())
    print(f"PORT_DIFF ekf_step[{case}] gate moves v by {moved:.3e}")
    assert (moved > 1e-6) == (case == "slip"), moved


def test_legged_ekf_400_steps(sim):
    """tests/test_ekf.py::test_ekf_contact_estimation on both packages:
    states, P and contact decisions agree at every step, and the port's
    contacts pass that test's gate."""
    j = jekf.LeggedEKF(jConfig(), filter_window=4)
    t = tekf.LeggedEKF(tConfig(), filter_window=4, device="cpu")
    for e in (j, t):
        e.init_filter(sim["t"][0], sim["acc"][0], sim["gyr"][0], sim["phi"][0])
    assert_rel("LeggedEKF.init P", t.state.P.numpy(), np.asarray(j.state.P),
               TOL)
    worst, hits, total = 0.0, 0, 0
    for k in range(1, 400):
        _feed(j, sim, k)
        _feed(t, sim, k)
        gs, ws = t.get_state(), j.get_state()
        worst = max(worst, float(np.abs(gs - ws).max() / np.abs(ws).max()))
        c = t.get_contacts()
        np.testing.assert_array_equal(c > 0.5, j.get_contacts() > 0.5,
                                      err_msg=f"step {k}")
        hits += np.sum((c > 0.5) == (sim["contacts"][k] > 0.5))
        total += 4
    print(f"PORT_DIFF LeggedEKF per-step state worst max_rel={worst:.3e}")
    assert worst < TOL
    g = _state_np(convert.ekf_state_to_numpy(t.state))
    w = _state_np(j.state)
    for k in g:
        if w[k].dtype.kind not in "iu":
            assert_rel(f"LeggedEKF[399].{k}", g[k], w[k], TOL)
    assert hits / total > 0.85, hits / total


def test_ekf_state_round_trip():
    s = tekf.ekf_init(torch.zeros(3, dtype=torch.float64),
                      torch.tensor([1.0, 0, 0, 0], dtype=torch.float64),
                      torch.zeros(12, dtype=torch.float64),
                      tekf.EKFParams.from_config(tConfig(), device="cpu"))
    back = convert.ekf_state_from_numpy(convert.ekf_state_to_numpy(s),
                                        device="cpu")
    for a, b in zip(back, s):
        assert a.dtype == b.dtype and torch.equal(a, b)
