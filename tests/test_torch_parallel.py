"""The port's parallel/ modules and the dense linearization they need,
against the JAX package, f64 on the CPU.

Inputs: tests/test_fleet.py's fleet (2 segments x 2 perturbations, F = 48,
8 s simulations), solved for 4 LM iterations; tests/test_parallel.py's
window (5 s, seed 3, 200 landmarks, F = 48) with a common 4 mm calf-length
offset for the pooled calibration step.

Tolerances, and why:
  * build_fleet: 1e-10 relative — the window builder's (its tests hold it at
    1e-10), the perturbations drawn from the same numpy generator in the
    same order;
  * solve_fleet: cost rtol 1e-8, as tests/test_torch_solver.py holds the
    batched solve;
  * linearize and the pooled step's H, b, dx: 1e-10 relative — the port
    takes J_s as four forward-mode products along the summed rho
    directions where the JAX package sums the dense J's columns;
  * a two-chunk mesh of CPU devices against one chunk: 1e-12 (the same
    arithmetic on smaller batches).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.window_builder import build_window_from_sim
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops.solver import SolveOptions as jOpts
from cerberus_tpu.parallel import batched as jbatched
from cerberus_tpu.parallel import fleet as jfleet
from cerberus_tpu_torch import convert
from cerberus_tpu_torch.ops import factors as tfac
from cerberus_tpu_torch.ops.solver import SolveOptions as tOpts
from cerberus_tpu_torch.parallel import (batched_solve, make_mesh,
                                         pooled_calibration_step)
from cerberus_tpu_torch.parallel import fleet as tfleet
from torch_port_util import assert_rel, np_tree, to_port

FLEET = dict(n_segments=2, n_perturb=2, F=48, sim_duration=8.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleets():
    j = jfleet.build_fleet(**FLEET, dtype=jnp.float64)
    t = tfleet.build_fleet(**FLEET, dtype=torch.float64, device="cpu")
    return j, t


def test_build_fleet_leaves_equal(fleets):
    (js, jd, jt), (ts, td, tt) = fleets
    assert ts.p.shape == (4, 11, 3)
    for name, got, want in (("states", ts, js), ("datas", td, jd),
                            ("truths", tt, jt)):
        g, w = np_tree(got), np_tree(want)
        assert g.keys() == w.keys()
        worst = 0.0
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype.kind == \
                w[k].dtype.kind, k
            if w[k].dtype.kind == "f":
                scale = max(1.0, float(np.abs(w[k]).max()))
                np.testing.assert_allclose(g[k], w[k], rtol=1e-10,
                                           atol=1e-10 * scale, err_msg=k)
                worst = max(worst, float(np.abs(g[k] - w[k]).max()) / scale)
            else:
                assert np.array_equal(g[k], w[k]), k
        print(f"PORT_DIFF build_fleet.{name} (every leaf) "
              f"max_rel={worst:.3e}")
    # the perturbations are the JAX package's draws
    assert_rel("build_fleet.states.p - truths.p", ts.p - tt.p,
               np.asarray(js.p) - np.asarray(jt.p), 1e-10)


def test_solve_fleet_matches_jax(fleets):
    (js, jd, jt), (ts, td, tt) = fleets
    jres = jfleet.solve_fleet(js, jd, jt, None, jOpts(max_iters=4))
    tres = convert.fleet_result_to_numpy(
        tfleet.solve_fleet(ts, td, tt, None, tOpts(max_iters=4)))
    assert np.all(tres.cost < tres.cost0)
    assert_rel("solve_fleet.cost0", tres.cost0, np.asarray(jres.cost0), 1e-8)
    np.testing.assert_allclose(tres.cost, np.asarray(jres.cost), rtol=1e-8)
    assert_rel("solve_fleet.cost", tres.cost, np.asarray(jres.cost), 1e-8)
    assert_rel("solve_fleet.states.p", tres.states.p,
               np.asarray(jres.states.p), 1e-8)
    assert_rel("solve_fleet.traj_err", tres.traj_err,
               np.asarray(jres.traj_err), 1e-8)
    back = convert.fleet_result_from_numpy(tres, device="cpu",
                                           dtype=torch.float64)
    assert torch.equal(back.cost, torch.as_tensor(tres.cost))


@pytest.fixture(scope="module")
def problem():
    sim = simulate(SimConfig(duration=5.0, speed=0.5, seed=3,
                             n_landmarks=200))
    data, truth, _ = build_window_from_sim(sim, jConfig(), kf_stride=2,
                                           start_cam=2, F=48)
    B = 2
    perts = [truth._replace(rho=truth.rho + 0.004 * (1 + b),
                            p=truth.p + 0.01 * b) for b in range(B)]
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *perts)
    datas = jax.tree.map(lambda x: jnp.stack([x] * B), data)
    return states, datas, truth


def test_linearize_matches_jax(problem):
    states, datas, _ = problem
    one = lambda t: jax.tree.map(lambda x: x[1], t)
    jr, jJ, jr0 = jax.jit(jfac.linearize)(one(states), one(datas))
    st, dt = to_port(one(states), one(datas))
    tr, tJ, tr0 = tfac.linearize(st, dt)
    assert_rel("linearize.r", tr.numpy(), np.asarray(jr), 1e-10)
    assert_rel("linearize.J", tJ.numpy(), np.asarray(jJ), 1e-10)
    assert_rel("linearize.r0", tr0.numpy(), np.asarray(jr0), 1e-10)
    # J along the summed rho directions, as the pooled step takes it
    dirs = torch.zeros((tJ.shape[1], 4), dtype=torch.float64)
    for i in range(tfac.NF):
        dirs[tfac.RHO_OFF + 4 * i: tfac.RHO_OFF + 4 * i + 4] += torch.eye(4)
    r, Jd = tfac.linearize_directions(st, dt, dirs)
    assert torch.equal(r, tr)
    assert_rel("linearize_directions (rho)", Jd.numpy(), (tJ @ dirs).numpy(),
               1e-10)


def test_pooled_calibration_step_matches_jax(problem):
    states, datas, truth = problem
    jnew, jdx, jH, jb = jax.jit(jbatched.pooled_calibration_step)(states,
                                                                  datas)
    ts, td = to_port(states, datas)
    tnew, tdx, tH, tb = pooled_calibration_step(ts, td)
    assert_rel("pooled_calibration_step.H", tH.numpy(), np.asarray(jH), 1e-10)
    assert_rel("pooled_calibration_step.b", tb.numpy(), np.asarray(jb), 1e-10)
    assert_rel("pooled_calibration_step.dx", tdx.numpy(), np.asarray(jdx),
               1e-10)
    assert_rel("pooled_calibration_step.rho", tnew.rho.numpy(),
               np.asarray(jnew.rho), 1e-10)
    rho_t = np.asarray(truth.rho)[None]
    assert np.abs(tnew.rho.numpy() - rho_t).mean() < \
        np.abs(ts.rho.numpy() - rho_t).mean()


def test_two_chunk_mesh_equals_one_chunk(fleets, problem):
    _, (ts, td, _) = fleets
    mesh = make_mesh(2, device="cpu")
    assert len(mesh) == 2 and len(make_mesh(device="cpu")) == 1
    opts = tOpts(max_iters=2)
    s1, i1 = batched_solve(ts, td, None, opts)
    s2, i2 = batched_solve(ts, td, mesh, opts)
    assert_rel("batched_solve 2 chunks vs 1 .p", s2.p.numpy(), s1.p.numpy(),
               1e-12)
    assert_rel("batched_solve 2 chunks vs 1 .cost", i2.cost.numpy(),
               i1.cost.numpy(), 1e-12)
    ps, pd = to_port(*problem[:2])
    one = pooled_calibration_step(ps, pd)
    two = pooled_calibration_step(ps, pd, mesh)
    for name, a, b in zip(("rho", "dx", "H", "b"),
                          (two[0].rho, *two[1:]), (one[0].rho, *one[1:])):
        assert_rel(f"pooled_calibration_step 2 chunks vs 1 .{name}",
                   a.numpy(), b.numpy(), 1e-12)
