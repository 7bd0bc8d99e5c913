"""The port's window solve against the JAX package: the slice as a whole.

The problem is tests/test_lane_cholesky.py's batched one (6 s, seed 3,
F = 160, B = 4 windows perturbed from numpy seeds 0..3, max_iters = 6), f64
on the CPU, where the port's reduced solve runs the lane-Cholesky plain
version. Tolerances are test_lane_cholesky.py's for the same comparison
(cost rtol 1e-9 there, 1e-8 here; p rtol 1e-7 / atol 1e-9): the port sums
in another order than XLA in every iteration, and each LM accept decision
compares costs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jEstimatorConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.window_builder import build_window_from_sim as jbuild
from cerberus_tpu.ops import solver as jsolver
from cerberus_tpu.utils import lie as jlie
from cerberus_tpu_torch.ops import factors as tfac
from cerberus_tpu_torch.ops import lane_cholesky as tlc
from cerberus_tpu_torch.ops import solver as tsolver
from cerberus_tpu_torch.utils import lie as tlie
from torch_port_util import assert_close, to_port

B = 4
ITERS = 6


@pytest.fixture(scope="module")
def batch():
    """JAX (states, datas) and the port's, both with a leading axis B."""
    sim = simulate(SimConfig(duration=6.0, speed=0.5, seed=3))
    data, truth, _ = jbuild(sim, jEstimatorConfig(dtype="float64"),
                            dtype=jnp.float64)

    def perturb(i):
        r = np.random.default_rng(i)
        return truth._replace(
            p=truth.p + jnp.asarray(r.normal(size=(11, 3)) * 0.02),
            v=truth.v + jnp.asarray(r.normal(size=(11, 3)) * 0.04))

    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[perturb(i) for i in range(B)])
    datas = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape),
                         data)
    tstates, tdatas = to_port(states, datas)
    return states, datas, tstates, tdatas


@pytest.fixture(scope="module")
def jax_results(batch):
    states, datas, _, _ = batch
    opts = jsolver.SolveOptions(max_iters=ITERS)
    single = jax.jit(jax.vmap(
        lambda s, d: jsolver.solve_window(s, d, opts)))(states, datas)
    batched = jax.jit(lambda s, d: jsolver.solve_window_batched(
        s, d, opts, lane_chol=False))(states, datas)
    return single, batched


def _check(name, got, want):
    st, info = got
    jst, jinfo = want
    assert_close(f"{name}.cost", info.cost.numpy(), jinfo.cost, 1e-8, 0)
    assert_close(f"{name}.cost0", info.cost0.numpy(), jinfo.cost0, 1e-8, 0)
    np.testing.assert_array_equal(info.accepted.numpy(),
                                  np.asarray(jinfo.accepted))
    assert_close(f"{name}.p", st.p.numpy(), jst.p, 1e-7, 1e-9)
    assert_close(f"{name}.q", st.q.numpy(), jst.q, 1e-7, 1e-9)
    assert_close(f"{name}.ba", st.ba.numpy(), jst.ba, 0, 1e-9)


def test_solve_window_batched_matches_jax(batch, jax_results):
    _, _, tstates, tdatas = batch
    tlc.LAUNCHES = 0
    got = tsolver.solve_window_batched(
        tstates, tdatas, tsolver.SolveOptions(max_iters=ITERS))
    assert tlc.LAUNCHES == 0      # CPU tensors: the plain version, no kernel
    _check("solver.solve_window_batched", got, jax_results[1])
    info = got[1]
    assert np.all(info.cost.numpy() < info.cost0.numpy())


@pytest.mark.parametrize("i", range(B))
def test_solve_window_matches_jax(batch, jax_results, i):
    _, _, tstates, tdatas = batch
    pick = lambda x: x[i]
    st, info = tsolver.solve_window(tfac.map_tensors(pick, tstates),
                                    tfac.map_tensors(pick, tdatas),
                                    tsolver.SolveOptions(max_iters=ITERS))
    jst, jinfo = jax_results[0]
    one = lambda x: x[None]
    _check("solver.solve_window", (tfac.map_tensors(one, st), tsolver.SolveInfo(*map(one, info))),
           (jax.tree.map(lambda x: x[i:i + 1], jst),
            jax.tree.map(lambda x: x[i:i + 1], jinfo)))


def test_damped_solve_schur_matches_jax():
    """A block system of the solver's shape: dense pose block, pose-depth
    coupling, diagonal depth block (what the structured assembly makes)."""
    rng = np.random.default_rng(3)
    D, F = 30, 12
    J = rng.normal(size=(D + 5, D))
    H_pp = J.T @ J
    H_pd = 0.3 * rng.normal(size=(D, F))
    h_dd = 5.0 + rng.uniform(size=F)
    b_p, b_d = rng.normal(size=D), rng.normal(size=F)
    lam = 1e-3
    want = jsolver._damped_solve_schur(
        *map(jnp.asarray, (H_pp, H_pd, h_dd, b_p, b_d)), lam,
        jsolver.SolveOptions())
    got = tsolver._damped_solve_schur(
        *(torch.as_tensor(x)[None] for x in (H_pp, H_pd, h_dd, b_p, b_d)),
        torch.tensor([lam], dtype=torch.float64), tsolver.SolveOptions())
    assert np.isfinite(np.asarray(want)).all()
    assert_close("solver._damped_solve_schur", got[0].numpy(), want, 1e-9,
                 1e-12)


@pytest.mark.parametrize("pitch", [10.0, 89.7])
def test_reanchor_matches_jax(batch, pitch):
    """Both rotation paths of reanchor: yaw-only, and the fallback near the
    Euler singularity (pitch within 1 degree of 90)."""
    states, _, tstates, _ = batch
    old = jax.tree.map(lambda x: x[0], states)
    rng = np.random.default_rng(4)
    q0 = np.asarray(jlie.rot_to_quat(jlie.ypr_to_rot(
        jnp.asarray([30.0, pitch, -5.0]))))
    q_new = np.asarray(old.q).copy()
    q_new[0] = q0
    new = old._replace(q=jnp.asarray(q_new),
                       p=old.p + jnp.asarray(rng.normal(size=(11, 3))),
                       v=old.v + 0.1)
    old = old._replace(q=old.q.at[0].set(jlie.rot_to_quat(
        jlie.ypr_to_rot(jnp.asarray([-20.0, pitch + 0.1, 3.0])))))
    want = jsolver.reanchor(old, new)
    as_t = lambda nt: tfac.WindowState(*(torch.tensor(np.asarray(x))
                                         for x in nt))
    got = tsolver.reanchor(as_t(old), as_t(new))
    for name in ("p", "q", "v"):
        assert_close(f"solver.reanchor[pitch={pitch}].{name}",
                     getattr(got, name).numpy(), getattr(want, name),
                     1e-10, 1e-10)
    yaw_new = tlie.rot_to_ypr(tlie.quat_to_rot(got.q[0]))[0]
    yaw_old = tlie.rot_to_ypr(tlie.quat_to_rot(as_t(old).q[0]))[0]
    if pitch < 80:
        assert abs(float(yaw_new - yaw_old)) < 1e-9
