"""The port's profile drivers (`cerberus_tpu_torch/evals/profile_inloop.py`,
`profile_batched.py`, `profile_solver.py`, `profile_streaming.py`) against
the JAX package, f64 on the CPU.

The JAX drivers build their timed programs as closures inside `main`, so
each JAX computation is rebuilt here from the JAX package's own functions,
as the driver's lines (cited) write it, and the port's module-level piece
gets the same inputs. The problem is small: the 2 s simulated sequence
(seed 3; keyframes 2 camera frames apart) at F = 32, B = 2 windows, 3 LM
iterations. Tolerances: the variants' positions 1e-8 m and costs rtol
1e-8 (the port sums in another order than XLA in every iteration, and each
accept decision compares costs); the batch maker exact; every other stage
1e-8 relative to its largest entry. (tests/test_torch_nojax.py runs each
driver's pieces with JAX blocked.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jEstimatorConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops import marginalize as jmarg
from cerberus_tpu.ops import solver as jsolver
from cerberus_tpu.ops.preintegration import PreintParams as jPreintParams
from cerberus_tpu.ops.preintegration import il_preintegrate as jil_preintegrate
from cerberus_tpu.ops.structured import (
    build_normal_equations as jbuild_normal_equations,
    build_normal_equations_blocks as jbuild_blocks)
from cerberus_tpu_torch.evals import (measure, profile_batched,
                                      profile_inloop, profile_solver,
                                      profile_streaming)
from cerberus_tpu_torch.data.window_builder import (
    build_window_from_sim as tbuild)
from torch_port_util import assert_close, assert_rel, np_tree

B = 2
ITERS = 3
F = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small ops: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(tree, cls):
    """A port NamedTuple (CPU tensors) as the JAX package's `cls`."""
    return cls(**{k: to_jax(v, jfac.WindowState) if k == "prior_lin"
                  else jnp.asarray(v.numpy())
                  for k, v in tree._asdict().items()})


@pytest.fixture(scope="module")
def problem():
    """The JAX (data, truth) and the port's, f64: the port's window of the
    JAX package's simulated sequence (the same numbers in both types;
    tests/test_torch_window.py holds the two packages'
    `build_window_from_sim` together)."""
    sim = simulate(SimConfig(duration=2.0, speed=0.5, seed=3))
    tdata, tstate, _ = tbuild(sim, kf_stride=2, start_cam=2, F=F,
                              device="cpu")
    return ((to_jax(tdata, jfac.WindowData), to_jax(tstate, jfac.WindowState)),
            (tdata, tstate))


def jax_make_batch(data, truth, B):
    """JAX evals/profile_inloop.py:61-71 (and profile_batched.py:240-249)."""
    def perturb(i):
        r = np.random.default_rng(i)
        return truth._replace(
            p=truth.p + jnp.asarray(r.normal(size=(11, 3)) * 0.03),
            v=truth.v + jnp.asarray(r.normal(size=(11, 3)) * 0.05))
    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[perturb(i) for i in range(B)])
    datas = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape),
                         data)
    return states, datas


@pytest.fixture(scope="module")
def batch(problem):
    (data, truth), tproblem = problem
    return jax_make_batch(data, truth, B), measure.make_batch(tproblem, B)


def test_make_batch_is_the_jax_batch(batch):
    (states, datas), (tstates, tdatas) = batch
    for name, (got, want) in {"states": (tstates, states),
                              "datas": (tdatas, datas)}.items():
        g, w = np_tree(got), np_tree(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}.{k}")
    print("PORT_DIFF make_batch max_abs=0 (exact)")


def jax_assemble_once(s, d):
    """JAX evals/profile_batched.py:287-292 (profile_inloop.py:88-93);
    also the blocks' H_pp before the gauge projection (profile_streaming.py
    :180), so that one compiled program serves both."""
    H_pp, H_pd, h_dd, b_p, b_d, r0 = jbuild_blocks(s, d)
    H_raw = H_pp
    H_pp, H_pd, b_p = jsolver._project_gauge_blocks(H_pp, H_pd, b_p, s,
                                                    d.free_mask)
    return (H_pp, H_pd, h_dd, b_p, b_d, jfac.robust_cost(r0, s.depth.shape[0]),
            H_raw)


OPTS = jsolver.SolveOptions(max_iters=ITERS, function_tolerance=0.0)
# the JAX drivers' stages over a batch, jitted once and shared by the tests
J_ASSEMBLE = jax.jit(jax.vmap(jax_assemble_once))
J_SCHUR = jax.jit(jax.vmap(lambda *p: jsolver._damped_solve_schur(*p, OPTS)))
J_RETRACT = jax.jit(jax.vmap(jfac.retract))


def jax_variant(variant, states, datas):
    """JAX evals/profile_inloop.py:86-129 over the batch, ITERS iterations:
    the jitted stages above in a Python loop in place of the scan, the
    per-window selects of its vmap written out. Returns the states and
    costs instead of the sum of p[0, 0]."""
    def solve_step(pieces, lam):
        H_pp, H_pd, h_dd, b_p, b_d = pieces
        if variant == "no_chol":
            diag = jnp.diagonal(H_pp, axis1=1, axis2=2)
            dp = -b_p / jnp.maximum(diag, 1e-8) / (1 + lam[:, None])
            dd = -b_d / jnp.maximum(h_dd, 1e-8) / (1 + lam[:, None])
            return jnp.concatenate([dp, dd], axis=1)
        return J_SCHUR(H_pp, H_pd, h_dd, b_p, b_d, lam)

    def where(ok, a, b):
        return jnp.where(ok.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    *pieces, cost, _ = J_ASSEMBLE(states, datas)
    st, lam = states, jnp.full(cost.shape, OPTS.lam0)
    for _ in range(ITERS):
        dx = solve_step(pieces, lam)
        mx = jnp.max(jnp.abs(dx), axis=1, keepdims=True)
        dx = dx * jnp.minimum(1.0, OPTS.step_clip / jnp.maximum(mx, 1e-30))
        cand = J_RETRACT(st, dx)
        if variant == "asm_once":
            cand_pieces, new_cost = pieces, cost * 0.999
        else:
            *cand_pieces, new_cost, _ = J_ASSEMBLE(cand, datas)
        ok = new_cost < cost
        st = jax.tree.map(lambda a, b_: where(ok, a, b_), cand, st)
        pieces = [where(ok, a, b_) for a, b_ in zip(cand_pieces, pieces)]
        lam = jnp.where(ok, lam / 3.0, lam * 4.0)
        cost = jnp.where(ok, new_cost, cost)
    return st, cost


@pytest.mark.parametrize("variant", profile_inloop.VARIANTS)
def test_inloop_variant_matches_jax(batch, variant):
    (states, datas), (tstates, tdatas) = batch
    jst, jcost = jax_variant(variant, states, datas)
    st, cost = profile_inloop.variant_loop(variant, tstates, tdatas, ITERS)
    assert_close(f"profile_inloop {variant} p", st.p.numpy(), jst.p, 0, 1e-8)
    assert_close(f"profile_inloop {variant} cost", cost.numpy(), jcost,
                 1e-8, 0)
    want = float(jnp.sum(jst.p[:, 0, 0]))
    got = float(profile_inloop.make_solver(variant, ITERS)(tstates, tdatas))
    assert_close(f"profile_inloop {variant} timed value", got, want, 0, 1e-8)


def test_profile_batched_stages_match_jax(batch):
    """Each stage of JAX evals/profile_batched.py:286-314: the assembly's
    pieces and cost, the Schur solve on them at lam 1e-4, the retract."""
    (states, datas), (tstates, tdatas) = batch
    pieces = J_ASSEMBLE(states, datas)
    dx = J_SCHUR(*pieces[:5], jnp.full((B,), 1e-4))
    ret = J_RETRACT(states, dx)

    tpieces = profile_batched.assemble_once(tstates, tdatas)
    names = ("H_pp", "H_pd", "h_dd", "b_p", "b_d", "cost")
    for name, got, want in zip(names, tpieces, pieces):
        assert_rel(f"profile_batched assembly {name}", got.numpy(), want,
                   1e-8)
    tdx = profile_batched.schur_once(*tpieces[:5],
                                     torch.full((B,), 1e-4,
                                                dtype=torch.float64))
    assert_rel("profile_batched schur dx", tdx.numpy(), dx, 1e-8)
    tret = profile_batched.retract_once(tstates, torch.as_tensor(
        np.asarray(dx)))
    g, w = np_tree(tret), np_tree(ret)
    for k in w:
        assert_rel(f"profile_batched retract {k}", g[k], w[k], 1e-8)
    assert float(profile_batched.scalar_of(tret)) == pytest.approx(
        sum(float(np.sum(v)) for v in w.values()), rel=1e-12)


def test_profile_solver_programs_match_jax(problem):
    """The programs of JAX evals/profile_solver.py:57-80 on B copies of the
    truth: the dense assembly, its damped solve, the cost, the gauge QR (Q
    up to the sign of each column), and one dense-Jacobian iteration."""
    (data, truth), (tdata, ttruth) = problem
    bc = lambda t: jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), t)
    states, datas = bc(truth), bc(data)
    tstates, tdatas = measure.broadcast(ttruth, B), measure.broadcast(tdata, B)
    dim = jfac.tangent_dim(F)

    def gauge_fn(s):
        Q, _ = jnp.linalg.qr(jmarg._gauge_null_basis(s, dim))
        return Q

    H, b = jax.jit(jax.vmap(lambda s, d: jbuild_normal_equations(s, d)[:2]))(
        states, datas)
    assert_rel("profile_solver assembly H[0, 0]",
               profile_solver.assembly(tstates, tdatas).numpy(),
               H[:, 0, 0], 1e-8)
    # JAX evals/profile_solver.py:66-69 on the assembled (H, b)
    dx = jax.jit(jax.vmap(lambda H, b: jsolver._damped_solve(
        H, b, jnp.asarray(1e-4), jsolver.SolveOptions())))(H, b)
    assert_rel("profile_solver assembly+chol dx[0]",
               profile_solver.assembly_chol(tstates, tdatas).numpy(),
               dx[:, 0], 1e-8)
    cost = jax.jit(jax.vmap(lambda s, d: jfac.robust_cost(
        jfac.window_residuals(s, jnp.zeros(dim), d), F)))(states, datas)
    assert_rel("profile_solver cost",
               profile_solver.cost(tstates, tdatas).numpy(), cost, 1e-8)
    Q = np.asarray(jax.jit(jax.vmap(gauge_fn))(states))
    from cerberus_tpu_torch.ops.marginalize import _gauge_null_basis
    tQ = torch.linalg.qr(torch.func.vmap(
        lambda s: _gauge_null_basis(s, dim))(tstates)).Q.numpy()
    sign = np.sign(np.sum(tQ * Q, axis=1, keepdims=True))
    assert_rel("profile_solver gaugeQR Q (up to sign)", tQ * sign, Q, 1e-8)
    assert_rel("profile_solver gaugeQR Q[0, 0]",
               np.abs(profile_solver.gauge_qr(tstates, tdatas).numpy()),
               np.abs(Q[:, 0, 0]), 1e-8)
    # dense1 on perturbed windows, where the step is not roundoff
    (pstates, pdatas), (tpstates, tpdatas) = (
        jax_make_batch(data, truth, B), measure.make_batch((tdata, ttruth), B))
    p = jax.jit(jax.vmap(lambda s, d: jsolver.solve_window(
        s, d, jsolver.SolveOptions(max_iters=1, structured=False))[0].p[0, 0]
    ))(pstates, pdatas)
    assert_close("profile_solver dense1 p[0, 0]",
                 profile_solver.dense1(tpstates, tpdatas).numpy(), p, 0, 1e-8)


@pytest.fixture(scope="module")
def streaming_state(problem):
    (data, truth), (tdata, ttruth) = problem
    return ((data, truth._replace(p=truth.p + 0.02)),
            (tdata, ttruth._replace(p=ttruth.p + 0.02)))


def test_profile_streaming_programs_match_jax(streaming_state):
    """The programs of JAX evals/profile_streaming.py:166-194: the S = 48
    preintegration on its inputs, one structured assembly, solve_window at
    1 and 4 iterations (function_tolerance 0), and the marginalization of
    frame 0 (its prior in information form: the QR's row signs are
    arbitrary)."""
    (data, st), (tdata, tst) = streaming_state
    cfg = jEstimatorConfig()
    params = jPreintParams.from_config(cfg, jnp.float64)
    rng = np.random.default_rng(0)
    a = lambda *s: jnp.asarray(rng.normal(size=s) * 0.1, jnp.float64)
    S = profile_streaming.S
    pre_args = (jnp.full((S,), 0.002), a(S, 3) + jnp.array([0, 0, 9.8]),
                a(S, 3), a(S, 12), a(S, 12), jnp.ones((S, 4)),
                jnp.ones((S,), bool).at[0].set(False),
                jnp.zeros((3,)), jnp.zeros((3,)), jnp.full((4,), 0.21))
    tpre = profile_streaming.preint_inputs(torch.device("cpu"), torch.float64)
    for i, (got, want) in enumerate(zip(tpre, pre_args)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"preint input {i}")
    P = jax.jit(lambda *x: jil_preintegrate(*x, params).P)(*pre_args)
    from cerberus_tpu_torch.config import EstimatorConfig
    from cerberus_tpu_torch.ops.preintegration import PreintParams
    tparams = PreintParams.from_config(EstimatorConfig(), torch.float64,
                                       device="cpu")
    assert_rel("profile_streaming preint P",
               profile_streaming.preint(tparams)(*tpre).numpy(), P, 1e-8)

    pair = lambda t: jax.tree.map(lambda x: jnp.stack([x, x]), t)
    H_pp = J_ASSEMBLE(pair(st), pair(data))[-1][0]
    assert_rel("profile_streaming assembly H_pp",
               profile_streaming.assembly(tst, tdata).numpy(), H_pp, 1e-8)
    # one program for both budgets: the JAX loop's bound is traced
    jsolve = jax.jit(lambda s, it: jsolver.solve_window(
        s, data, jsolver.SolveOptions(max_iters=it,
                                      function_tolerance=0.0))[0].p)
    for it in (1, 4):
        assert_close(f"profile_streaming solve_{it}it p",
                     profile_streaming.solve(it)(tst, tdata).numpy(),
                     jsolve(st, jnp.asarray(it)), 0, 1e-8)
    J, r, _ = jax.jit(lambda s: jmarg.marginalize_old(s, data))(st)
    tJ, tr, _ = profile_streaming.marg.marginalize_old(tst, tdata)
    assert_rel("profile_streaming marg_old J^T J", (tJ.T @ tJ).numpy(),
               np.asarray(J.T @ J), 1e-8)
    assert_rel("profile_streaming marg_old J^T r", (tJ.T @ tr).numpy(),
               np.asarray(J.T @ r), 1e-8)
    assert_rel("profile_streaming marg_old (timed)",
               (profile_streaming.marg_old(tst, tdata).T @ tr).numpy(),
               np.asarray(J.T @ r), 1e-8)
