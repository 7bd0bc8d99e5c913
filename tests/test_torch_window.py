"""The port's window builder, factors, gauge basis and structured assembly
against the JAX package, f64 on the CPU.

The window is test_structured.py's (5 s, seed 3, F = 40). Module-level
comparisons use the JAX package's window carried over as numpy arrays, so
both sides see the same inputs; a marginalization prior and the standing
calibration prior are switched on so their rows are compared too.
Tolerances: 1e-10 relative to scale for residuals, retraction and the built
window (another order of summation over ~100 preintegration steps);
build_normal_equations_blocks at tests/test_structured.py's H/b/r0
tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jEstimatorConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.window_builder import build_window_from_sim as jbuild
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops import marginalize as jmarg
from cerberus_tpu.ops import structured as jstruct
from cerberus_tpu.utils import lie as jlie
from cerberus_tpu_torch import convert
from cerberus_tpu_torch.data.simulator import SimConfig as tSimConfig
from cerberus_tpu_torch.data.simulator import simulate as tsimulate
from cerberus_tpu_torch.data.window_builder import build_window_from_sim as tbuild
from cerberus_tpu_torch.ops import factors as tfac
from cerberus_tpu_torch.ops import marginalize as tmarg
from cerberus_tpu_torch.ops import structured as tstruct
from cerberus_tpu_torch.ops.solver import _project_gauge_blocks as t_proj
from torch_port_util import assert_close, assert_rel, np_tree, to_port

SIM = dict(duration=5.0, speed=0.5, seed=3, n_landmarks=150)
BUILD = dict(kf_stride=2, start_cam=2, F=40)


@pytest.fixture(scope="module")
def jwindow():
    data, truth, Fa = jbuild(simulate(SimConfig(**SIM)), jEstimatorConfig(),
                             **BUILD)
    return data, truth, Fa


@pytest.fixture(scope="module")
def problem(jwindow):
    """(JAX state, JAX data, port state, port data): a perturbed state and
    a window with an active marginalization prior and calibration prior."""
    data, truth, _ = jwindow
    rng = np.random.default_rng(7)
    th = rng.normal(size=(11, 3)) * 0.01
    st = truth._replace(
        p=truth.p + jnp.asarray(rng.normal(size=(11, 3)) * 0.03),
        q=jlie.quat_normalize(jlie.quat_mul(truth.q, jlie.delta_q(jnp.asarray(th)))),
        v=truth.v + jnp.asarray(rng.normal(size=(11, 3)) * 0.05),
        depth=truth.depth * (1 + 0.05 * jnp.asarray(
            rng.normal(size=truth.depth.shape))))
    D = jfac.D_DENSE
    cfg = jEstimatorConfig()
    ric, tic = cfg.ric_tic()
    data = data._replace(
        prior_J=jnp.asarray(rng.normal(size=(D, D)) * 0.1),
        prior_r=jnp.asarray(rng.normal(size=(D,))),
        prior_valid=jnp.asarray(True),
        prior_lin=truth._replace(depth=jnp.zeros_like(truth.depth)),
        calib_w=jnp.asarray(np.full(13, 20.0)),
        calib_tic=jnp.asarray(tic + 0.01),
        calib_qic=truth.qic, calib_td=jnp.asarray(0.001))
    tst, tdata = to_port(st, data)
    return st, data, tst, tdata


def test_build_window_from_sim_matches_jax(jwindow):
    """The port's own simulate + build_window_from_sim gives the JAX
    package's window."""
    jdata, jtruth, jFa = jwindow
    tdata, ttruth, tFa = tbuild(tsimulate(tSimConfig(**SIM)), device="cpu",
                                **BUILD)
    assert tFa == jFa
    for tree_t, tree_j in ((tdata, jdata), (ttruth, jtruth)):
        flat_t, flat_j = np_tree(tree_t), np_tree(tree_j)
        assert flat_t.keys() == flat_j.keys()
        for key in flat_t:
            assert flat_t[key].shape == flat_j[key].shape, key
            if flat_j[key].dtype.kind == "f":
                assert_rel(f"window_builder.{key}", flat_t[key], flat_j[key],
                           1e-10)
            else:
                np.testing.assert_array_equal(flat_t[key], flat_j[key],
                                              err_msg=key)


def test_convert_round_trip(problem):
    st, data, tst, tdata = problem
    st_np, data_np = convert.window_to_numpy(tst, tdata)
    for got, want in ((st_np, st), (data_np, data)):
        flat_g, flat_w = np_tree(got), np_tree(want)
        assert flat_g.keys() == flat_w.keys()
        for key in flat_g:
            np.testing.assert_array_equal(flat_g[key], flat_w[key])
    assert tdata.f_start.dtype == torch.int32
    assert tdata.f_obs.dtype == torch.bool


def test_retract_and_local_diff_match_jax(problem):
    st, data, tst, tdata = problem
    F = st.depth.shape[0]
    delta = np.random.default_rng(8).normal(size=(jfac.tangent_dim(F),)) * 0.01
    jr = jfac.retract(st, jnp.asarray(delta))
    tr = tfac.retract(tst, torch.as_tensor(delta))
    for name, a, b in zip(tr._fields, tr, jr):
        assert_rel(f"factors.retract.{name}", a.numpy(), b, 1e-10)
    assert_rel("factors.local_diff", tfac.local_diff(tr, tst).numpy(),
               jfac.local_diff(jr, st), 1e-10)
    # batched form: a leading batch axis on state and delta
    tb = tfac.retract(tfac.map_tensors(lambda x: torch.stack([x, x]), tst),
                      torch.as_tensor(np.stack([delta, -delta])))
    assert_rel("factors.retract.batched.q", tb.q[0].numpy(), jr.q, 1e-10)


def test_window_residuals_and_cost_match_jax(problem):
    st, data, tst, tdata = problem
    F = st.depth.shape[0]
    delta = np.random.default_rng(9).normal(size=(jfac.tangent_dim(F),)) * 1e-3
    jr = jfac.window_residuals(st, jnp.asarray(delta), data)
    tr = tfac.window_residuals(tst, torch.as_tensor(delta), tdata)
    assert tr.shape[0] == jfac.num_residuals(F)
    assert_rel("factors.window_residuals", tr.numpy(), jr, 1e-10)
    assert_rel("factors.huber_row_weights", tfac.huber_row_weights(tr, F).numpy(),
               jfac.huber_row_weights(jr, F), 1e-10)
    assert_rel("factors.robust_cost", tfac.robust_cost(tr, F).numpy(),
               jfac.robust_cost(jr, F), 1e-10)


def test_gauge_basis_and_projection_match_jax(problem):
    st, data, tst, tdata = problem
    D = jfac.D_DENSE
    for dim in (D, D + 40):
        assert_rel("marginalize._gauge_null_basis",
                   tmarg._gauge_null_basis(tst, dim).numpy(),
                   jmarg._gauge_null_basis(st, dim), 1e-12)
    np.testing.assert_array_equal(tmarg.frame_indices(3, device="cpu").numpy(),
                                  np.asarray(jmarg.frame_indices(3)))
    from cerberus_tpu.ops.solver import _project_gauge_blocks as j_proj
    rng = np.random.default_rng(10)
    H = rng.normal(size=(D, D))
    H = H @ H.T
    H_pd = rng.normal(size=(D, 40))
    b = rng.normal(size=(D,))
    want = j_proj(jnp.asarray(H), jnp.asarray(H_pd), jnp.asarray(b), st,
                  data.free_mask)
    got = t_proj(torch.as_tensor(H), torch.as_tensor(H_pd),
                 torch.as_tensor(b), tst, tdata.free_mask)
    for name, a, w in zip(("H_pp", "H_pd", "b_p"), got, want):
        assert_rel(f"solver._project_gauge_blocks.{name}", a.numpy(), w, 1e-10)


def test_normal_equation_blocks_match_jax(problem):
    """H/b/r0 at tests/test_structured.py's tolerances: H atol 1e-7 * scale,
    b atol 1e-8 * scale, r0 atol 1e-10."""
    st, data, tst, tdata = problem
    want = jstruct.build_normal_equations_blocks(st, data)
    got = tstruct.build_normal_equations_blocks(tst, tdata)
    names = ("H_pp", "H_pd", "h_dd", "b_p", "b_d", "r0")
    for name, a, w in zip(names, got, want):
        w = np.asarray(w)
        scale = max(1.0, np.abs(w).max())
        atol = {"H_pp": 1e-7, "H_pd": 1e-7, "h_dd": 1e-7,
                "b_p": 1e-8, "b_d": 1e-8}.get(name)
        assert_close(f"structured.build_normal_equations_blocks.{name}",
                     a.numpy(), w, rtol=0,
                     atol=1e-10 if atol is None else atol * scale)


def test_normal_equation_blocks_vmap_over_windows(problem):
    """The assembly runs under torch.func.vmap over a batch of windows, as
    the batched solve uses it, and gives each window's own blocks."""
    st, data, tst, tdata = problem
    tst2 = tst._replace(p=tst.p + 0.01)
    stack = lambda a, b: torch.stack([a, b])
    sts = tfac.map_tensors(stack, tst, tst2)
    datas = tfac.map_tensors(stack, tdata, tdata)
    batched = torch.func.vmap(tstruct.build_normal_equations_blocks)(sts, datas)
    for i, s in enumerate((tst, tst2)):
        single = tstruct.build_normal_equations_blocks(s, tdata)
        for a, w in zip(batched, single):
            np.testing.assert_allclose(a[i].numpy(), w.numpy(), rtol=1e-12,
                                       atol=1e-12 * max(1.0, w.abs().max()))
