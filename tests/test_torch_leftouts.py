"""The last functions the port had left out, against the JAX package in f64
on the CPU: the pure-IMU 15-state preintegration and its residual, the
IMU+leg residual, the dense normal equations (against JAX's and against
J^T J of the dense linearization), the eigendecomposition marginalization
helpers, and the estimator's diagnostics (`debug` / `last_debug` with `_cost_breakdown`,
and `_reject_outliers`).

Inputs: tests/test_golden_reference.py's gait-like sample streams (and its
literal C++ transcription, tests/golden_ref.py); tests/test_structured.py's
window (5 s, seed 3, 150 landmarks, F = 40) at a perturbed state with a
marginalization prior; SPD matrices from a numpy seed; the short replay of
tests/test_torch_streaming.py (SimConfig(duration=1.6, speed=0.5, seed=5),
max_features = 48, max_num_iterations = 4), 12 frames, in both packages.

Tolerances, those of the reference's own tests:
  * imu_preintegrate against JAX and the golden recursion: 1e-12
    matrix-relative (test_golden_reference.py's REL_TOL); imu_residual 1e-11
    and il_residual 1e-10 (that file's residual tolerances);
  * build_normal_equations, against JAX's and against J^T J, J^T r of the
    dense `factors.linearize` at the truth and at the perturbed state with
    the prior: H atol 1e-7 x scale, b atol 1e-8 x scale, r0 atol 1e-10
    (test_structured.py's);
  * _prior_from_Hb in information form (J^T J, J^T r) and _schur_drop's
    (H, b): 1e-8 relative (the marginalization's tolerance in
    tests/test_torch_streaming.py); eigenvalues below the 1e-8 cutoff are
    exact zeros here, so both packages drop the same ones;
  * _cost_breakdown: 1e-10 relative; in the replays the IMU+leg and
    projection parts of `last_debug` within 1e-8 — its prior part carries
    the prior's constant 0.5 |r_perp|^2, which each package's QR leaves to
    its basis (tests/test_torch_log_adapter.py), so it is not compared;
  * _reject_outliers: the same slots removed from equal feature managers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.replay import replay as jreplay
from cerberus_tpu.data.window_builder import build_window_from_sim
from cerberus_tpu.estimator import estimator as jest
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops import marginalize as jmarg
from cerberus_tpu.ops import preintegration as jpre
from cerberus_tpu.ops import structured as jstruct
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data.replay import replay as treplay
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.ops import factors as tfac
from cerberus_tpu_torch.ops import marginalize as tmarg
from cerberus_tpu_torch.ops import preintegration as tpre
from cerberus_tpu_torch.ops import structured as tstruct
from test_golden_reference import (G, _golden_imu, golden_params, make_cfg,
                                   make_stream, run_golden_il)
from torch_port_util import assert_close, assert_rel, to_port

KW = dict(max_features=48, max_num_iterations=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _j(x):
    return jnp.asarray(np.asarray(x), jnp.float64)


def _rand_state(rng, ba, bg, rho=None):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    s = dict(p=rng.normal(size=3), q=q, v=rng.normal(size=3),
             ba=ba + rng.normal(scale=0.01, size=3),
             bg=bg + rng.normal(scale=0.002, size=3))
    if rho is not None:
        s["rho"] = rho + rng.normal(scale=0.002, size=4)
    return s


# ------------------------------------------------- pure IMU (15-state)

@pytest.mark.parametrize("seed,pad", [(0, 0), (1, 0), (2, 5)])
def test_imu_preintegrate_matches_jax_and_golden(seed, pad):
    """15-state preintegration of a gait-like stream (pad: trailing samples
    masked off, which must pass the carry through) against the JAX package
    and the golden C++ transcription."""
    rng = np.random.default_rng(seed)
    cfg = make_cfg(0)
    stream = make_stream(rng)
    ba = rng.normal(scale=0.05, size=3)
    bg = rng.normal(scale=0.01, size=3)
    mask = stream["mask"].copy()
    if pad:
        mask[-pad:] = False
    jparams = jpre.PreintParams.from_config(cfg)
    tparams = tpre.PreintParams.from_config(
        dataclasses.replace(tConfig(), robot=cfg.robot, noise=cfg.noise),
        torch.float64, device="cpu")
    args = (stream["dt"], stream["acc"], stream["gyr"])
    jp = jpre.imu_preintegrate(*map(_j, args), jnp.asarray(mask), _j(ba),
                               _j(bg), jparams)
    tp = tpre.imu_preintegrate(*map(_t, args), torch.as_tensor(mask), _t(ba),
                               _t(bg), tparams)
    assert type(tp).__name__ == "ImuPreint" and tp._fields == jp._fields
    for k in tp._fields:
        assert_rel(f"imu_preintegrate[{seed},{pad}].{k}",
                   getattr(tp, k).numpy(), np.asarray(getattr(jp, k)), 1e-12)
    if not pad:
        g = _golden_imu(stream, ba, bg, cfg, "instep")
        for k, want in (("dp", g.delta_p), ("dq", g.delta_q),
                        ("dv", g.delta_v), ("J", g.jacobian),
                        ("P", g.covariance), ("sum_dt", g.sum_dt)):
            assert_rel(f"imu_preintegrate[{seed}].{k} vs golden",
                       getattr(tp, k).numpy(), want, 1e-12)


def test_imu_residual_matches_jax_and_golden():
    rng = np.random.default_rng(4)
    cfg = make_cfg(0)
    stream = make_stream(rng)
    ba = rng.normal(scale=0.05, size=3)
    bg = rng.normal(scale=0.01, size=3)
    tparams = tpre.PreintParams.from_config(
        dataclasses.replace(tConfig(), robot=cfg.robot, noise=cfg.noise),
        torch.float64, device="cpu")
    args = (stream["dt"], stream["acc"], stream["gyr"])
    tp = tpre.imu_preintegrate(*map(_t, args), torch.as_tensor(
        stream["mask"]), _t(ba), _t(bg), tparams)
    jp = jpre.imu_preintegrate(*map(_j, args), jnp.asarray(stream["mask"]),
                               _j(ba), _j(bg),
                               jpre.PreintParams.from_config(cfg))
    g = _golden_imu(stream, ba, bg, cfg, "instep")
    for n in range(5):
        si, sj = _rand_state(rng, ba, bg), _rand_state(rng, ba, bg)
        r = tpre.imu_residual(tp, {k: _t(v) for k, v in si.items()},
                              {k: _t(v) for k, v in sj.items()}, _t(G))
        rj = jpre.imu_residual(jp, {k: _j(v) for k, v in si.items()},
                               {k: _j(v) for k, v in sj.items()}, _j(G))
        assert_rel(f"imu_residual[{n}] vs JAX", r.numpy(), np.asarray(rj),
                   1e-11)
        gold = g.evaluate(si["p"], si["q"], si["v"], si["ba"], si["bg"],
                          sj["p"], sj["q"], sj["v"], sj["ba"], sj["bg"], G)
        assert_rel(f"imu_residual[{n}] vs golden", r.numpy(), gold, 1e-11)


# ------------------------------------------------- IMU + leg residual

@pytest.mark.parametrize("ct", [0, 2])
def test_il_residual_matches_jax_and_golden(ct):
    rng = np.random.default_rng(5 + ct)
    cfg = make_cfg(ct)
    stream = make_stream(rng, contact_sensor_type=ct)
    ba = rng.normal(scale=0.05, size=3)
    bg = rng.normal(scale=0.01, size=3)
    rho = 0.21 + rng.normal(scale=0.005, size=4)
    jparams = jpre.PreintParams.from_config(cfg)
    tparams = tpre.PreintParams.from_config(
        dataclasses.replace(tConfig(), robot=cfg.robot, noise=cfg.noise,
                            contact_sensor_type=ct),
        torch.float64, device="cpu")
    keys = ("dt", "acc", "gyr", "phi", "dphi", "c")
    tp = tpre.il_preintegrate(*(_t(stream[k]) for k in keys),
                              torch.as_tensor(stream["mask"]), _t(ba), _t(bg),
                              _t(rho), tparams)
    jp = jpre.il_preintegrate(*(_j(stream[k]) for k in keys),
                              jnp.asarray(stream["mask"]), _j(ba), _j(bg),
                              _j(rho), jparams)
    g = run_golden_il(stream, ba, bg, rho, golden_params(cfg), "instep")
    for n in range(5):
        si = _rand_state(rng, ba, bg, rho)
        sj = _rand_state(rng, ba, bg, rho)
        r = tpre.il_residual(tp, {k: _t(v) for k, v in si.items()},
                             {k: _t(v) for k, v in sj.items()}, _t(G))
        rj = jpre.il_residual(jp, {k: _j(v) for k, v in si.items()},
                              {k: _j(v) for k, v in sj.items()}, _j(G))
        assert r.shape == (31,)
        assert_rel(f"il_residual[ct={ct},{n}] vs JAX", r.numpy(),
                   np.asarray(rj), 1e-10)
        gold = g.evaluate(si["p"], si["q"], si["v"], si["ba"], si["bg"],
                          si["rho"], sj["p"], sj["q"], sj["v"], sj["ba"],
                          sj["bg"], sj["rho"], G)
        assert_rel(f"il_residual[ct={ct},{n}] vs golden", r.numpy(), gold,
                   1e-10)


# ------------------------------------------------- the window

@pytest.fixture(scope="module")
def built_window():
    """tests/test_structured.py's window: (data, truth), built once for
    both fixtures below."""
    sim = simulate(SimConfig(duration=5.0, speed=0.5, seed=3,
                             n_landmarks=150))
    data, truth, _ = build_window_from_sim(sim, jConfig(), kf_stride=2,
                                           start_cam=2, F=40)
    return data, truth


@pytest.fixture(scope="module")
def window(built_window):
    """tests/test_structured.py's window at a perturbed state, with the
    prior of marginalize_old at the truth (its ..._with_prior case)."""
    data, truth = built_window
    pj, pr, _ = jax.jit(jmarg.marginalize_old)(truth, data)
    data = data._replace(prior_J=pj, prior_r=pr,
                         prior_valid=jnp.asarray(True), prior_lin=truth)
    rng = np.random.default_rng(0)
    st = truth._replace(p=truth.p + jnp.asarray(rng.normal(size=(11, 3))
                                                * 0.02))
    return st, data, to_port(st, data)


def test_build_normal_equations_matches_jax(window):
    st, data, (tst, tdata) = window
    H, b, r0 = tstruct.build_normal_equations(tst, tdata)
    jH, jb, jr0 = jax.jit(jstruct.build_normal_equations)(st, data)
    jH, jb = np.asarray(jH), np.asarray(jb)
    assert H.shape == jH.shape == (222 + 40, 222 + 40)
    assert_close("build_normal_equations.H", H.numpy(), jH, 0,
                 1e-7 * max(1.0, np.abs(jH).max()))
    assert_close("build_normal_equations.b", b.numpy(), jb, 0,
                 1e-8 * max(1.0, np.abs(jb).max()))
    assert_close("build_normal_equations.r0", r0.numpy(), np.asarray(jr0), 0,
                 1e-10)
    assert torch.equal(H, H.T)


@pytest.fixture(scope="module")
def window_at_truth(built_window):
    """tests/test_structured.py's window at the truth, without a prior (its
    test_H_b_match_dense case)."""
    data, truth = built_window
    return truth, data, to_port(truth, data)


@pytest.mark.parametrize("case", ["truth", "perturbed_with_prior"])
def test_build_normal_equations_matches_dense(request, case):
    """The structured (H, b) equals J^T J, J^T r of the dense linearization,
    the port's and the JAX package's (test_structured.py's
    test_H_b_match_dense and ..._with_prior_and_perturbation)."""
    fixture = "window_at_truth" if case == "truth" else "window"
    st, data, (tst, tdata) = request.getfixturevalue(fixture)
    H, b, r0 = tstruct.build_normal_equations(tst, tdata)
    r, J, r0_dense = tfac.linearize(tst, tdata)
    jr, jJ, _ = jax.jit(jfac.linearize)(st, data)
    jJ, jr = np.asarray(jJ), np.asarray(jr)
    for who, H_d, b_d in (("port", (J.T @ J).numpy(), (J.T @ r).numpy()),
                          ("JAX", jJ.T @ jJ, jJ.T @ jr)):
        assert_close(f"build_normal_equations[{case}].H vs {who} J^T J",
                     H.numpy(), H_d, 0, 1e-7 * max(1.0, np.abs(H_d).max()))
        assert_close(f"build_normal_equations[{case}].b vs {who} J^T r",
                     b.numpy(), b_d, 0, 1e-8 * max(1.0, np.abs(b_d).max()))
    assert_close(f"build_normal_equations[{case}].r0 vs dense", r0.numpy(),
                 r0_dense.numpy(), 0, 1e-10)


def test_cost_breakdown_matches_jax(window):
    st, data, (tst, tdata) = window
    got = test._cost_breakdown(tst, tdata, 40)
    want = jest._cost_breakdown(st, data, 40)
    assert len(got) == 3 and all(c > 0 for c in got)
    assert_rel("_cost_breakdown (ileg, proj, prior)", got, want, 1e-10)


def _spd(seed, n, deficient):
    """H = D A^T A D with a 1e6 scale spread on D and `deficient` exact null
    directions (A has n - deficient rows), b in H's range plus a part
    outside it."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n - deficient, n))
    d = np.geomspace(1e-3, 1e3, n)
    H = (A * d).T @ (A * d)
    b = H @ rng.normal(size=n)
    return H, b


@pytest.mark.parametrize("deficient", [0, 3])
def test_prior_from_Hb_matches_jax(deficient):
    H, b = _spd(7, 40, deficient)
    J, r = tmarg._prior_from_Hb(_t(H), _t(b), torch.float64)
    jJ, jr = jmarg._prior_from_Hb(_j(H), _j(b), jnp.float64)
    jJ, jr = np.asarray(jJ), np.asarray(jr)
    J, r = J.numpy(), r.numpy()
    for part, g, w in (("JtJ", J.T @ J, jJ.T @ jJ), ("Jtr", J.T @ r,
                                                      jJ.T @ jr)):
        assert_rel(f"_prior_from_Hb[{deficient}].{part}", g, w, 1e-8)
    assert_rel(f"_prior_from_Hb[{deficient}] JtJ vs H", J.T @ J, H, 1e-8)
    assert int((np.abs(J).sum(1) == 0).sum()) == deficient


@pytest.mark.parametrize("deficient", [0, 3])
def test_schur_drop_matches_jax(deficient):
    H, b = _spd(11, 40, deficient)
    drop = np.zeros(40, bool)
    drop[[0, 3, 7, 8, 20, 39]] = True
    Hn, bn = tmarg._schur_drop(_t(H), _t(b), torch.as_tensor(drop))
    jHn, jbn = jmarg._schur_drop(_j(H), _j(b), jnp.asarray(drop))
    assert_rel(f"_schur_drop[{deficient}].H", Hn.numpy(), np.asarray(jHn),
               1e-8)
    assert_rel(f"_schur_drop[{deficient}].b", bn.numpy(), np.asarray(jbn),
               1e-8)
    assert not Hn.numpy()[drop].any() and not bn.numpy()[drop].any()


# ------------------------------------------------- estimator diagnostics

@pytest.fixture(scope="module")
def debug_replays():
    """Both packages' 12-frame replay with est.debug = True."""
    sim = simulate(SimConfig(duration=1.6, speed=0.5, seed=5))
    j = jest.Estimator(dataclasses.replace(jConfig(), **KW), use_native=False)
    t = test.Estimator(dataclasses.replace(tConfig(), **KW), device="cpu")
    for est, run in ((j, jreplay), (t, treplay)):
        est.debug = True
        run(sim, est=est, max_frames=12)
    return j, t


def test_debug_cost_breakdown_matches_jax(debug_replays):
    """debug = True: each per-frame step records the window's cost
    breakdown at its entry in last_debug["entry"] (and the INITIAL slide
    the born prior's cost in last_debug["born_prior"])."""
    j, t = debug_replays
    assert t.solver_flag == t.NON_LINEAR and t.stats["solves"] >= 1
    got, want = t.last_debug["entry"], j.last_debug["entry"]
    assert len(got) == 3 and np.all(np.isfinite(got))
    assert_rel("last_debug entry (ileg, proj)", got[:2], want[:2], 1e-8)
    assert "born_prior" not in t.last_debug or t.last_debug["born_prior"] > 0


def test_reject_outliers_matches_jax(debug_replays):
    """_reject_outliers on equal feature managers: three tracked features
    pushed 230 px off in the newest observed frame (the rule averages a
    feature's error over all its observations) are removed by both
    packages, and the same slots stay."""
    j, t = debug_replays
    for est in (j, t):
        est.debug = False
        est.flush()
    np.testing.assert_array_equal(t.fm.active, j.fm.active)
    np.testing.assert_array_equal(t.fm.ids, j.fm.ids)
    # the newest frame with observations (after the slide: frame 9)
    f = max(i for i in range(11) if t.fm.obs[:, i].any())
    cand = np.nonzero(t.fm.active & (t.fm.depth > 0) & t.fm.obs[:, f]
                      & (t.fm.start < f))[0][:3]
    assert len(cand) == 3
    for est in (j, t):
        est.fm.pts[cand, f, :2] += 0.5
        est._reject_outliers()
    np.testing.assert_array_equal(t.fm.active, j.fm.active)
    assert not t.fm.active[cand].any()
    print(f"PORT_DIFF _reject_outliers removed slots equal "
          f"({int(t.fm.active.sum())} kept)")
