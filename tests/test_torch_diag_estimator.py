"""The port's streaming-estimator diagnostics (`cerberus_tpu_torch/evals/`
`diag_vision.py`, `diag_obs.py`, `diag_proj.py`, `diag_ex.py`,
`diag_dropout.py`) against the JAX repo's scripts, f64 on the CPU.

The JAX scripts run their work at module level (but for diag_vision's
`run` and `cost_at_truth`, used as they stand), so each JAX computation is
rebuilt here from the JAX package's functions as the script's lines
(cited) write it, and the port's functions get the same inputs.

Sizes: one feed per package of SimConfig(duration=1.6, seed=5)'s first 14
camera frames at max_features = 32, max_num_iterations = 4 (the scripts'
EstimatorConfig cut; with the estimator's debug on, as diag_vision runs
it), analysed by diag_vision, diag_obs and diag_proj (b); diag_ex's three
variants over the first 12 frames of a 1.0 s sequence through `replay`;
diag_dropout's simulation and trace here, its 2.5 s run (the battery's
imu_dropout_2x1s) in tests/test_torch_robustness.py.

Tolerances: positions 1e-8 m, costs rtol 1e-8, counts, bad-observation
lists, headers and failure_reasons equal. Each package's QR leaves another
constant in the marginalization prior's residual (its part outside the
prior Jacobian's range), so where a prior exists the cost drops (cost0 -
cost; the estimate's cost less the truth's) are held, not the costs. A
replay that adopts a step on a placeholder newest interval (diag_dropout's
hung IMU) is held only up to it (tests/estimator_runs.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.replay import replay as jreplay
from cerberus_tpu.estimator import estimator as jest
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.utils import lie as jlie
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data.window_builder import (
    build_window_from_sim as tbuild)
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.evals import (diag_dropout, diag_ex, diag_obs,
                                      diag_proj, diag_vision)
from cerberus_tpu_torch.ops import factors as tfac
from estimator_runs import assert_runs_match, placeholder_steps, record
from torch_port_util import assert_close, assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_features=32, max_num_iterations=4)
DUR, FRAMES = 1.6, 14
EX_DUR, EX_FRAMES = 1.0, 12   # diag_ex's DIAG_DUR, DIAG_FRAMES
DROPOUT_DUR = 2.5     # diag_dropout's duration
# the JAX package's (F, 11, 4) projection residual, jitted once for both
# of diag_proj's windows (eager, it takes seconds a call here)
proj_residuals = jax.jit(jfac._proj_residuals)


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


def jax_script(name):
    """evals/<name>.py of the JAX repo as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_evals_{name}", os.path.join(ROOT, "evals", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def feeds():
    """(the JAX script's module, {True: ((JAX estimator, sim, rows), (the
    port's ...))}): the JAX script's `run` (its EstimatorConfig cut to KW)
    and the port's, vision on, 14 frames of the 1.6 s sequence each. (The
    vision-off feed is held to the JAX package's numbers on the card,
    chip_smoke.py's `diagnostics`; diag_ex's vision-off variant holds that
    estimator path here.)"""
    jv = jax_script("diag_vision")
    jv.EstimatorConfig = lambda: jConfig(**KW)
    # the JAX estimator's debug breakdown (estimator.py:1302-1309) and the
    # script's cost_at_truth with the window residual jitted: eager, its
    # first call takes ~13 s here
    residuals = jax.jit(jfac.window_residuals)

    class JittedFactors:
        window_residuals = staticmethod(residuals)

        def __getattr__(self, name):
            return getattr(jfac, name)

    jv.fac = JittedFactors()

    def cost_breakdown(st, data, F):
        r = np.asarray(residuals(st, jnp.zeros((jfac.tangent_dim(F),),
                                               st.p.dtype), data))
        s = 310 + F * 44
        return (float(0.5 * (r[:310] ** 2).sum()),
                float(0.5 * (r[310:s] ** 2).sum()),
                float(0.5 * (r[s:] ** 2).sum()))

    eager, jest._cost_breakdown = jest._cost_breakdown, cost_breakdown
    try:
        jax_run = jv.run(vision=True, duration=DUR, max_frames=FRAMES)
    finally:
        jest._cost_breakdown = eager
    return jv, {True: (
        jax_run, diag_vision.run(vision=True, duration=DUR, max_frames=FRAMES,
                                 device="cpu", cfg=tConfig(**KW)))}


def test_diag_vision_rows_match_jax(feeds):
    (jest_, jsim, jrows), (test_, tsim, trows) = feeds[1][True]
    np.testing.assert_array_equal(tsim["p"], jsim["p"])
    assert len(trows) == len(jrows) > 0
    exact = ("t", "accepted", "rho", "bg", "ex_deg", "ex_dt", "n_depths")
    for i, (tr, jr) in enumerate(zip(trows, jrows)):
        assert set(tr) == set(jr), (set(tr) ^ set(jr))
        for k in exact:
            if k in jr:
                assert tr[k] == jr[k], (i, k, tr[k], jr[k])
        # the entry's ileg and proj parts (its prior part carries each
        # package's QR constant)
        if "entry" in jr:
            assert tr["entry"][:2] == jr["entry"][:2], (i, tr["entry"],
                                                        jr["entry"])
    get = lambda rows, k: np.array([r[k] for r in rows], float)
    for k in ("newest_err", "mean_err"):
        assert_close(f"diag_vision.{k}", get(trows, k),
                     get(jrows, k), 0, 1e-8)
    drop = lambda rows: get(rows, "cost0") - get(rows, "cost")
    assert_rel("diag_vision cost0 - cost", drop(trows),
               drop(jrows), 1e-8)
    assert_close("diag_vision.depth_err_med", get(trows, "depth_err_med"),
                 get(jrows, "depth_err_med"), 1e-8, 1e-10)
    assert test_.stats["keyframes"] == jest_.stats["keyframes"]


def test_diag_vision_cost_at_truth_matches_jax(feeds):
    jv, runs = feeds
    (jest_, jsim, _), (test_, tsim, _) = runs[True]
    (jce, jbe), (jct, jbt) = jv.cost_at_truth(jest_, jsim)
    (tce, tbe), (tct, tbt) = diag_vision.cost_at_truth(test_, tsim)
    # the port's residual: 310 ileg rows, 44 F projection rows, then the
    # marginalization prior and the 13 calibration-prior rows, as the
    # script's r[:310] / r[310:310 + 44 F] split assumes
    data, *_ = test_._pack()
    st = test_._window_state(np.ones(test_.F))
    prior_rows = data.prior_r.shape[-1]
    r = tfac.window_residuals(st, torch.zeros(tfac.tangent_dim(test_.F),
                                              dtype=torch.float64), data)
    assert r.shape == (310 + 44 * test_.F + prior_rows + 13,)
    for tag, tb, jb in (("est", tbe, jbe), ("tru", tbt, jbt)):
        assert_rel(f"cost_at_truth {tag} (ileg, proj)", tb[:2], jb[:2], 1e-8)
    assert_rel("cost(est) - cost(tru)", tce - tct, jce - jct, 1e-8)
    assert_rel("prior(est) - prior(tru)", tbe[2] - tbt[2], jbe[2] - jbt[2],
               1e-8)
    print(f"PORT_DIFF diag_vision final window: cost(est) {tce:.6f} "
          f"(JAX {jce:.6f}), cost(tru) {tct:.6f} (JAX {jct:.6f})")


def jax_check_observations(est, sim):
    """JAX evals/diag_obs.py:41-69."""
    ric, tic = est.cfg.ric_tic()
    lm = sim["landmarks"]
    kis = [min(int(round(h * 500)), len(sim["t"]) - 1) for h in est.headers]
    fm = est.fm
    bad, behind, tot = [], [], 0
    for s in np.nonzero(fm.active)[0]:
        lid = int(fm.ids[s])
        for fi in range(11):
            if not fm.obs[s, fi]:
                continue
            ki = kis[fi]
            Rwc = sim["R"][ki] @ ric[0]
            twc = sim["R"][ki] @ tic[0] + sim["p"][ki]
            pc = Rwc.T @ (lm[lid] - twc)
            if pc[2] < 0.05:
                behind.append((s, lid, fi))
                continue
            pred = pc[:2] / pc[2]
            errpx = np.linalg.norm(fm.pts[s, fi, :2] - pred) * 460.0
            tot += 1
            if errpx > 3.0:
                bad.append((s, lid, fi, errpx, pc[2]))
    return tot, bad, behind


def test_diag_obs_matches_jax(feeds):
    (jest_, jsim, _), (test_, tsim, _) = feeds[1][True]
    got = diag_obs.check_observations(test_, tsim, frames_fed=FRAMES)
    tot, bad, behind = jax_check_observations(jest_, jsim)
    assert got["checked"] == tot > 0
    assert [b[:3] for b in got["bad"]] == [tuple(int(x) for x in b[:3])
                                           for b in bad]
    assert [b[:3] for b in got["behind"]] == [tuple(int(x) for x in b)
                                              for b in behind]
    if bad:
        assert_close("diag_obs bad err_px", [b[3] for b in got["bad"]],
                     [b[3] for b in bad], 1e-8, 1e-8)
    assert got["headers"] == [float(h) for h in jest_.headers]
    assert got["keyframes"] == jest_.stats["keyframes"]
    print(f"PORT_DIFF diag_obs: {tot} observations checked, "
          f"{len(bad)} bad (> 3 px) in both")


def jax_final_window(est, sim):
    """JAX evals/diag_proj.py:51-103: per-feature projection cost at
    aligned truth, the starts, and the mono / stereo rms px."""
    data, feats, slots, depths = est._pack()
    t = sim["t"]
    kis = [min(int(round(h * 500)), len(t) - 1) for h in est.headers]
    p_t, q_t, v_t = sim["p"][kis], sim["q"][kis], sim["v"][kis]
    yaw = lambda q: float(jlie.rot_to_ypr(jlie.quat_to_rot(jnp.asarray(q)))[0])
    yaw_est = yaw(est.q[0])
    yaw_tru = yaw(q_t[0])
    dyaw = np.deg2rad(yaw_est - yaw_tru)
    c, s = np.cos(dyaw), np.sin(dyaw)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    qz = np.array([np.cos(dyaw / 2), 0, 0, np.sin(dyaw / 2)])
    p_a = (p_t - p_t[0]) @ Rz.T + est.p[0]
    q_a = np.stack([jest._quat_mul_np(qz, q) for q in q_t])
    ric, tic = est.cfg.ric_tic()
    lm = sim["landmarks"]
    d_true = np.ones(est.F)
    for n, sslot in enumerate(slots):
        ki = kis[int(est.fm.start[sslot])]
        Rw = sim["R"][ki] @ ric[0]
        tw = sim["R"][ki] @ tic[0] + sim["p"][ki]
        z = (Rw.T @ (lm[int(est.fm.ids[sslot])] - tw))[2]
        d_true[n] = 1.0 / max(z, 0.1)
    st_tru = est._window_state(d_true[: len(slots)])._replace(
        p=jnp.asarray(p_a), q=jnp.asarray(q_a), v=jnp.asarray(v_t @ Rz.T),
        ba=jnp.tile(jnp.asarray(sim["acc_bias"]), (11, 1)),
        bg=jnp.tile(jnp.asarray(sim["gyr_bias"]), (11, 1)),
        rho=jnp.full((11, 4), sim["rho"][0]))
    r = np.asarray(proj_residuals(st_tru, data))[: len(slots)]
    per_feat = 0.5 * (r ** 2).sum(axis=(1, 2))
    rms = lambda x: np.sqrt((x ** 2).sum() / max((np.abs(x) > 0).sum(), 1)) \
        * 1.5
    return (per_feat, est.fm.start[slots], slots, d_true[: len(slots)],
            rms(r[:, :, 0:2]), rms(r[:, :, 2:4]))


def test_diag_proj_final_window_matches_jax(feeds):
    (jest_, jsim, _), (test_, tsim, _) = feeds[1][True]
    got = diag_proj.final_window(test_, tsim)
    per_feat, starts, slots, d_true, rms_mono, rms_st = \
        jax_final_window(jest_, jsim)
    assert got["n_features"] == len(slots) > 0
    assert_rel("diag_proj (b) per-feature cost", got["per_feature"],
               per_feat, 1e-8)
    order = np.argsort(-per_feat)
    assert [w["slot"] for w in got["worst"]] == [int(slots[n])
                                                 for n in order[:12]]
    assert_rel("diag_proj (b) true inverse depths",
               [w["d_tru"] for w in got["worst"]], d_true[order[:12]], 1e-10)
    assert {sf: a["n"] for sf, a in got["anchors"].items()} == {
        sf: int((starts == sf).sum()) for sf in range(11)
        if (starts == sf).sum()}
    assert_rel("diag_proj (b) rms mono, stereo px",
               [got["rms_mono_px"], got["rms_stereo_px"]],
               [rms_mono, rms_st], 1e-8)


def test_diag_proj_perfect_assoc_matches_jax():
    """(a): JAX evals/diag_proj.py:26-35 on the 1.6 s sequence, F = 32."""
    sim = simulate(SimConfig(duration=DUR, speed=0.5, seed=5))
    # the window of diag_proj.py:29-30, built by the port and carried over
    # (tests/test_torch_window.py holds the two packages' builders
    # together; the JAX builder takes ~17 s here)
    tdata, ttruth, _ = tbuild(sim, tConfig(), kf_stride=1, start_cam=2,
                              F=KW["max_features"], device="cpu")
    data, truth = to_jax(tdata, jfac.WindowData), \
        to_jax(ttruth, jfac.WindowState)
    r = np.asarray(proj_residuals(truth, data))
    n_rows = int((np.abs(r) > 0).sum())
    got = diag_proj.perfect_assoc(sim, device="cpu", F=KW["max_features"])
    assert got["n_rows"] == n_rows > 0
    assert_rel("diag_proj (a) cost, rms px", [got["cost"], got["rms_px"]],
               [0.5 * (r ** 2).sum(),
                np.sqrt((r ** 2).sum() / n_rows) * 1.5], 1e-8)


@pytest.fixture
def recording_port_estimator(monkeypatch):
    """Patch `module.Estimator` with a port Estimator that records itself
    (estimator_runs.record) into the returned list."""
    def patch(module, marked):
        recs = []

        class Recorded(test.Estimator):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                recs.append(record(self, marked))
        monkeypatch.setattr(module, "Estimator", Recorded)
        return recs
    return patch


def jax_extrinsic_drift(est, out):
    """JAX evals/diag_ex.py:40-53, unrounded."""
    ric, tic = est.cfg.ric_tic()
    dang = [np.degrees(np.arccos(np.clip(
        (np.trace(jest._quat_to_rot_np(est.qic[i]) @ ric[i].T) - 1) / 2,
        -1, 1))) for i in range(2)]
    d = est.fm.depth[est.fm.active & (est.fm.depth > 0)]
    return (np.linalg.norm(est.tic - tic, axis=1), dang,
            [np.median(d), d.min(), d.max(), len(d)] if len(d) else None)


@pytest.mark.parametrize("est_ex,vision", diag_ex.VARIANTS)
def test_diag_ex_matches_jax(est_ex, vision, recording_port_estimator):
    """diag_ex.py:29-39 per variant, both packages through replay."""
    sim = simulate(SimConfig(duration=EX_DUR, speed=0.5, seed=5))
    with placeholder_steps() as marked:
        recs = recording_port_estimator(diag_ex, marked)
        test_, tout = diag_ex.replay_variant(sim, est_ex, vision, EX_FRAMES,
                                             device="cpu",
                                             base_cfg=tConfig(**KW))
        jest_ = jest.Estimator(jConfig(**KW, estimate_extrinsic=est_ex),
                               dtype=jnp.float64, use_native=False)
        jrec = record(jest_, marked)
        jsim = sim if vision else dict(sim, features=[{} for _ in
                                                      sim["features"]])
        jout = jreplay(jsim, est=jest_, max_frames=EX_FRAMES)
    tag = f"diag_ex[ex={est_ex},vision={vision}]"
    assert_runs_match(tag, {"jax": (jout, jrec), "port": (tout, recs[0])},
                      hold_all=True)
    got = diag_ex.extrinsic_drift(test_, tout)
    dtic, dang, depths = jax_extrinsic_drift(jest_, jout)
    assert_close(f"{tag} |dt|", got["dtic"], dtic, 0, 1e-8)
    assert_close(f"{tag} dang_deg", got["dang_deg"], dang, 0, 1e-6)
    assert_rel(f"{tag} ate, drift, dist",
               [got["ate"], got["drift_pct"], got["dist"]],
               [jout["ate_rmse"], jout["drift_pct"], jout["distance"]], 1e-8)
    assert (got["inv_depths"] is None) == (depths is None) == (not vision)
    if depths is not None:
        d = got["inv_depths"]
        assert d["n"] == depths[3]
        assert_rel(f"{tag} inverse depths", [d["med"], d["min"], d["max"]],
                   depths[:3], 1e-8)


def test_diag_dropout_matches_jax():
    """diag_dropout.py:27-32's simulation (exact) and :38-47's trace on a
    replay's positions. Its run, the battery's imu_dropout_2x1s (the same
    simulation, windows, config and watch), is held to the JAX package
    with this module's `summary` in tests/test_torch_robustness.py, which
    already runs it in both packages."""
    sim = diag_dropout.make_sim(DROPOUT_DUR)
    jr = jax_script("robustness")
    jsim = jr.imu_dropout(
        simulate(SimConfig(duration=DROPOUT_DUR, speed=0.5, path="street",
                           seed=31)), diag_dropout.windows(DROPOUT_DUR))
    for k in ("t", "acc", "gyr", "p", "contacts"):
        np.testing.assert_array_equal(sim[k], jsim[k])
    assert not np.array_equal(sim["acc"], simulate(SimConfig(
        duration=DROPOUT_DUR, speed=0.5, path="street", seed=31))["acc"])
    # a replay's positions: 40 frames at 15 Hz, drifting
    rng = np.random.default_rng(0)
    t = np.arange(40) / 15.0
    out = {"est_t": t, "est_p": rng.normal(size=(40, 3)).cumsum(axis=0),
           "gt_p": rng.normal(size=(40, 3)).cumsum(axis=0)}
    around, final = diag_dropout.error_trace(out, DROPOUT_DUR)
    err = np.linalg.norm(out["est_p"] - out["est_p"][0]
                         - (out["gt_p"] - out["gt_p"][0]), axis=1)
    for t0 in (DROPOUT_DUR * 0.3, DROPOUT_DUR * 0.7):
        sel = (t > t0 - 2) & (t < t0 + 4)
        assert around[t0] == list(zip(t[sel][::3], err[sel][::3]))
    assert final == list(zip(t[-30::5], err[-30::5]))
