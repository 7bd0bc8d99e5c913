"""The port's simulator, preintegration, EKF, tracker and loop diagnostics
(`cerberus_tpu_torch/evals/diag_simcheck.py`, `diag_rho.py`,
`diag_ekf_slip.py`, `diag_ekf_slip2.py`, `diag_tracker.py`,
`diag_loop.py`) against the JAX repo's scripts, f64 on the CPU.

Scripts that run at module level and are cheap (diag_simcheck, and
diag_ekf_slip through its duration and EKF_VARIANTS knobs) run as they
stand (`runpy`); the rest are rebuilt here from the JAX package's
functions as the script's lines (cited) write them, with the JAX script's
own `run_tracker` and `DiagCloser`.

Sizes: diag_simcheck at its own (4 s); diag_rho's FD check on its 200
samples and its window solve on a 3 s sequence at F = 32 for 3 LM
iterations; the EKF pair at one variant each over 200 samples of both
simulations; diag_tracker on 5 frames rendered at 320x240; diag_loop on
2 s of the street rendered once at 320x240 and fed to both packages'
DiagCloser with exclude_last = 3, min_sim = 0, min_kf_dist = 0.05 m and a
64-node pose graph, so that candidates reach every stage and one closes.

Tolerances: diag_simcheck exact (its printed lines and arrays equal); the
FD and J columns 1e-10 relative; the window solve's rho and positions
1e-8, costs rtol 1e-8; EKF drift / ATE 1e-8 relative; the trackers' points
1e-3 px with equal ids; the closers' counters and count lists equal.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cerberus_tpu.data.replay as jreplay_mod
import cerberus_tpu.loop.closer as jcloser_mod
from cerberus_tpu import config as jC
from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.data.replay import score as jscore
from cerberus_tpu.data.simulator import ImageRenderer as jRenderer
from cerberus_tpu.frontend import LeggedEKF as jLeggedEKF
from cerberus_tpu.frontend.device_tracker import DeviceTracker as jDevice
from cerberus_tpu.frontend.tracker import FeatureTracker as jFeature
from cerberus_tpu.frontend.tracker import PinholeCamera as jCamera
from cerberus_tpu.loop.posegraph import PoseGraph as jPoseGraph
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops.preintegration import PreintParams as jParams
from cerberus_tpu.ops.preintegration import il_preintegrate as jpreint
from cerberus_tpu.ops.solver import SolveOptions as jOptions
from cerberus_tpu.ops.solver import solve_window as jsolve
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data.window_builder import (
    build_window_from_sim as tbuild)
from cerberus_tpu_torch.evals import (diag_ekf_slip, diag_ekf_slip2,
                                      diag_loop, diag_rho, diag_simcheck,
                                      diag_tracker)
from cerberus_tpu_torch.loop import closer as tcloser_mod
from cerberus_tpu_torch.loop.posegraph import PoseGraph as tPoseGraph
from torch_port_util import assert_close, assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVALS = os.path.join(ROOT, "evals")
RHO_DUR, RHO_F, RHO_ITERS = 3.0, 32, 3
EKF_DUR = 0.4        # 200 samples
TRACK_FRAMES, TRACK_DUR = 5, 1.0
LOOP_DUR = 2.0
LOOP_KW = dict(exclude_last=3, min_sim=0.0, min_kf_dist=0.05)
SMALL_IMAGE = dict(image_width=320, image_height=240)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small ops: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """evals/<name>.py of the JAX repo as a module of its own (scripts whose
    work is under `main` only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_evals_{name}", os.path.join(EVALS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(name, argv=(), env=None):
    """evals/<name>.py executed as it stands, with sys.argv[1:] = argv and
    the environment variables env; returns (its globals, its stdout)."""
    saved = sys.argv, {k: os.environ.get(k) for k in (env or {})}
    sys.argv = [name, *argv]
    os.environ.update(env or {})
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(os.path.join(EVALS, f"{name}.py"),
                               run_name=name)
    finally:
        sys.argv = saved[0]
        for k, v in saved[1].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return g, out.getvalue()


def test_diag_simcheck_exact():
    g, jax_out = run_script("diag_simcheck")
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        res = diag_simcheck.main([])
    assert port_out.getvalue() == jax_out
    sim, est_cfg = diag_simcheck.make_sim()
    for k in ("p", "v", "q", "acc_true", "gyr_true", "phi_true",
              "dphi_true", "contacts"):
        np.testing.assert_array_equal(sim[k], g["sim"][k])
    np.testing.assert_array_equal(
        diag_simcheck.leg_velocity_errors(sim, est_cfg), g["errs"])
    assert res["max_q_err"] == g["max_qerr"]
    assert res["leg_odom_vel_err"]["max"] == g["errs"].max()
    print(f"PORT_DIFF diag_simcheck: equal (exact), {len(g['errs'])} stance "
          f"samples, max |q err| {g['max_qerr']:.3e}")


@pytest.fixture(scope="module")
def rho_sims():
    """diag_rho.py:31-38 at RHO_DUR s: the JAX package's simulation with
    the true 0.215 m calf, and the port's."""
    robot = dataclasses.replace(jConfig().robot, lower_leg_length=0.215)
    jsim = simulate(SimConfig(duration=RHO_DUR, speed=0.5, seed=24),
                    jConfig(robot=robot))
    tsim = diag_rho.make_sim(duration=RHO_DUR)
    for k in ("acc", "gyr", "phi", "dphi", "contacts", "p"):
        np.testing.assert_array_equal(tsim[k], jsim[k])
    return jsim, tsim


def test_diag_rho_fd_check_matches_jax(rho_sims):
    """diag_rho.py:40-75."""
    jsim, tsim = rho_sims
    params = jParams.from_config(jConfig(), jnp.float64)
    s, e = 0, 200
    sl = slice(s, e + 1)
    n = e - s + 1
    mask = np.ones(n, bool)
    mask[0] = False
    f = lambda x: jnp.asarray(x, jnp.float64)

    preint = jax.jit(lambda *a: jpreint(*a, params))

    def preint_at(rho_val):
        return preint(f(np.full(n, 1 / 500)), f(jsim["acc"][sl]),
                      f(jsim["gyr"][sl]), f(jsim["phi"][sl]),
                      f(jsim["dphi"][sl]), f(jsim["contacts"][sl]),
                      jnp.asarray(mask), jnp.zeros(3), jnp.zeros(3),
                      jnp.full((4,), rho_val))

    p0, p1 = preint_at(0.21), preint_at(0.21 + 1e-5)
    fd = (np.asarray(p1.deps) - np.asarray(p0.deps)) / 1e-5
    J = np.asarray(p0.J)
    jcol = np.stack([J[jC.ILO_EPS + 3 * j:jC.ILO_EPS + 3 * j + 3,
                       jC.ILO_RHO + j] for j in range(4)])
    got = diag_rho.fd_check(tsim, "cpu")
    assert_rel("diag_rho J d(eps)/d(rho)", got["J_col"], jcol, 1e-10)
    assert_rel("diag_rho FD", got["fd"], fd, 1e-10)
    assert_rel("diag_rho deps@0.21, @0.215",
               [got["deps_nom"], got["deps_true"]],
               [np.asarray(p0.deps), np.asarray(preint_at(0.215).deps)],
               1e-10)
    np.testing.assert_array_equal(got["truth"], jsim["R"][s].T
                                  @ (jsim["p"][e] - jsim["p"][s]))
    # the script's verdict: the column agrees with its FD to the same digits
    agree = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    print(f"PORT_DIFF diag_rho |J - FD| / |FD|: port "
          f"{agree(got['J_col'], got['fd']):.3e}, JAX {agree(jcol, fd):.3e}")


def test_diag_rho_window_solve_matches_jax(rho_sims):
    """diag_rho.py:77-96 at F = RHO_F, RHO_ITERS LM iterations."""
    jsim, tsim = rho_sims
    # the window of diag_rho.py:78-79, built by the port and carried over
    # (tests/test_torch_window.py holds the two packages' builders
    # together; the JAX builder takes ~17 s here)
    tdata, ttruth, _ = tbuild(tsim, tConfig(), kf_stride=3, start_cam=6,
                              F=RHO_F, device="cpu")
    data, truth = to_jax(tdata, jfac.WindowData), \
        to_jax(ttruth, jfac.WindowState)
    truth = truth._replace(rho=jnp.full((11, 4), 0.215))
    rng = np.random.default_rng(0)
    init = truth._replace(
        rho=jnp.full((11, 4), 0.21),
        p=truth.p + jnp.asarray(rng.normal(size=(11, 3)) * 0.01),
        v=truth.v + jnp.asarray(rng.normal(size=(11, 3)) * 0.02),
        ba=jnp.zeros_like(truth.ba), bg=jnp.zeros_like(truth.bg))
    st, info = jax.jit(lambda i, d: jsolve(
        i, d, jOptions(max_iters=RHO_ITERS)))(init, data)
    got = diag_rho.window_solve(tsim, "cpu", max_iters=RHO_ITERS, F=RHO_F)
    assert got["accepted"] == int(info.accepted)
    assert_rel("diag_rho cost0, cost", [got["cost0"], got["cost"]],
               [float(info.cost0), float(info.cost)], 1e-8)
    assert_close("diag_rho rho (frame 5)", got["rho_frame5"],
                 np.asarray(st.rho[5]), 0, 1e-8)
    assert_close("diag_rho pos err", got["pos_err"], np.linalg.norm(
        np.asarray(st.p) - np.asarray(truth.p), axis=1), 0, 1e-8)
    # the verdict: rho moves from 0.21 toward the true 0.215 by JAX's amount
    moved = np.abs(got["rho_frame5"] - 0.215) < 0.005
    assert list(moved) == list(np.abs(np.asarray(st.rho[5]) - 0.215) < 0.005)


def to_jax(tree, cls):
    """A port NamedTuple (CPU tensors) as the JAX package's `cls`."""
    return cls(**{k: to_jax(v, jfac.WindowState) if k == "prior_lin"
                  else jnp.asarray(v.numpy())
                  for k, v in tree._asdict().items()})


def jax_ekf_run(cfg, sim):
    """diag_ekf_slip.py:32-43 (= diag_ekf_slip2.py:31-42)."""
    ekf = jLeggedEKF(cfg, filter_window=4)
    ekf.init_filter(sim["t"][0], sim["acc"][0], sim["gyr"][0], sim["phi"][0])
    ps = []
    for k in range(1, len(sim["t"])):
        ekf.update_filter(sim["t"][k], sim["acc"][k], sim["gyr"][k],
                          sim["phi"][k], dphi=sim["dphi"][k],
                          foot_force=sim["foot_forces"][k])
        ps.append(ekf.get_state()[0:3])
    ps = np.array(ps)
    gt = sim["p"][1:len(ps) + 1] - sim["p"][0]
    return jscore(ps[:, :2], gt[:, :2])


def assert_scores(tag, got, want):
    keys = ("drift_pct", "ate_rmse", "distance", "final_err")
    assert_rel(tag, [got[k] for k in keys], [want[k] for k in keys], 1e-8)


def test_diag_ekf_slip_matches_jax(monkeypatch):
    """The script as it stands at 0.4 s with EKF_VARIANTS=gate11_var25."""
    scores = []
    score = jreplay_mod.score
    monkeypatch.setattr(jreplay_mod, "score",
                        lambda *a: scores.append(score(*a)) or scores[-1])
    g, out = run_script("diag_ekf_slip", argv=[str(EKF_DUR)],
                        env={"EKF_VARIANTS": "gate11_var25"})
    assert len(g["sim_slip"]["t"]) == 200 and len(scores) == 2
    res = diag_ekf_slip.run(EKF_DUR, "cpu", "gate11_var25")
    assert res["samples"] == 200
    for name, want in zip(("slip", "clean"), scores):
        assert_scores(f"diag_ekf_slip gate11_var25 {name}",
                      res["gate11_var25"][name], want)
    assert out.split("|")[:2] == [
        f"gate11_var25: slip {res['gate11_var25']['slip']['drift_pct']:.3f}"
        f"% ate {res['gate11_var25']['slip']['ate_rmse']:.4f} ",
        f" clean {res['gate11_var25']['clean']['drift_pct']:.3f}% "]


def test_diag_ekf_slip2_matches_jax():
    """diag_ekf_slip2.py:24-52 for the variant fw0.001_vn0.1."""
    jsims = [simulate(SimConfig(duration=EKF_DUR, speed=0.4, seed=21)),
             simulate(SimConfig(duration=EKF_DUR, speed=0.4, seed=21,
                                foot_slip_sigma=0.0,
                                foot_slip_forward_bias=0.0))]
    n = dataclasses.replace(jConfig().noise, ekf_slip_gate_chi2=11.34,
                            ekf_force_var_rescale=0.0,
                            ekf_foot_walk_contact=1e-3, ekf_meas_vel_n=0.1)
    cfg = dataclasses.replace(jConfig(), noise=n)
    res = diag_ekf_slip2.run(EKF_DUR, "cpu", ["fw0.001_vn0.1"])
    assert set(res) == {"duration", "samples", "fw0.001_vn0.1"}
    for name, sim in zip(("slip", "clean"), jsims):
        assert_scores(f"diag_ekf_slip2 fw0.001_vn0.1 {name}",
                      res["fw0.001_vn0.1"][name], jax_ekf_run(cfg, sim))


class Recording:
    """A tracker whose every `track` output is kept."""

    def __init__(self, tracker):
        self.tracker, self.outs = tracker, []

    def track(self, *a):
        self.outs.append(self.tracker.track(*a))
        return self.outs[-1]


def test_diag_tracker_matches_jax(monkeypatch):
    """diag_tracker.py:84-96 on TRACK_FRAMES frames at 320x240, the JAX
    script's run_tracker on the JAX package's trackers beside the port's."""
    script = jax_script("diag_tracker")
    cfg = jConfig(**SMALL_IMAGE)
    sim = simulate(SimConfig(duration=TRACK_DUR, speed=0.75, path="street",
                             seed=77), est_cfg=cfg)
    r = jRenderer(sim, cfg)
    cams = [jCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
            for _ in range(2)]
    kw = dict(max_cnt=cfg.max_cnt, min_dist=cfg.min_dist,
              flow_back=cfg.flow_back)
    jtrackers = {"cv": Recording(jFeature(cams[0], cams[1], **kw)),
                 "device": Recording(jDevice(cams[0], cams[1], **kw))}
    lines = {}
    for name, tr in jtrackers.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            script.run_tracker(f"{name:6s}", tr, sim, r, TRACK_FRAMES, r.f,
                               r.cx, r.cy)
        lines[name] = out.getvalue()
    ttrackers = {}
    for cls in ("FeatureTracker", "DeviceTracker"):
        inner = getattr(diag_tracker, cls)

        def make(*a, _inner=inner, _name=cls, **k):
            ttrackers[_name] = Recording(_inner(*a, **k))
            return ttrackers[_name]
        monkeypatch.setattr(diag_tracker, cls, make)
    res = diag_tracker.run(duration=TRACK_DUR, max_frames=TRACK_FRAMES,
                           cfg=tConfig(**SMALL_IMAGE), device="cpu")
    assert res["frames"] == TRACK_FRAMES
    for name, cls in (("cv", "FeatureTracker"), ("device", "DeviceTracker")):
        touts, jouts = ttrackers[cls].outs, jtrackers[name].outs
        assert len(touts) == len(jouts) == TRACK_FRAMES
        worst = 0.0
        for to, jo in zip(touts, jouts):
            assert list(to) == list(jo), name       # equal ids: equal status
            for fid in jo:
                for a, b in zip(to[fid], jo[fid]):
                    assert (a is None) == (b is None), (name, fid)
                    if a is not None:
                        worst = max(worst, float(np.abs(
                            np.asarray(a) - np.asarray(b)).max()) * r.f)
        print(f"PORT_DIFF diag_tracker {name}: max |d| {worst:.3e} px")
        assert worst <= 1e-3, (name, worst)
        # the printed line: features and track length (integers as
        # printed) and the error p50 / p90 within 1e-3 px and the rounding
        m = re.search(r"n_feat p50 (\S+)\s+track-err px p50 (\S+) p90 (\S+)"
                      r"\s+track len p50 (\S+)", lines[name])
        want = [float(x) for x in m.groups()]
        got = res[name]
        assert f"{got['n_feat_p50']:.0f}" == m.group(1)
        assert f"{got['len_p50']:.0f}" == m.group(4)
        for k, w in zip(("err_p50", "err_p90"), want[1:3]):
            assert abs(got[k] - w) <= 1.5e-3, (name, k, got[k], w)


@pytest.fixture(scope="module")
def loop_frames():
    """LOOP_DUR s of the street at 320x240, rendered once: the keyframes
    both packages' DiagCloser get."""
    cfg = tConfig(**SMALL_IMAGE)
    sim, r = diag_loop.make_stream(duration=LOOP_DUR, cfg=cfg)
    return cfg, r, list(diag_loop.keyframes(sim, r))


def small_graphs(monkeypatch):
    """A 64-node pose graph in both packages' LoopCloser (the JAX
    package's one-hot assembly at 512 nodes costs ~1 s a GN iteration)."""
    kw = dict(capacity_nodes=64, capacity_edges=256)
    monkeypatch.setattr(jcloser_mod, "PoseGraph",
                        functools.partial(jPoseGraph, **kw))
    monkeypatch.setattr(tcloser_mod, "PoseGraph",
                        functools.partial(tPoseGraph, **kw, device="cpu"))


def test_diag_loop_matches_jax(loop_frames, monkeypatch):
    """diag_loop.py:77-107 on the same keyframes: the JAX script's
    DiagCloser (given the seq_consistent keyword it lacks) and the
    port's."""
    small_graphs(monkeypatch)
    script = jax_script("diag_loop")

    class JaxDiagCloser(script.DiagCloser):
        def _try_close(self, old_idx, rec, sim=1.0, seq_consistent=False):
            script.DiagCloser._try_close(self, old_idx, rec, sim=sim)

    cfg, r, frames = loop_frames
    jc = JaxDiagCloser(jConfig(**SMALL_IMAGE), focal=r.f, cx=r.cx, cy=r.cy,
                       **LOOP_KW)
    tc = diag_loop.DiagCloser(cfg, focal=r.f, cx=r.cx, cy=r.cy, **LOOP_KW,
                              device="cpu")
    n_j, n_t = diag_loop.feed(jc, frames), diag_loop.feed(tc, frames)
    assert n_t == n_j
    for k in ("cand", "few_matches", "few_world", "pnp_fail", "pnp_ok",
              "match_counts", "world_counts"):
        assert tc.st[k] == jc.st[k], (k, tc.st[k], jc.st[k])
    # the stream reaches every stage, and the script's count of candidates
    # ends short of its outcomes by pnp_ok (its "undo double-counting")
    assert tc.st["few_matches"] > 0 and tc.st["pnp_ok"] > 0
    assert tc.st["cand"] == sum(tc.st[k] for k in (
        "few_matches", "few_world", "pnp_fail", "pnp_ok")) - tc.st["pnp_ok"]
    assert_close("diag_loop pnp_err", tc.st["pnp_err"], jc.st["pnp_err"], 0,
                 1e-8)
    for k in ("kf_skipped", "loops_found", "loops_rejected"):
        assert getattr(tc, k) == getattr(jc, k), k
    assert_rel("diag_loop best_sim", tc.best_sim, jc.best_sim, 1e-6)
    assert_close("diag_loop corrected", tc.corrected(), jc.corrected(), 0,
                 1e-8)
    s = diag_loop.summary(tc, n_t)
    assert s["loops_found"] == jc.loops_found > 0
    print(f"PORT_DIFF diag_loop: {n_t} keyframes, candidates "
          f"{s['cand']} -> few_matches {s['few_matches']} few_world "
          f"{s['few_world']} pnp_fail {s['pnp_fail']} pnp_ok {s['pnp_ok']}, "
          f"equal in both")


def test_jax_diag_loop_stops_at_first_verified_candidate(loop_frames,
                                                         monkeypatch):
    """The JAX script's DiagCloser._try_close lacks the seq_consistent
    keyword its LoopCloser passes: the script raises at the first candidate
    that reaches verification (a fault of the reference, kept there)."""
    small_graphs(monkeypatch)
    script = jax_script("diag_loop")
    cfg, r, frames = loop_frames
    jc = script.DiagCloser(jConfig(**SMALL_IMAGE), focal=r.f, cx=r.cx,
                           cy=r.cy, **LOOP_KW)
    with pytest.raises(TypeError, match="seq_consistent"):
        diag_loop.feed(jc, frames)
