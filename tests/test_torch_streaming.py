"""The port's streaming estimator against the JAX package, f64 on the CPU:
the modules the per-frame step runs, the step itself, and a short replay.

Inputs: the simulated sequence SimConfig(duration=1.6, speed=0.5, seed=5)
through 14 camera frames with max_features = 48 and max_num_iterations = 4
(the JAX Estimator built with use_native=False, so both sides run the same
Python sensor sync). The port's replay records the inputs of its first
per-frame step; module and step comparisons feed those, carried over as
numpy arrays, to both packages. Preintegration gets random samples from a
numpy seed.

Tolerances, and why:
  * preintegration, the built window, the in-step preintegrations: 1e-10
    relative to scale — the same formulas summed in another order over
    ~50 samples (tests/test_preintegration.py pins the JAX parallel form to
    its sequential one at 1e-10);
  * feature_reproj_errors and linearize_rows: tests/test_structured.py's
    (r atol 1e-9, J atol 1e-8 x scale);
  * marginalization priors: 1e-8 relative, compared in information form
    (J^T J, J^T r), since the rows of a QR factor carry arbitrary signs;
  * the step's solved state, errors and costs: 1e-8 relative — a 4-iteration
    LM solve whose accept decisions compare sums taken in another order
    (tests/test_torch_solver.py holds the solve at cost rtol 1e-8);
  * the replay: per-frame position within 1e-8 m and equal counts — every
    keyframe, gating and slide decision must come out the same;
  * a stale newest interval (a placeholder): frame 10's speed has no
    information and its step is a ratio of roundoffs in both packages, so
    the same tolerances hold only where that speed has not yet entered: one
    LM iteration without it, and the replay up to the stale frame. Beyond,
    the difference is printed, not held.
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
from cerberus_tpu.estimator import estimator as jest
from cerberus_tpu.estimator import packing as jpack
from cerberus_tpu.ops import factors as jfac
from cerberus_tpu.ops import preintegration as jpre
from cerberus_tpu.ops import structured as jstruct
from cerberus_tpu_torch import config as tC
from cerberus_tpu_torch.data.replay import replay as treplay
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.estimator import packing as tpack
from cerberus_tpu_torch.ops import factors as tfac
from cerberus_tpu_torch.ops import marginalize as tmarg
from cerberus_tpu_torch.ops import preintegration as tpre
from cerberus_tpu_torch.ops import structured as tstruct
from torch_port_util import assert_close, assert_rel, np_tree

KW = dict(max_features=48, max_num_iterations=4)
FRAMES = 14
ITERS = KW["max_num_iterations"]

_TYPES = {tfac.WindowState: jfac.WindowState, tfac.WindowData: jfac.WindowData,
          tpre.ILPreint: jpre.ILPreint}


def to_np(x):
    """Port tensors (in dicts, tuples, NamedTuples) -> numpy, same shape."""
    if torch.is_tensor(x):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [to_np(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def to_jax(x):
    """Port tensors -> JAX arrays, port NamedTuples -> the JAX package's."""
    if torch.is_tensor(x):
        return jnp.asarray(x.detach().numpy())
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [to_jax(v) for v in x]
        return _TYPES[type(x)](*vals) if type(x) in _TYPES else tuple(vals)
    return x


def assert_tree(name, got, want, tol):
    """Every leaf of got (port) within tol relative to scale of want (JAX);
    bool and int leaves equal."""
    g, w = np_tree(got), np_tree(want)
    assert g.keys() == w.keys(), (name, g.keys() ^ w.keys())
    for k in g:
        if w[k].dtype.kind in "bi":
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}.{k}")
        else:
            assert_rel(f"{name}.{k}", g[k], w[k], tol)


def assert_info_form(name, got, want, tol=1e-8):
    """Two priors (J, r) agree in information form: J^T J and J^T r."""
    (gJ, gr), (wJ, wr) = (np.asarray(a) for a in got), (np.asarray(a)
                                                         for a in want)
    for part, g, w in (("JtJ", gJ.T @ gJ, wJ.T @ wJ),
                       ("Jtr", gJ.T @ gr, wJ.T @ wr)):
        scale = float(np.abs(w).max())
        assert_close(f"{name}.{part}", g, w, tol, tol * max(scale, 1e-300))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops, which one intra-op
    thread runs faster than eight contending with the suite's other
    workers (a 14-frame replay: 11 s against 14 s alone, ~80 s under a
    6-worker suite). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    return simulate(SimConfig(duration=1.6, speed=0.5, seed=5))


@pytest.fixture(scope="module")
def port_run(sim):
    """The port's replay on the CPU, with the inputs of its first per-frame
    step recorded (and the merged interval-8+9 buffer of that moment, for
    the splice variants)."""
    rec = {}
    step = test._streaming_step

    def spy(*args, **kw):
        if "args" not in rec:
            est = rec["est"]
            rec["args"], rec["kw"] = args, kw
            rec["raw8"] = est._dev_raw(est._pad_buffer(
                test._merge_buffers(est.buffers[8], est.buffers[9])))
        return step(*args, **kw)

    est = test.Estimator(dataclasses.replace(tC.EstimatorConfig(), **KW),
                         device="cpu")
    rec["est"] = est
    rec["keyframes"] = []
    est.keyframe_callback = lambda *kf: rec["keyframes"].append(kf)
    test._streaming_step = spy
    try:
        out = treplay(sim, est=est, max_frames=FRAMES)
    finally:
        test._streaming_step = step
    return out, rec


@pytest.fixture(scope="module")
def step_inputs(port_run):
    """(st0, pres, ivalid, feats_pad, prior, free_mask, gravity, calib,
    raw9, raw8, params) of the recorded step: a live prior from the
    initialization's marginalization, interval 9 a placeholder that the
    step folds from raw9."""
    _, rec = port_run
    assert rec["kw"]["mode"] == "old"
    st0, pres, ivalid, feats, prior, fm, grav, calib, raw9, _, params = \
        rec["args"]
    return (st0, pres, ivalid, feats, prior, fm, grav, calib, raw9,
            rec["raw8"], params)


@pytest.fixture(scope="module")
def window(step_inputs):
    """The step's window built by the port without the fold: interval 9 a
    placeholder, the prior live. Returns (port state, port data, JAX state,
    JAX data)."""
    st0, pres, ivalid, feats, prior, fm, grav, calib, *_ = step_inputs
    ivalid = ivalid.clone()
    ivalid[9] = False
    data = tpack.build_window_data(pres, ivalid, feats, prior, fm, grav,
                                   calib, use_leg_odom=True, cov_jitter=1e-14,
                                   dtype=torch.float64)
    return st0, data, to_jax(st0), to_jax(data)


# ---------------------------------------------------------------- modules

def _preint_inputs(ct):
    rng = np.random.default_rng(11 + ct)
    S, n = 48, 35
    dt = np.zeros(S)
    dt[1:n] = 0.002 + rng.uniform(0, 1e-4, n - 1)
    acc = rng.normal(size=(S, 3)) * 0.3 + [0.0, 0.0, 9.8]
    gyr = rng.normal(size=(S, 3)) * 0.2
    phi = np.tile([0.0, 0.8, -1.6], 4) + rng.normal(size=(S, 12)) * 0.1
    dphi = rng.normal(size=(S, 12))
    c = (rng.uniform(0, 1, (S, 4)) if ct == 0
         else rng.uniform(0, 200, (S, 4)))
    mask = np.zeros(S, bool)
    mask[1:n] = True
    ba, bg = rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.01
    rho = np.full(4, 0.21) + rng.normal(size=4) * 1e-3
    ff = (rng.uniform(0, 10, 4), rng.uniform(100, 200, 4),
          rng.uniform(0, 200, (4, tC.FOOT_VAR_WINDOW_SIZE)),
          np.array([1, 2, 3, 4], np.int32))
    return (dt, acc, gyr, phi, dphi, c, mask, ba, bg, rho), ff


@pytest.mark.parametrize("ct", [0, 2])
def test_il_preintegrate_parallel(ct):
    """The log-depth form against the port's sequential form and the JAX
    package's log-depth form, contact models 0 and 2, with a foot-force
    tracker carried in."""
    args, ff = _preint_inputs(ct)
    cfg = dataclasses.replace(tC.EstimatorConfig(), contact_sensor_type=ct)
    tparams = tpre.PreintParams.from_config(cfg, device="cpu")
    targs = [torch.as_tensor(a) for a in args]
    tff = tuple(torch.as_tensor(a) for a in ff)
    par = tpre.il_preintegrate_parallel(*targs, tparams, ff_init=tff)
    seq = tpre.il_preintegrate(*targs, tparams, ff_init=tff)
    assert_tree(f"il_preintegrate_parallel[ct={ct}] vs sequential", par,
                seq, 1e-10)
    jparams = jpre.PreintParams.from_config(
        dataclasses.replace(jConfig(), contact_sensor_type=ct), jnp.float64)
    # the JAX estimator's own jitted il_preintegrate_parallel
    want = jest._preint_kernel(ct)(*[jnp.asarray(a) for a in args], jparams,
                                   tuple(jnp.asarray(a) for a in ff))
    assert_tree(f"il_preintegrate_parallel[ct={ct}] vs JAX", par, want, 1e-10)


@pytest.mark.parametrize("use_leg_odom", [True, False])
def test_build_window_data(step_inputs, use_leg_odom):
    """WindowData with a placeholder interval, a live marginalization prior
    and the calibration prior, every leaf."""
    st0, pres, ivalid, feats, prior, fm, grav, calib, *_ = step_inputs
    ivalid = ivalid.clone()
    ivalid[9] = False
    assert not bool(ivalid[9]) and bool(prior[3])
    assert float(prior[0].abs().max()) > 0
    got = tpack.build_window_data(pres, ivalid, feats, prior, fm, grav, calib,
                                  use_leg_odom=use_leg_odom,
                                  cov_jitter=1e-14, dtype=torch.float64)
    want = jpack.build_window_data(
        to_jax(pres), to_np(ivalid), to_np(feats), to_jax(prior), to_np(fm),
        to_np(grav), to_np(calib), use_leg_odom=use_leg_odom,
        cov_jitter=1e-14, dtype=jnp.float64)
    assert_tree(f"build_window_data[leg={use_leg_odom}]", got, want, 1e-10)


def test_feature_reproj_errors_and_linearize_rows(window):
    st, data, jst, jdata = window
    jkernels = jest._shared_kernels(ITERS)
    assert_close("feature_reproj_errors",
                 tfac.feature_reproj_errors(st, data).numpy(),
                 np.asarray(jkernels["reproj"](jst, jdata)), 0, 1e-9)
    r, J = tstruct.linearize_rows(st, data)
    jr, jJ = jax.jit(jstruct.linearize_rows)(jst, jdata)
    jJ = np.asarray(jJ)
    assert_close("linearize_rows.r", r.numpy(), np.asarray(jr), 0, 1e-9)
    assert_close("linearize_rows.J", J.numpy(), jJ, 0,
                 1e-8 * max(1.0, float(np.abs(jJ).max())))


def test_marginalize(window):
    """Both marginalizations of the window (live prior): the new prior in
    information form, and its validity."""
    st, data, jst, jdata = window
    jkernels = jest._shared_kernels(ITERS)   # jax.jit of jmarg's functions
    for name, tf, jf in (("marginalize_old", tmarg.marginalize_old,
                          jkernels["marg_old"]),
                         ("marginalize_second_new",
                          tmarg.marginalize_second_new,
                          jkernels["marg_new"])):
        J, r, valid = tf(st, data)
        jJ, jr, jvalid = jf(jst, jdata)
        assert bool(valid) == bool(jvalid), name
        assert_info_form(name, (J.numpy(), r.numpy()), (jJ, jr))


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("fold", [False, True], ids=["no-fold", "fold"])
@pytest.mark.parametrize("mode", ["old", "new", "none"])
def test_streaming_step(step_inputs, mode, fold):
    """One per-frame step against the JAX package's `_streaming_kernel` on
    identical inputs. fold: interval 9 preintegrated in the step from raw9
    (and, for new/none, the merged 8+9 splice from raw8); no-fold: interval
    9 preintegrated by the caller and passed in."""
    (st0, pres, ivalid, feats, prior, fm, grav, calib, raw9, raw8,
     params) = step_inputs
    assert bool(ivalid[9])
    if not fold:
        pre9 = test._fold_preint(raw9, pres, 9, st0.ba[9], st0.bg[9],
                                 st0.rho[9], params)
        pres = tuple(pres[:9]) + (pre9,)
    if mode == "none":
        prior = tpack.zero_prior(KW["max_features"], torch.float64,
                                 device="cpu")
    raw9 = raw9 if fold else None
    raw8 = raw8 if fold and mode != "old" else None
    got = test._streaming_step(
        st0, pres, ivalid, feats, prior, fm, grav, calib, raw9, raw8, params,
        max_iters=ITERS, mode=mode, use_leg_odom=True, marg_td_info=False)
    S9 = 0 if raw9 is None else raw9["dt"].shape[0]
    S8 = 0 if raw8 is None else raw8["dt"].shape[0]
    kernel = jest._streaming_kernel(ITERS, mode, True, False, 0, S9, S8)
    jparams = jpre.PreintParams.from_config(
        dataclasses.replace(jConfig(), **KW), jnp.float64)
    tic, qic, td, cw = to_np(calib)
    want = kernel(to_jax(st0), to_jax(pres), to_np(ivalid), to_np(feats),
                  to_jax(prior), to_np(fm), to_np(grav),
                  (tic, qic, float(td), cw), to_np(raw9), to_np(raw8),
                  jparams)
    assert got.keys() == want.keys()
    tag = f"step[{mode},{'fold' if fold else 'no-fold'}]"
    assert_tree(f"{tag}.st", got["st"], want["st"], 1e-8)
    assert_tree(f"{tag}.errs", got["errs"], want["errs"], 1e-8)
    assert int(got["info"].accepted) == int(want["info"].accepted)
    for k in ("cost0", "cost", "lam"):
        assert_rel(f"{tag}.info.{k}", getattr(got["info"], k).numpy(),
                   np.asarray(getattr(want["info"], k)), 1e-8)
    for k in ("pre9", "pre8m"):
        if k in want:
            assert_tree(f"{tag}.{k}", got[k], want[k], 1e-10)
    if "prior" in want:
        (J, r, lin, valid), (jJ, jr, jlin, jvalid) = got["prior"], \
            want["prior"]
        assert bool(valid) == bool(jvalid)
        assert_info_form(f"{tag}.prior", (J.numpy(), r.numpy()), (jJ, jr))
        assert_tree(f"{tag}.prior.lin", lin, jlin, 1e-8)


def test_streaming_step_placeholder_interval(step_inputs):
    """The step as the estimator dispatches it when the IMU of the newest
    interval is stale: interval 9 a placeholder (invalid, no raw9, no
    splice), so no factor touches frame 10's speed and biases.

    The gauge projection (ops/solver._project_gauge_blocks) mixes the yaw
    direction, whose speed rows are z x v_i, into frame 10's speed rows;
    with no information there they hold roundoff of the projected H and b,
    which the Jacobi scaling (floor 1e-8) lifts above lam. Frame 10's
    speed step is then a ratio of roundoffs in either package, and it
    differs between them (the first differing quantity, ~0.1 relative after
    one iteration). From the second iteration on, that speed enters the
    gauge basis and every state differs (~1e-4 relative after four), and
    so does the marginalization prior, which is projected with the same
    basis. So one LM iteration is held here: everything but frame 10's
    speed at the step's 1e-8, the same branch (accepted count, lam), and
    frame 10's speed finite. PERF.md, section 7, records the divergence."""
    (st0, pres, ivalid, feats, prior, fm, grav, calib, _, _, params) = \
        step_inputs
    ivalid = ivalid.clone()
    ivalid[9] = False
    got = test._streaming_step(
        st0, pres, ivalid, feats, prior, fm, grav, calib, None, None, params,
        max_iters=1, mode="old", use_leg_odom=True, marg_td_info=False)
    kernel = jest._streaming_kernel(1, "old", True, False, 0, 0, 0)
    jparams = jpre.PreintParams.from_config(
        dataclasses.replace(jConfig(), **KW), jnp.float64)
    tic, qic, td, cw = to_np(calib)
    want = kernel(to_jax(st0), to_jax(pres), to_np(ivalid), to_np(feats),
                  to_jax(prior), to_np(fm), to_np(grav),
                  (tic, qic, float(td), cw), None, None, jparams)
    tag = "step[old,placeholder]"
    v10 = got["st"].v[10]
    assert torch.isfinite(v10).all()
    print(f"PORT_DIFF {tag}.st.v[10] (not held) max_abs="
          f"{float(np.abs(v10.numpy() - np.asarray(want['st'].v[10])).max()):.3e}")
    free = lambda st: st._replace(v=st.v[:10])
    assert_tree(f"{tag}.st", free(got["st"]), free(want["st"]), 1e-8)
    assert_tree(f"{tag}.errs", got["errs"], want["errs"], 1e-8)
    assert int(got["info"].accepted) == int(want["info"].accepted)
    for k in ("cost0", "cost", "lam"):
        assert_rel(f"{tag}.info.{k}", getattr(got["info"], k).numpy(),
                   np.asarray(getattr(want["info"], k)), 1e-8)


# ----------------------------------------------------------- the replay

@pytest.fixture(scope="module")
def jax_run(sim):
    """The JAX package's replay of the same 14 frames, with the keyframes
    its estimator hands the loop back-end (keyframe_callback) recorded:
    (replay dict, keyframes)."""
    keyframes = []
    est = jest.Estimator(dataclasses.replace(jConfig(), **KW),
                         use_native=False)
    est.keyframe_callback = lambda *kf: keyframes.append(kf)
    return jreplay(sim, est=est, max_frames=FRAMES), keyframes


def test_replay_matches_jax(port_run, jax_run):
    """The short replay frame by frame: same frames published, positions
    within 1e-8 m, equal counts of solves, keyframes, reboots and
    dispatches. Two of its 14 frames are not keyframes, so both slides
    (MARGIN_OLD and MARGIN_SECOND_NEW with the 8+9 splice) run."""
    tout, _ = port_run
    jout, _ = jax_run
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    assert len(tout["est_t"]) >= 3
    assert_close("replay.est_p", tout["est_p"], jout["est_p"], 0, 1e-8)
    tstats, jstats = tout["estimator"].stats, jout["estimator"].stats
    for k in ("solves", "keyframes", "reboots", "dispatches"):
        assert tstats[k] == jstats[k], (k, tstats[k], jstats[k])
    assert tstats["solves"] >= 3
    assert tstats["keyframes"] < FRAMES
    assert_close("replay.ate_rmse", tout["ate_rmse"], jout["ate_rmse"], 0,
                 1e-8)


def test_keyframe_stream_matches_jax(port_run, jax_run):
    """The keyframes the estimator hands the loop back-end
    (keyframe_callback, on every MARGIN_OLD slide) in the short replay:
    the same keyframes, each with equal t, feature ids and which features
    carry a world point; p, q, the normalized observations and the world
    points within 1e-8."""
    _, rec = port_run
    got = rec["keyframes"]
    _, want = jax_run
    assert len(got) == len(want) >= 1
    worst = {"p": 0.0, "q": 0.0, "uv": 0.0, "world": 0.0}
    for (t1, p1, q1, ids1, obs1), (t2, p2, q2, ids2, obs2) in zip(got, want):
        assert t1 == t2 and list(ids1) == list(ids2)
        assert sorted(obs1) == sorted(obs2) == sorted(ids1)
        for name, a, b in (("p", p1, p2), ("q", q1, q2)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8, err_msg=name)
            worst[name] = max(worst[name], float(np.abs(a - b).max()))
        for fid in ids1:
            (uv1, w1), (uv2, w2) = obs1[fid], obs2[fid]
            assert (w1 is None) == (w2 is None), fid
            np.testing.assert_allclose(uv1, uv2, rtol=0, atol=1e-8)
            worst["uv"] = max(worst["uv"], float(np.abs(uv1 - uv2).max()))
            if w1 is not None:
                np.testing.assert_allclose(w1, w2, rtol=0, atol=1e-8)
                worst["world"] = max(worst["world"],
                                     float(np.abs(w1 - w2).max()))
    assert any(w is not None for kf in got for _, w in kf[4].values())
    print(f"PORT_DIFF keyframe_callback ({len(got)} keyframes, "
          f"{sum(len(kf[3]) for kf in got)} features) max_abs " + " ".join(
              f"{k}={v:.3e}" for k, v in worst.items()))


def test_replay_with_stale_imu(sim):
    """The short replay with the IMU hung (one sample repeated) over the
    interval that ends at camera frame 11, so that frame's step has a
    placeholder newest interval (test_streaming_step_placeholder_interval).
    Held: the same frames published, equal counts (one stale interval in
    each), positions within 1e-8 m up to the stale frame's own estimate.
    The next frame adopts the stale frame's step (pipelined adoption); from
    there on the positions carry the roundoff-driven frame-10 speed and are
    printed, not held (PERF.md, section 7)."""
    cams = [int(i) for i in sim["cam_idx"]]
    lo, hi = cams[10] + 1, cams[11]
    stale = dict(sim, acc=sim["acc"].copy(), gyr=sim["gyr"].copy())
    stale["acc"][lo:hi + 1] = sim["acc"][lo]
    stale["gyr"][lo:hi + 1] = sim["gyr"][lo]
    tout = treplay(stale, est=test.Estimator(
        dataclasses.replace(tC.EstimatorConfig(), **KW), device="cpu"),
        max_frames=FRAMES)
    jout = jreplay(stale, est=jest.Estimator(
        dataclasses.replace(jConfig(), **KW), use_native=False),
        max_frames=FRAMES)
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    tstats, jstats = tout["estimator"].stats, jout["estimator"].stats
    for k in ("solves", "keyframes", "reboots", "dispatches",
              "stale_imu_intervals"):
        assert tstats.get(k) == jstats.get(k), (k, tstats.get(k),
                                                jstats.get(k))
    assert tstats["stale_imu_intervals"] == 1
    before = np.asarray(tout["est_t"]) <= sim["t"][hi]
    assert before.any() and not before.all()
    tp, jp = np.asarray(tout["est_p"]), np.asarray(jout["est_p"])
    assert np.isfinite(tp).all()
    assert_close("replay[stale].est_p up to the stale frame", tp[before],
                 jp[before], 0, 1e-8)
    print("PORT_DIFF replay[stale].est_p per frame after the stale frame "
          "(not held): " + " ".join(
              f"{d:.3e}" for d in np.abs(tp - jp)[~before].max(axis=1)))
