#!/usr/bin/env python3
"""The JAX package's eleven diagnostics (`evals/diag_*.py`) on the CPU, f64,
at exactly the sizes of chip_smoke.py's `diagnostics` phase
(`chip_smoke.DIAG_SIZES`): the reference numbers its gates hold the port's
to (`chip_smoke.JAX_DIAGNOSTICS`).

    python3 tools/jax_diagnostics.py [--only diag_rho,diag_ex] \
        [--out build/jax_diagnostics]

Each script runs through its own knobs where it has them, executed as it
stands (`runpy`) with its duration argument (`diag_dropout`,
`diag_ekf_slip`, `diag_ekf_slip2`), `DIAG_DUR` / `DIAG_FRAMES`
(`diag_vision`, `diag_ex`) and `EKF_VARIANTS` (`diag_ekf_slip`); the
numbers are then read unrounded from the script's own variables, or from
what it passed to the JAX package's `Estimator`, `replay` and `score`
(recorded by wrappers). `diag_simcheck`, `diag_rho`, `diag_proj` and
`diag_obs` have no knob and run at their own size. `diag_tracker` and
`diag_loop` keep their work in `main`, which has no knob: their lines are
rebuilt here (cited) around the script's own `run_tracker` (its printed
line checked against the rebuilt numbers) and `DiagCloser`.
`DiagCloser._try_close` lacks the `seq_consistent` keyword that the JAX
package's `LoopCloser` passes it (the script stops with a TypeError at the
first verified candidate): a subclass here takes the keyword and calls
the script's override.

One JSON line per diagnostic, and one file each under `--out`; then
`--digest` prints `chip_smoke.JAX_DIAGNOSTICS` from those files (each
result's `chip_smoke.diag_digest`: the numbers the gates hold). JAX is
forced onto the CPU in f64. Times on an 8-core CPU in three processes
side by side (`--only diag_proj,diag_obs,diag_vision`,
`diag_ex,diag_dropout,diag_rho`, `diag_loop,diag_tracker,diag_simcheck`;
13 min in all): diag_proj 4.6 min, diag_obs 1.7, diag_vision 4.2 (on and
off), diag_ex 3.6, diag_dropout 7.3, diag_rho 1.6, diag_tracker 2.7,
diag_loop 10.0 (the JAX pose graph's 512-node optimize), the EKF pair 0.9,
diag_simcheck 2 s.
"""

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the JAX scripts point JAX's compilation cache outside the repo unless set
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      str(ROOT / "build" / "jax_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import runpy  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, str(ROOT))

import cerberus_tpu.data.replay as jreplay_mod  # noqa: E402
import cerberus_tpu.estimator.estimator as jest  # noqa: E402
from cerberus_tpu.config import EstimatorConfig  # noqa: E402
from cerberus_tpu.data import SimConfig, simulate  # noqa: E402
from cerberus_tpu.data.simulator import ImageRenderer  # noqa: E402
from cerberus_tpu_torch.evals import robustness as port_rb  # noqa: E402
import chip_smoke  # noqa: E402

SIZES = chip_smoke.DIAG_SIZES
EVALS = ROOT / "evals"


def plain(x):
    """JSON-able: arrays to lists, numpy scalars to Python's."""
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if hasattr(x, "shape"):   # a JAX array
        return plain(np.asarray(x))
    return x


@contextlib.contextmanager
def knobs(argv=(), env=None):
    """sys.argv[1:] = argv and the environment variables env, restored."""
    saved_argv, saved_env = sys.argv, {k: os.environ.get(k)
                                       for k in (env or {})}
    sys.argv = ["script", *argv]
    os.environ.update(env or {})
    try:
        yield
    finally:
        sys.argv = saved_argv
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_script(name, argv=(), env=None, as_main=False):
    """evals/<name>.py executed as it stands; returns its globals."""
    with knobs(argv, env):
        return runpy.run_path(str(EVALS / f"{name}.py"),
                              run_name="__main__" if as_main else name)


def import_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_evals_{name}",
                                                  EVALS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def recorded():
    """Every JAX Estimator made (watched: robustness.watch, as `.seen`) and
    every replay dict returned, while the block runs."""
    made, outs = [], []
    inner, replay = jest.Estimator, jreplay_mod.replay

    class Recorded(inner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen = port_rb.watch(self)
            made.append(self)

    def recorded_replay(*a, **kw):
        outs.append(replay(*a, **kw))
        return outs[-1]

    jest.Estimator, jreplay_mod.replay = Recorded, recorded_replay
    try:
        yield made, outs
    finally:
        jest.Estimator, jreplay_mod.replay = inner, replay


def diag_simcheck():
    g = run_script("diag_simcheck")
    sim, qmul, qrot = g["sim"], g["qmul"], g["qrot"]
    # diag_simcheck.py:46-69, the rows it prints, unrounded
    t, acc, gyr = sim["t"], sim["acc_true"], sim["gyr_true"]
    dt = t[1] - t[0]
    q, p, v = sim["q"][0].copy(), sim["p"][0].copy(), sim["v"][0].copy()
    rows = []
    for k in range(1, len(t)):
        th = 0.5 * (gyr[k - 1] + gyr[k]) * dt
        dq = np.concatenate([[1.0], th / 2])
        dq /= np.linalg.norm(dq)
        q_new = qmul(q, dq)
        q_new /= np.linalg.norm(q_new)
        a = 0.5 * ((qrot(q, acc[k - 1]) - sim["gravity"])
                   + (qrot(q_new, acc[k]) - sim["gravity"]))
        p = p + v * dt + 0.5 * a * dt * dt
        v = v + a * dt
        q = q_new
        if k % 500 == 0:
            rows.append(dict(
                t=t[k], p_err=np.linalg.norm(p - sim["p"][k]),
                v_err=np.linalg.norm(v - sim["v"][k]),
                q_err=min(np.linalg.norm(q - sim["q"][k]),
                          np.linalg.norm(q + sim["q"][k]))))
    errs = g["errs"]
    return dict(dead_reckoning=rows, max_q_err=g["max_qerr"],
                leg_odom_vel_err=dict(
                    med=np.median(errs), p90=np.percentile(errs, 90),
                    max=errs.max(), n=len(errs)))


def diag_rho():
    g = run_script("diag_rho")
    C, p0, fd, sim = g["C"], g["p0"], g["fd"], g["sim"]
    J = np.asarray(p0.J)
    st, info, truth = g["st"], g["info"], g["truth"]
    rho5 = np.asarray(st.rho[5])
    return dict(
        fd_check=dict(
            J_col=[J[C.ILO_EPS + 3 * j:C.ILO_EPS + 3 * j + 3, C.ILO_RHO + j]
                   for j in range(4)],
            fd=fd, deps_nom=np.asarray(p0.deps),
            deps_true=np.asarray(g["preint_at"](g["TRUE_LEN"]).deps),
            truth=sim["R"][g["s"]].T @ g["ktrue"]),
        window_solve=dict(
            cost0=float(info.cost0), cost=float(info.cost),
            accepted=int(info.accepted), rho_frame5=rho5,
            rho_err_mm=(rho5 - g["TRUE_LEN"]) * 1000,
            pos_err=np.linalg.norm(np.asarray(st.p) - np.asarray(truth.p),
                                   axis=1)))


def _final_window(g):
    """diag_proj.py:80-103's numbers from its globals."""
    est, slots, per_feat = g["est"], g["slots"], g["per_feat"]
    starts, order = g["starts"], g["order"]
    return dict(
        total=per_feat.sum(), n_features=len(slots),
        worst=[dict(slot=slots[n], cost=per_feat[n], start=starts[n],
                    nobs=g["obs_counts"][n], d_est=est.fm.depth[slots[n]],
                    d_tru=g["d_true"][n]) for n in order[:12]],
        anchors={sf: dict(n=(starts == sf).sum(),
                          cost_sum=per_feat[starts == sf].sum())
                 for sf in range(11) if (starts == sf).sum()},
        rms_mono_px=g["rms_mono"], rms_stereo_px=g["rms_st"],
        per_feature=per_feat)


def diag_proj():
    g = run_script("diag_proj")
    n_rows = int(g["n_rows"])
    return dict(perfect_assoc=dict(
        cost=g["cost"], n_rows=n_rows,
        # diag_proj.py:35: sqrt(sum r^2 / n_rows) * 1.5, sum r^2 = 2 cost
        rms_px=np.sqrt(2 * g["cost"] / max(n_rows, 1)) * 1.5),
        final_window=_final_window(g), _p=np.asarray(g["est"].p))


def diag_obs():
    g = run_script("diag_obs")
    est = g["est"]
    return dict(checked=g["tot"], bad=g["bad"],
                headers=list(est.headers), frames_fed=g["n_frames"],
                keyframes=est.stats["keyframes"], _p=np.asarray(est.p))


def diag_vision():
    env = {k: SIZES["diag_vision"][k] for k in ("DIAG_DUR", "DIAG_FRAMES")}
    g = run_script("diag_vision", env=env, as_main=True)
    (ce, be), (ct, bt) = (g["ce"], g["be"]), (g["ct"], g["bt"])
    return dict(vision_on=g["recs"], vision_off=g["recs2"],
                cost_est=dict(cost=ce, ileg=be[0], proj=be[1], prior=be[2]),
                cost_tru=dict(cost=ct, ileg=bt[0], proj=bt[1], prior=bt[2]),
                _p=np.asarray(g["est"].p))


def diag_ex():
    env = {k: SIZES["diag_ex"][k] for k in ("DIAG_DUR", "DIAG_FRAMES")}
    with recorded() as (made, outs):
        run_script("diag_ex", env=env)
    res = {}
    # diag_ex.py:40-53, unrounded
    for (est_ex, vision), est, out in zip(
            ((True, True), (False, True), (True, False)), made, outs):
        ric, tic = est.cfg.ric_tic()
        d = est.fm.depth[est.fm.active & (est.fm.depth > 0)]
        res[f"ex={est_ex},vision={vision}"] = dict(
            ate=out["ate_rmse"], drift_pct=out["drift_pct"],
            dist=out["distance"], dtic=np.linalg.norm(est.tic - tic, axis=1),
            dang_deg=[np.degrees(np.arccos(np.clip(
                (np.trace(jest._quat_to_rot_np(est.qic[i]) @ ric[i].T) - 1)
                / 2, -1, 1))) for i in range(2)],
            inv_depths=dict(med=np.median(d), min=d.min(), max=d.max(),
                            n=len(d)) if len(d) else None,
            keyframes=est.stats["keyframes"], solves=est.stats["solves"])
    return res


def diag_dropout():
    dur = SIZES["diag_dropout"]["duration"]
    with recorded() as (made, outs):
        g = run_script("diag_dropout", argv=[str(dur)])
    (est,), (out,) = made, outs
    assert g["dtype"] == g["jnp"].float64
    # diag_dropout.py:39-47, unrounded
    t, err = g["t"], g["err"]
    around = {}
    for t0 in (dur * 0.3, dur * 0.7):
        sel = (t > t0 - 2) & (t < t0 + 4)
        around[t0] = list(zip(t[sel][::3], err[sel][::3]))
    seen = est.seen
    res = dict(drift_pct=out["drift_pct"], ate=out["ate_rmse"],
               reboots=est.stats["reboots"],
               stale_intervals=est.stats.get("stale_imu_intervals"),
               failure_reasons=est.stats.get("failure_reasons", []),
               err_around=around,
               final_errs=list(zip(t[-30::5], err[-30::5])),
               frames=len(t), solves=est.stats["solves"],
               solves_all=seen["all"] + est.stats["solves"],
               placeholder_at=seen["placeholder_at"])
    if seen["placeholder_at"] is not None:
        res["before_placeholder"] = port_rb.before_placeholder(
            out, seen["placeholder_at"])
    return res


@contextlib.contextmanager
def recorded_scores():
    scores = []
    score = jreplay_mod.score

    def recorded_score(*a, **kw):
        scores.append(score(*a, **kw))
        return scores[-1]

    jreplay_mod.score = recorded_score
    try:
        yield scores
    finally:
        jreplay_mod.score = score


def diag_ekf_slip():
    size = SIZES["diag_ekf_slip"]
    with recorded_scores() as scores:
        g = run_script("diag_ekf_slip", argv=[str(size["duration"])],
                       env={"EKF_VARIANTS": size["EKF_VARIANTS"]})
    (name, _, _), = g["variants"]
    s, c = scores
    return {"samples": len(g["sim_slip"]["t"]),
            name: dict(slip=s, clean=c)}


def diag_ekf_slip2():
    size = SIZES["diag_ekf_slip2"]
    with recorded_scores() as scores:
        g = run_script("diag_ekf_slip2", argv=[str(size["duration"])])
    # diag_ekf_slip2.py:45-58: fw outer, vn inner, two runs each
    names = [f"fw{fw:g}_vn{vn:g}" for fw in (1e-4, 1e-3, 3e-3)
             for vn in (5e-2, 0.1)]
    i = names.index(size["variant"])
    return {"samples": len(g["sim_slip"]["t"]),
            size["variant"]: dict(slip=scores[2 * i],
                                  clean=scores[2 * i + 1])}


class RecordingTracker:
    """A tracker whose every `track` output is kept."""

    def __init__(self, tracker):
        self.tracker, self.outs = tracker, []

    def track(self, *a):
        self.outs.append(self.tracker.track(*a))
        return self.outs[-1]


def tracker_numbers(sim, r, outs, f, cx, cy):
    """diag_tracker.py:41-72 on recorded outputs, unrounded."""
    script = import_script("diag_tracker")
    birth, errs, lens, counts = {}, [], {}, []
    for i, out in enumerate(outs):
        counts.append(len(out))
        truth = script.ideal_px(sim, r, i)
        tp = np.array([truth[j] for j in truth]) if truth else \
            np.zeros((0, 2))
        tids = list(truth)
        for fid, (pt, vel, ptr, velr) in out.items():
            px = np.array([f * pt[0] + cx, f * pt[1] + cy])
            if fid not in birth:
                if len(tp) == 0:
                    continue
                d = np.linalg.norm(tp - px, axis=1)
                j = int(np.argmin(d))
                if d[j] < 3.0:
                    birth[fid] = tids[j]
                continue
            if birth[fid] in truth:
                errs.append(float(np.linalg.norm(truth[birth[fid]] - px)))
                lens[fid] = lens.get(fid, 0) + 1
    errs = np.array(errs) if errs else np.array([np.nan])
    ln = np.array(list(lens.values())) if lens else np.array([0])
    return dict(n_feat_p50=np.percentile(counts, 50),
                err_p50=np.nanpercentile(errs, 50),
                err_p90=np.nanpercentile(errs, 90),
                len_p50=np.percentile(ln, 50), counts=counts,
                n_errs=int(np.isfinite(errs).sum()), births=len(birth))


def diag_tracker():
    from cerberus_tpu.frontend.device_tracker import DeviceTracker
    from cerberus_tpu.frontend.tracker import FeatureTracker, PinholeCamera

    script = import_script("diag_tracker")
    # diag_tracker.py:84-96
    cfg = EstimatorConfig()
    sim = simulate(SimConfig(duration=8.0, speed=0.75, path="street",
                             seed=77), est_cfg=cfg)
    r = ImageRenderer(sim, cfg)
    n_frames = min(len(sim["cam_t"]), SIZES["diag_tracker"]["max_frames"])
    cams = [PinholeCamera(r.f, r.f, r.cx, r.cy, size=(r.W, r.H))
            for _ in range(2)]
    trackers = {
        "cv": FeatureTracker(cams[0], cams[1], max_cnt=cfg.max_cnt,
                             min_dist=cfg.min_dist, flow_back=cfg.flow_back),
        "device": DeviceTracker(cams[0], cams[1], max_cnt=cfg.max_cnt,
                                min_dist=cfg.min_dist,
                                flow_back=cfg.flow_back)}
    res = dict(frames=n_frames)
    for name, tr in trackers.items():
        rec = RecordingTracker(tr)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            script.run_tracker(f"{name:6s}", rec, sim, r, n_frames, r.f,
                               r.cx, r.cy)
        print(text.getvalue(), end="")
        nums = tracker_numbers(sim, r, rec.outs, r.f, r.cx, r.cy)
        line = (f"{name:6s}: n_feat p50 {nums['n_feat_p50']:.0f}  "
                f"track-err px p50 {nums['err_p50']:.3f} "
                f"p90 {nums['err_p90']:.3f}  "
                f"track len p50 {nums['len_p50']:.0f}")
        assert text.getvalue().strip() == line.strip(), (text.getvalue(),
                                                         line)
        res[name] = nums
    return res


def diag_loop():
    script = import_script("diag_loop")

    class DiagCloser(script.DiagCloser):
        def _try_close(self, old_idx, rec, sim=1.0, seq_consistent=False):
            script.DiagCloser._try_close(self, old_idx, rec, sim=sim)

    size = SIZES["diag_loop"]
    # diag_loop.py:73-107 at the phase's stream
    cfg = EstimatorConfig()
    sim = simulate(SimConfig(duration=size["duration"], speed=size["speed"],
                             path=size["path"], seed=size["seed"]),
                   est_cfg=cfg)
    r = ImageRenderer(sim, cfg)
    closer = DiagCloser(cfg, focal=r.f, cx=r.cx, cy=r.cy)
    lm = sim["landmarks"]
    t0 = time.time()
    n_kf = 0
    for i, tc in enumerate(sim["cam_t"]):
        k = int(sim["cam_idx"][i])
        feats = sim["features"][i]
        obs = {int(f): (np.asarray(o0[:2]), lm[int(f)])
               for f, (o0, v0, o1, v1) in feats.items()}
        img0, _ = r.render_stereo(k)
        if closer.add_keyframe(float(tc), sim["p"][k], sim["q"][k],
                               sorted(obs), obs, img0) >= 0:
            n_kf += 1
    closer.finish()
    st = dict(closer.st)
    mc = np.array(st.pop("match_counts") or [0])
    wc = np.array(st.pop("world_counts") or [0])
    pe = np.array(st.pop("pnp_err") or [np.nan])
    return dict(keyframes=n_kf, skipped=closer.kf_skipped, **st,
                match_p50=np.percentile(mc, 50),
                match_p90=np.percentile(mc, 90),
                world_p50=np.percentile(wc, 50),
                world_p90=np.percentile(wc, 90),
                min_matches=closer.min_matches,
                loops_found=closer.loops_found, best_sim=closer.best_sim,
                pnp_err_p50=np.nanmedian(pe),
                n_loop_edges=closer.pg.n_loop_edges,
                wall_s=time.time() - t0)


DIAGNOSTICS = {f.__name__: f for f in (
    diag_simcheck, diag_rho, diag_proj, diag_obs, diag_vision, diag_ex,
    diag_dropout, diag_ekf_slip, diag_ekf_slip2, diag_tracker, diag_loop)}


def print_digests(out):
    """chip_smoke.JAX_DIAGNOSTICS from the results under `out`: each
    diagnostic's chip_smoke.diag_digest."""
    print("JAX_DIAGNOSTICS = {")
    for name in DIAGNOSTICS:
        d = chip_smoke.diag_digest(
            name, json.loads((out / f"{name}.json").read_text()))
        print(f"    {name!r}: {d!r},")
    print("}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(DIAGNOSTICS))
    ap.add_argument("--out", default=str(ROOT / "build" / "jax_diagnostics"))
    ap.add_argument("--digest", action="store_true",
                    help="only print chip_smoke.JAX_DIAGNOSTICS from the "
                         "results already under --out")
    args = ap.parse_args()
    out = Path(args.out)
    if args.digest:
        print_digests(out)
        return
    out.mkdir(parents=True, exist_ok=True)
    ps = {}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        res = plain(DIAGNOSTICS[name]())
        assert jax.devices()[0].platform == "cpu"
        if "_p" in res:   # the estimator's final positions
            ps[name] = np.asarray(res.pop("_p"))
        res["wall_s"] = time.perf_counter() - t0
        (out / f"{name}.json").write_text(json.dumps(res, indent=1))
        print(json.dumps({"diagnostic": name, **res}), flush=True)
    # diag_proj, diag_obs and diag_vision's vision-on run are one feed
    # (diag_vision's with the estimator's debug on): the same estimate
    for a in ps:
        for b in ps:
            assert np.array_equal(ps[a], ps[b]), (a, b)


if __name__ == "__main__":
    main()
