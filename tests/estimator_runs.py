"""Shared helpers of the tests that hold whole estimator runs of the port
(cerberus_tpu_torch) against the JAX package on the CPU: both packages'
estimators driven through their entry points on the same input, with what
the comparison needs recorded on the way.

A step whose newest interval is a placeholder (invalid: a stale IMU, or an
interval closed with no samples) leaves frame 10's speed without
information; that step's outcome is roundoff in either package
(tests/test_torch_streaming.py::test_streaming_step_placeholder_interval),
so a run is held to the JAX package only up to the first adoption of such
a step (`placeholder_at`)."""

import contextlib
import dataclasses

import numpy as np

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig as jSimConfig
from cerberus_tpu.data import simulate as jsimulate
from cerberus_tpu.data.replay import replay as jreplay
from cerberus_tpu.estimator import estimator as jest
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data.replay import replay as treplay
from cerberus_tpu_torch.estimator import estimator as test
from cerberus_tpu_torch.evals import robustness as rb
from torch_port_util import assert_close

COUNTS = ("solves", "keyframes", "reboots", "dispatches", "deferred_frames",
          "stalled_frames", "stale_imu_intervals")


@contextlib.contextmanager
def placeholder_steps():
    """Mark every per-frame step, in either package, whose newest interval
    is a placeholder amid valid ones (ivalid[9] False, some of ivalid[:9]
    True; without the IMU every interval is invalid and no speed is
    estimated); yields the set of the marked steps' output ids."""
    marked = set()
    step, kernel = test._streaming_step, jest._streaming_kernel

    def placeholder(ivalid):
        ivalid = np.asarray(ivalid)
        return not ivalid[9] and ivalid[:9].any()

    def port_step(*a, **kw):
        out = step(*a, **kw)
        if placeholder(a[2]):
            marked.add(id(out))
        return out

    def jax_kernel(*key):
        f = kernel(*key)

        def call(*a):
            out = f(*a)
            if placeholder(a[2]):
                marked.add(id(out))
            return out
        return call

    test._streaming_step, jest._streaming_kernel = port_step, jax_kernel
    try:
        yield marked
    finally:
        test._streaming_step, jest._streaming_kernel = step, kernel


def record(est, marked):
    """Record est's running td after every camera frame (`td`: (t, td)
    pairs) and the newest sample time when est first adopts a marked step
    (`placeholder_at`, inf if never)."""
    rec = {"td": [], "placeholder_at": np.inf}
    image, finish = est.input_image, est._finish_pending

    def input_image(t, feats):
        image(t, feats)
        rec["td"].append((t, est.td))

    def finish_pending():
        pend = est._pending
        if pend is not None and id(pend["out"]) in marked \
                and rec["placeholder_at"] == np.inf:
            rec["placeholder_at"] = est.sync.latest_time()
        finish()

    est.input_image, est._finish_pending = input_image, finish_pending
    return rec


def run_both(sims, cfgs, switches=(), jax_estimator=None):
    """The JAX package's and the port's estimator, each on its sim and
    config (dicts keyed "jax", "port"), with `switches`
    (robustness.drive); jax_estimator: the JAX package's Estimator or a
    subclass of it. Returns {"jax": (replay dict, record), "port":
    (...)}."""
    jcls = jax_estimator or jest.Estimator
    out = {}
    with placeholder_steps() as marked:
        for name, make, replay_fn in (
                ("jax", lambda c: jcls(c, use_native=False), jreplay),
                ("port", lambda c: test.Estimator(c, device="cpu"),
                 treplay)):
            est = make(cfgs[name])
            rec = record(est, marked)
            out[name] = (rb.drive(est, sims[name], switches, replay_fn), rec)
    return out


def configs(kw):
    """Both packages' EstimatorConfig(**kw)."""
    return {"jax": dataclasses.replace(jConfig(), **kw),
            "port": dataclasses.replace(tConfig(), **kw)}


def branch_both(name, duration, kw):
    """run_both on robustness.branch_inputs(name, duration): each package
    simulates the branch's input and gets the branch's config from its own
    EstimatorConfig(**kw)."""
    base = configs(kw)
    jcfg, jsim, switches = rb.branch_inputs(name, duration, base["jax"],
                                            jSimConfig, jsimulate)
    tcfg, tsim, _ = rb.branch_inputs(name, duration, base["port"])
    return run_both({"jax": jsim, "port": tsim},
                    {"jax": jcfg, "port": tcfg}, switches)


def assert_runs_match(tag, runs, tol=1e-8, td_tol=1e-10, hold_all=False):
    """The port's run against JAX's: the same frames published, equal
    counts, failure_reasons and final sensor set; positions within tol m
    and the running td within td_tol s for every frame fed before either
    package adopted a placeholder step (every frame if hold_all: then
    there must be none); beyond it the difference is printed, not held.
    Returns (frames published, frames held)."""
    (jout, jrec), (tout, trec) = runs["jax"], runs["port"]
    np.testing.assert_array_equal(tout["est_t"], jout["est_t"])
    test_, jest_ = tout["estimator"], jout["estimator"]
    for k in COUNTS:
        assert test_.stats.get(k, 0) == jest_.stats.get(k, 0), \
            (k, test_.stats.get(k), jest_.stats.get(k))
    assert test_.stats.get("failure_reasons", []) == \
        jest_.stats.get("failure_reasons", [])
    for k in ("use_imu", "stereo"):
        assert getattr(test_.cfg, k) == getattr(jest_.cfg, k), k
    assert test_.solver_flag == jest_.solver_flag
    cut = min(jrec["placeholder_at"], trec["placeholder_at"])
    if hold_all:
        assert cut == np.inf, f"{tag}: a placeholder step adopted at {cut}"
    t = np.asarray(tout["est_t"])
    n = int(np.sum(t < cut))
    assert (t[:n] < cut).all()
    tp, jp = np.asarray(tout["est_p"]), np.asarray(jout["est_p"])
    assert np.isfinite(tp).all()
    if n:
        assert_close(f"{tag}.est_p ({n} of {len(t)} frames)", tp[:n],
                     jp[:n], 0, tol)
    assert [t for t, _ in trec["td"]] == [t for t, _ in jrec["td"]]
    td = np.array([[a[1], b[1]] for a, b in zip(trec["td"], jrec["td"])
                   if a[0] < cut])
    if len(td):
        assert_close(f"{tag}.td ({len(td)} frames)", td[:, 0], td[:, 1], 0,
                     td_tol)
    if n < len(t):
        print(f"PORT_DIFF {tag}.est_p after the placeholder step adopted "
              f"at t = {cut:.3f} s (not held): " + " ".join(
                  f"{d:.3e}" for d in np.abs(tp - jp)[n:].max(axis=1)))
    return len(t), n
