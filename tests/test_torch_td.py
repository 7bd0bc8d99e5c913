"""The estimator with its camera-IMU time offset td estimated, and its
failure detection and reboot, in the port against the JAX package, f64 on
the CPU, max_features = 48 and max_num_iterations = 4.

td. The JAX package's own estimator drops a newest IMU interval whenever a
solve raises the running td between a frame's deferral and its processing
(test_jax_drops_the_newest_interval_when_td_grows): the frame waits in
input_image until the IMU stream reaches t + td, is processed from that
sample's input_imu_leg, adopts the previous frame's step on entry — with a
larger td — and then closes its interval at t + td_new, beyond the newest
sample: the sensor sync returns nothing, the interval is empty, and the
samples in it are skipped. The step on that frame has a placeholder newest
interval, so frame 10's speed has no information and the step's outcome is
roundoff, in either package (test_torch_streaming.py's placeholder test):
the Cholesky of the damped Schur complement fails (NaN) at a small lambda
in one package and not in the other, and the accept decisions part. The
port follows the JAX package here as it does for a stale IMU
(ROADMAP.md, Queue 3), so a run is held only up to the adoption of the
first such step:

  * td = 0, estimated (`test_td_stays_near_zero_without_offset`'s
    setting), simulate(SimConfig(duration=1.3, speed=0.5, seed=43)): the
    frames before that adoption (0.660-0.858 s), positions within 1e-8 m
    and td within 1e-10 s; the rest printed;
  * td = -20 ms, estimated (the battery's `td_init_-20ms`), 2.0 s: td
    falls toward 0 and never grows at a deferral, so no interval is
    dropped and the whole run is held, every frame.

Reboot: robustness.branch_inputs("reboot", 2.0): a 0.05 s gyro spike of
40 rad/s about z at 1.0 s (seed 43) turns the dead-reckoned yaw 115 deg;
failure_detection's 50 deg check fires in the JAX package (one reboot,
fixed from its run alone: a 20 rad/s spike at 1.5 s of a full-width 3 s
run did not reboot it) and the estimator restarts with `_rebase_world`'s
pose continuity. Held: the same frames published, equal
counts and failure_reasons, positions within 1e-8 m.

Tolerances: 1e-8 m and 1e-10 s, as test_torch_streaming.py's replay (the
packages' steps agree to ~1e-13 on equal inputs).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu.estimator import estimator as jest
from estimator_runs import (assert_runs_match, branch_both, configs,
                            run_both)

KW = dict(max_features=48, max_num_iterations=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    return simulate(SimConfig(duration=1.3, speed=0.5, seed=43))


@pytest.fixture(scope="module")
def td0(sim):
    """td = 0 estimated over 1.3 s in both packages; the JAX estimator also
    records each interval it closes and the running td at each frame's
    arrival. Returns (run_both's dict, closes, queued)."""
    closes, queued = [], {}

    class Watched(jest.Estimator):
        def input_image(self, t, feats):
            queued[t] = self.td
            super().input_image(t, feats)

        def _close_interval(self, k, t_img, defer_preint=False):
            prev, latest = self.prev_img_t, self.sync.latest_time()
            super()._close_interval(k, t_img, defer_preint)
            closes.append(dict(k=k, t_img=t_img, prev=prev, latest=latest,
                               n=len(self.buffers[k]), td=self.td))

    runs = run_both({"jax": sim, "port": sim},
                    configs(dict(KW, td=0.0, estimate_td=True)),
                    jax_estimator=Watched)
    return runs, closes, queued


def test_jax_drops_the_newest_interval_when_td_grows(sim, td0):
    """The JAX package's estimator alone, td = 0 estimated over 1.3 s: one
    frame's newest interval closes with no sample although the IMU stream
    covers it, right after its deferral ended and a solve raised the
    running td; the step on that frame gets a placeholder interval 9."""
    runs, closes, queued = td0
    rec = runs["jax"][1]
    empty = [c for c in closes if c["n"] == 0]
    assert len(empty) == 1, empty
    c = empty[0]
    frame_t = c["t_img"] - c["td"]
    # the IMU stream held samples in the interval, but had not reached
    # its end: the interval was closed beyond the newest sample
    inside = (sim["t"] > c["prev"]) & (sim["t"] <= c["t_img"])
    assert inside.sum() >= 30 and c["latest"] < c["t_img"]
    # the frame had been deferred under a smaller td, which grew since
    t_q = min(queued, key=lambda t: abs(t - frame_t))
    assert abs(t_q - frame_t) < 1e-9
    assert queued[t_q] < c["td"] and c["td"] > 0
    # its step's newest interval is a placeholder, adopted next
    assert rec["placeholder_at"] < np.inf
    print(f"JAX dropped interval: frame {frame_t:.3f} s queued at td "
          f"{queued[t_q]:.3e} s, closed at td {c['td']:.3e} s with "
          f"{int(inside.sum())} samples skipped; placeholder step adopted "
          f"at {rec['placeholder_at']:.3f} s")


@pytest.mark.parametrize("td0_ms", [0, -20], ids=["td0", "td-20ms"])
def test_td_estimation_follows_jax(td0, td0_ms):
    if td0_ms == 0:
        runs, hold_all = td0[0], False
    else:
        s = simulate(SimConfig(duration=2.0, speed=0.5, seed=43))
        runs, hold_all = run_both({"jax": s, "port": s}, configs(
            dict(KW, td=td0_ms * 1e-3, estimate_td=True))), True
    n, held = assert_runs_match(f"td[{td0_ms} ms]", runs, hold_all=hold_all)
    assert held >= 4 and n >= held
    for name, (out, rec) in runs.items():
        assert out["estimator"].stats["solves"] >= 4
        assert rec["td"][-1][1] != td0_ms * 1e-3   # td moved
    if hold_all:
        (tout, trec), (jout, jrec) = runs["port"], runs["jax"]
        assert abs(trec["td"][-1][1]) < abs(td0_ms * 1e-3)
        np.testing.assert_allclose(tout["ate_rmse"], jout["ate_rmse"],
                                   rtol=1e-8)


def test_reboot_follows_jax():
    runs = branch_both("reboot", 2.0, KW)
    jest_ = runs["jax"][0]["estimator"]
    assert jest_.stats["reboots"] >= 1
    assert all("rotation jump" in r for _, r in
               jest_.stats["failure_reasons"])
    n, held = assert_runs_match("reboot", runs, hold_all=True)
    assert n == held >= 5
