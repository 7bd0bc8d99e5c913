"""The port's robustness battery (cerberus_tpu_torch/evals/robustness.py)
against the JAX repo's evals/robustness.py on the CPU, f64, with the
default EstimatorConfig cut to max_features = 32, max_num_iterations = 4
in both drivers (their EstimatorConfig swapped for the test).

  * the helpers (_rot, perturb_extrinsics, scale_noise, imu_dropout,
    corrupt_contacts): exact on the same simulated arrays and configs,
    the 10 contact bursts drawn from one default_rng(77) as the JAX
    driver draws them;
  * `--cases td_init_+20ms,imu_dropout_2x1s --duration 2.5` through both
    drivers' main: the same keys in every entry; equal solves, reboots
    and stale IMU intervals; and each run held as tests/estimator_runs.py
    holds a run: the frames published before either package adopts a
    step with a placeholder newest interval within 1e-8 m and their
    running td within 1e-10 s, and the driver's own record of that step
    (robustness.watch) where the spies put it. `td_init_+20ms` drops an
    interval when its td grows (tests/test_torch_td.py, which also holds a
    whole -20 ms run) and `imu_dropout_2x1s` hangs the IMU: beyond their
    first placeholder step both packages' answers are roundoff (drift
    13.9 % against 2.2 % in this run), so the distance is held within 1e-8
    relative, drift and ATE of the frames before that step within 1e-8
    relative (the driver's `before_placeholder`), and the whole run's
    printed;
  * `imu_dropout_2x1s` is the port's diag_dropout run (the same
    simulation, windows, config and watch): diag_dropout's `summary` of the
    port's run against the JAX script's lines on JAX's, held before the
    first placeholder step (counts, failure reasons, the error trace within
    1e-8 m, the scores before that step within 1e-8 relative);
  * without a card the driver refuses `--device cuda`.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import cerberus_tpu.config as jconfig
import cerberus_tpu.data.replay as jreplay_mod
import cerberus_tpu.estimator.estimator as jest_mod
from cerberus_tpu.data import SimConfig, simulate
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.evals import diag_dropout
from cerberus_tpu_torch.evals import robustness as rb
from estimator_runs import assert_runs_match, placeholder_steps, record
from torch_port_util import assert_close, assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_features=32, max_num_iterations=4)
CASES = ("td_init_+20ms", "imu_dropout_2x1s")
ARGV = ["--cases", ",".join(CASES), "--duration", "2.5"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_robustness():
    spec = importlib.util.spec_from_file_location(
        "jax_evals_robustness", os.path.join(ROOT, "evals", "robustness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_helpers_match_jax():
    jr = _jax_robustness()
    sim = simulate(SimConfig(duration=2.5, speed=0.5, path="street",
                             seed=31))
    np.testing.assert_array_equal(rb._rot([1.0, 2.0, 3.0], 0.3),
                                  jr._rot([1.0, 2.0, 3.0], 0.3))
    jcfg, tcfg = jconfig.EstimatorConfig(), tConfig()
    for deg in (1.0, 3.0):
        got, want = rb.perturb_extrinsics(tcfg, deg), \
            jr.perturb_extrinsics(jcfg, deg)
        for k in ("body_T_cam0", "body_T_cam1"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert got.estimate_extrinsic and want.estimate_extrinsic
    for f in (0.25, 4.0):
        got, want = rb.scale_noise(tcfg, f).noise, jr.scale_noise(jcfg,
                                                                  f).noise
        for k in ("acc_n", "acc_n_z", "gyr_n", "acc_w", "gyr_w",
                  "joint_angle_n", "joint_velocity_n", "leg_bias_c_n"):
            assert getattr(got, k) == getattr(want, k), k
    windows = [(0.75, 1.75), (1.75, 2.75)]
    got, want = rb.imu_dropout(sim, windows), jr.imu_dropout(sim, windows)
    for k in ("acc", "gyr"):
        np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(got["acc"], sim["acc"])
    # the battery's contact_corruption case draws its bursts when it runs,
    # from the driver's one default_rng(77)
    case = {c["name"]: c for c in rb.make_cases(2.5)}["contact_corruption"]
    got = case["sim_fn"](sim)["contacts"]
    want = jr.corrupt_contacts(sim, np.random.default_rng(77))["contacts"]
    np.testing.assert_array_equal(got, want)
    flipped = np.abs(got - sim["contacts"]).sum()
    assert flipped > 0
    print(f"PORT_DIFF robustness helpers: equal (exact); contact bursts "
          f"flip {int(flipped)} flags")


def test_battery_matches_jax(monkeypatch, tmp_path):
    jcls = jconfig.EstimatorConfig
    monkeypatch.setattr(jconfig, "EstimatorConfig",
                        lambda **kw: jcls(**{**KW, **kw}))
    monkeypatch.setattr(rb, "EstimatorConfig",
                        lambda **kw: tConfig(**{**KW, **kw}))
    runs = {"jax": [], "port": []}
    outs = {"jax": [], "port": []}

    with placeholder_steps() as marked:
        def recorded(cls, name):
            class Recorded(cls):
                def __init__(self, *a, **kw):
                    if name == "jax":
                        kw["use_native"] = False
                    super().__init__(*a, **kw)
                    runs[name].append(record(self, marked))
            return Recorded

        def replayed(fn, name):
            def run(*a, **kw):
                outs[name].append(fn(*a, **kw))
                return outs[name][-1]
            return run

        monkeypatch.setattr(jest_mod, "Estimator",
                            recorded(jest_mod.Estimator, "jax"))
        monkeypatch.setattr(rb, "Estimator", recorded(rb.Estimator, "port"))
        monkeypatch.setattr(jreplay_mod, "replay",
                            replayed(jreplay_mod.replay, "jax"))
        monkeypatch.setattr(rb, "replay", replayed(rb.replay, "port"))
        out = tmp_path / "jax.json"
        monkeypatch.setattr(sys, "argv", ["robustness"] + ARGV + [
            "--platform", "cpu", "--out", str(out)])
        _jax_robustness().main()
        port_out = tmp_path / "port.json"
        tres = rb.main(ARGV + ["--device", "cpu", "--out", str(port_out)])
    jres = json.loads(out.read_text())
    assert json.loads(port_out.read_text()) == json.loads(json.dumps(tres))
    assert [k for k in tres if k != "_meta"] == \
        [k for k in jres if k != "_meta"] == list(CASES)
    assert tres["_meta"]["platform"] == "cpu"
    for i, case in enumerate(CASES):
        got, want = tres[case], jres[case]
        assert set(got) == set(want), case
        assert "error" not in got
        for k in ("solves", "reboots", "ok"):
            assert got[k] == want[k], (case, k)
        both = {"jax": (outs["jax"][i], runs["jax"][i]),
                "port": (outs["port"][i], runs["port"][i])}
        jest_, test_ = outs["jax"][i]["estimator"], \
            outs["port"][i]["estimator"]
        stale = tres["_meta"]["estimator"][case]["stale_imu_intervals"]
        assert stale == test_.stats.get("stale_imu_intervals", 0) == \
            jest_.stats.get("stale_imu_intervals", 0)
        assert (stale > 0) == (case == "imu_dropout_2x1s")
        n, held = assert_runs_match(f"robustness[{case}]", both)
        assert 3 <= held < n
        # the driver's own record of the first placeholder step (watch)
        cut = tres["_meta"]["estimator"][case]["placeholder_at"]
        assert cut == runs["port"][i]["placeholder_at"] == \
            runs["jax"][i]["placeholder_at"]
        assert_rel(f"robustness[{case}].distance", got["distance"],
                   outs["jax"][i]["distance"], 1e-8)
        before = tres["_meta"]["estimator"][case]["before_placeholder"]
        jbefore = rb.before_placeholder(outs["jax"][i], cut)
        assert before["frames"] == jbefore["frames"] == held
        for k in ("drift_pct", "ate_rmse"):
            assert_rel(f"robustness[{case}].{k} before the placeholder step",
                       before[k], jbefore[k], 1e-8)
            print(f"PORT_DIFF robustness[{case}].{k} of the whole run (not "
                  f"held: roundoff past the placeholder step): port "
                  f"{got[k]:.6g}, JAX {float(outs['jax'][i][k]):.6g}")
        if "td_final_ms" in got:
            print(f"PORT_DIFF robustness[{case}].td_final_ms (not held): "
                  f"port {got['td_final_ms']:.6f}, JAX "
                  f"{float(jest_.td) * 1e3:.6f}")
    # imu_dropout_2x1s is diag_dropout's run (the same simulation, windows,
    # config and watch): diag_dropout's analysis of the port's run against
    # the JAX script's lines (evals/diag_dropout.py:33-45) on JAX's, held
    # before the first placeholder step
    i = CASES.index("imu_dropout_2x1s")
    jout, tout = outs["jax"][i], outs["port"][i]
    jest_, test_ = jout["estimator"], tout["estimator"]
    counts = tres["_meta"]["estimator"]["imu_dropout_2x1s"]
    seen = {"all": counts["solves_all"] - test_.stats["solves"],
            "placeholder_at": counts["placeholder_at"]}
    got = diag_dropout.summary(test_, tout, seen, 2.5)
    for k, v in (("reboots", jest_.stats["reboots"]),
                 ("stale_intervals", jest_.stats.get("stale_imu_intervals")),
                 ("failure_reasons", [[float(t), r] for t, r in
                                      jest_.stats.get("failure_reasons", [])]),
                 ("placeholder_at", counts["placeholder_at"])):
        assert got[k] == v, (k, got[k], v)
    cut = counts["placeholder_at"]
    t = np.asarray(jout["est_t"])
    err = np.linalg.norm(jout["est_p"] - jout["est_p"][0]
                         - (jout["gt_p"] - jout["gt_p"][0]), axis=1)
    for t0, rows in got["err_around"].items():
        sel = (t > t0 - 2) & (t < t0 + 4)
        want = list(zip(t[sel][::3], err[sel][::3]))
        assert [r[0] for r in rows] == [float(w[0]) for w in want]
        keep = [j for j, w in enumerate(want) if w[0] < cut]
        assert keep
        assert_close(f"diag_dropout err around {t0:.2f} s",
                     [rows[j][1] for j in keep],
                     [want[j][1] for j in keep], 0, 1e-8)
    want = rb.before_placeholder(jout, cut)
    assert got["before_placeholder"]["frames"] == want["frames"]
    assert_rel("diag_dropout before the placeholder step",
               [got["before_placeholder"][k] for k in ("drift_pct",
                                                        "ate_rmse")],
               [want[k] for k in ("drift_pct", "ate_rmse")], 1e-8)


def test_refuses_cuda_without_a_card():
    with pytest.raises(SystemExit):
        rb.main(["--device", "tpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the "
                    "driver on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        rb.main(["--device", "cuda", "--cases", "baseline_matched",
                 "--duration", "0.1"])
