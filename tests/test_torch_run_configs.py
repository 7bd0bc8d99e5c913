"""The port's configuration matrix (cerberus_tpu_torch/evals/run_configs.py)
against the JAX repo's evals/run_configs.py on the CPU: configs 1 (the
legged EKF alone, with and without foot slip), 2 (IMU + leg, no vision)
and 4 (rho calibration from a 0.215 m calf) at 1.0 s, the shortest run in
which configs 2 and 4 reach NON_LINEAR (15 camera frames; the window needs
11), with the default EstimatorConfig cut to max_features = 32,
max_num_iterations = 4 in both scripts (their EstimatorConfig swapped for
the test).

Tolerances, and why: equal result keys (and `_meta`'s) and equal solve and
reboot counts; drift, ATE and distance within 1e-8 relative (the port's
EKF and estimator agree with the JAX package's to ~1e-12 in f64,
tests/test_torch_ekf.py and tests/test_torch_streaming.py); the
unrounded final rho within 1e-8.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import cerberus_tpu.config as jconfig
import cerberus_tpu.estimator.estimator as jest_mod
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.evals import run_configs as rc
from torch_port_util import assert_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_features=32, max_num_iterations=4)
ARGV = ["--configs", "1,2,4", "--duration", "1.0"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run_configs():
    spec = importlib.util.spec_from_file_location(
        "jax_evals_run_configs", os.path.join(ROOT, "evals",
                                              "run_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numbers(d, prefix=""):
    """{path: value} of a result's numbers, nested dicts flattened."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool) \
                and k != "wall_s":
            out[prefix + k] = v
    return out


def test_configs_1_2_4_match_jax(monkeypatch, capsys, tmp_path):
    jcls = jconfig.EstimatorConfig
    monkeypatch.setattr(jconfig, "EstimatorConfig",
                        lambda **kw: jcls(**{**KW, **kw}))
    monkeypatch.setattr(rc, "EstimatorConfig",
                        lambda **kw: tConfig(**{**KW, **kw}))
    ests = {"jax": [], "port": []}

    class JaxEstimator(jest_mod.Estimator):
        def __init__(self, *a, **kw):
            super().__init__(*a, use_native=False, **kw)
            ests["jax"].append(self)

    class PortEstimator(rc.Estimator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            ests["port"].append(self)

    monkeypatch.setattr(jest_mod, "Estimator", JaxEstimator)
    monkeypatch.setattr(rc, "Estimator", PortEstimator)

    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["run_configs"] + ARGV + [
        "--platform", "cpu", "--out", str(out)])
    _jax_run_configs().main()
    with open(out) as f:
        jres = json.load(f)
    port_out = tmp_path / "port.json"
    tres = rc.main(ARGV + ["--device", "cpu", "--out", str(port_out)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"wrote": str(port_out), "configs": sorted(tres)}
    with open(port_out) as f:
        assert json.load(f) == json.loads(json.dumps(tres))

    assert set(tres) == set(jres) == {"1_ekf_only", "2_imu_leg_only",
                                      "4_rho_calibration", "_meta"}
    for k in tres:
        assert set(tres[k]) == set(jres[k]), k
    assert tres["_meta"]["platform"] == "cpu"
    assert tres["_meta"]["durations"] == jres["_meta"]["durations"]
    for k in ("1_ekf_only", "2_imu_leg_only", "4_rho_calibration"):
        got, want = _numbers(tres[k]), _numbers(jres[k])
        assert set(got) == set(want), k
        for name in got:
            if name in ("solves", "reboots", "no_slip.bg_z_est"):
                assert got[name] == want[name], (k, name)
            else:
                assert_rel(f"run_configs {k}.{name}", got[name], want[name],
                           1e-8)
    assert tres["2_imu_leg_only"]["solves"] > 0
    assert tres["4_rho_calibration"]["reboots"] == 0
    # configs 2 and 4: one estimator each, in order
    (t2, t4), (j2, j4) = ests["port"], ests["jax"]
    assert t2.solver_flag == t2.NON_LINEAR == t4.solver_flag
    assert_rel("run_configs 4 rho_final (unrounded)",
               np.mean(t4.rho[10]), np.mean(np.asarray(j4.rho[10])), 1e-8)


def test_refuses_without_a_card_or_a_device():
    with pytest.raises(SystemExit):
        rc.main(["--device", "tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rc.main(["--configs", "1", "--duration", "0.1"])
