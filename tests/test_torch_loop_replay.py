"""The port's offline loop-back-end replay
(cerberus_tpu_torch/evals/loop_replay.py) against the JAX repo's
evals/loop_replay.py on the CPU, across packages: a keyframe stream pickled
by either package's LoopCloser(record=True) replays in the other.

Input: 60 keyframes of a small street circuit (a 4 x 2 m rounded
rectangle, keyframes 0.26 m apart, ~1.5 laps) from chip_smoke.StreetStream
with odometric drift, as tests/test_torch_loop_closure.py feeds it; every
closer runs on a 32-node pose graph that grows to 64 (the JAX package's
one-hot optimize at its default 512-node pool costs ~1 s a Gauss-Newton
iteration on a CPU).

Tolerances, and why: the two pickles' records equal (the same NumPy
descriptor code in both packages); loops found and rejected, rollbacks,
prunes and nodes equal; corrected and odometric keyframe positions within
1e-8 m, so the ATEs too (the closers' decisions are host NumPy in both
packages and the pose graph's optimize differs by summation order only,
tests/test_torch_posegraph.py); the --sweep's eleven variants' results
on the first 45 records equal the JAX script's (both rounded to 4
decimals).
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import cerberus_tpu.loop.closer as jcloser_mod
from cerberus_tpu.loop.posegraph import PoseGraph as jPoseGraph
from cerberus_tpu_torch.data.simulator import SimConfig
from cerberus_tpu_torch.evals import loop_replay as tlr
from cerberus_tpu_torch.loop.posegraph import PoseGraph as tPoseGraph
from torch_port_util import assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_STREET = SimConfig(path="street", speed=0.75, seed=77, street_w=4.0,
                         street_h=2.0, street_corner_r=0.8)
SWEEP_RECORDS = 45


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_closer(Closer, PoseGraph, closers, **dev):
    """A LoopCloser class whose instances run a 32-node pose graph (growing
    to 64), each appended to `closers`."""

    class Small(Closer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.pg = PoseGraph(capacity_nodes=32, capacity_edges=64,
                                auto_detect=False,
                                seq_weight=kw.get("seq_weight", 100.0),
                                robust_kind=kw.get("robust_kind", "cauchy"),
                                **dev)
            closers.append(self)

    return Small


def jax_loop_replay():
    spec = importlib.util.spec_from_file_location(
        "jax_evals_loop_replay", os.path.join(ROOT, "evals",
                                              "loop_replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """The stream through a recording closer of each package: (JAX pickle,
    port pickle, the stream)."""
    from chip_smoke import StreetStream

    stream = StreetStream(60, sim_cfg=SMALL_STREET, spacing=0.26,
                          sigma_p=0.002, sigma_yaw=2e-3)
    made = []
    jc = small_closer(jcloser_mod.LoopCloser, jPoseGraph, made)(record=True)
    tc = small_closer(tlr.LoopCloser, tPoseGraph, made, device="cpu")(
        record=True, device="cpu")
    for rec in stream:
        for c in (jc, tc):
            c.add_keyframe(*rec)
    assert jc.loops_found >= 1
    tmp = tmp_path_factory.mktemp("records")
    paths = tmp / "jax.pkl", tmp / "port.pkl"
    jc.dump_records(str(paths[0]))
    tc.dump_records(str(paths[1]))
    return paths[0], paths[1], stream


def _gt_of_t(stream):
    return lambda ts: np.column_stack([np.interp(ts, stream.t,
                                                 stream.truth[:, i])
                                       for i in range(3)])


def _replay_both(monkeypatch, path, stream):
    """One pickle through the JAX script's run_variant and the port's:
    (JAX result, port result, JAX closer, port closer)."""
    closers = {"jax": [], "port": []}
    monkeypatch.setattr(jcloser_mod, "LoopCloser", small_closer(
        jcloser_mod.LoopCloser, jPoseGraph, closers["jax"]))
    monkeypatch.setattr(tlr, "LoopCloser", small_closer(
        tlr.LoopCloser, tPoseGraph, closers["port"], device="cpu"))
    with open(path, "rb") as f:
        records = pickle.load(f)
    assert len(records) == 60
    gt = _gt_of_t(stream)
    jres = jax_loop_replay().run_variant(records, gt)
    tres = tlr.run_variant(records, gt, device="cpu")
    return jres, tres, closers["jax"][0], closers["port"][0]


def _assert_equal(name, jres, tres, jc, tc):
    assert tres == jres
    assert tres["loops"] >= 1 and tres["nodes"] == 60
    assert tres["corrected_ate"] < tres["odometric_ate"]
    assert tc.pg.Nc == jc.pg.Nc == 64
    assert_close(f"{name}.corrected", tc.corrected(), jc.corrected(), 0,
                 1e-8)
    assert_close(f"{name}.odometric", tc.odometric(), jc.odometric(), 0,
                 1e-8)


def test_jax_records_replay_in_the_port(monkeypatch, pickles):
    jpkl, _, stream = pickles
    _assert_equal("loop_replay[JAX pickle]",
                  *_replay_both(monkeypatch, jpkl, stream))


def test_port_records_replay_in_jax(monkeypatch, pickles):
    """The port's pickle equals the JAX package's record for record and
    loads into the JAX script's closer."""
    jpkl, tpkl, stream = pickles
    with open(jpkl, "rb") as f:
        jrec = pickle.load(f)
    with open(tpkl, "rb") as f:
        trec = pickle.load(f)
    for a, b in zip(trec, jrec):
        assert set(a) == set(b)
        for k in a:
            if a[k] is None:
                assert b[k] is None, k
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_equal("loop_replay[port pickle]",
                  *_replay_both(monkeypatch, tpkl, stream))


def test_sweep_matches_jax(monkeypatch, capsys, pickles, tmp_path):
    """main --sweep on the JAX pickle's first SWEEP_RECORDS records (a few
    loops; the JAX closer takes seconds a variant): the eleven variants'
    results equal the JAX script's (ground truth regenerated from the
    street seed)."""
    with open(pickles[0], "rb") as f:
        records = pickle.load(f)[:SWEEP_RECORDS]
    jpkl = tmp_path / "prefix.pkl"
    with open(jpkl, "wb") as f:
        pickle.dump(records, f)
    monkeypatch.setattr(jcloser_mod, "LoopCloser", small_closer(
        jcloser_mod.LoopCloser, jPoseGraph, []))
    monkeypatch.setattr(tlr, "LoopCloser", small_closer(
        tlr.LoopCloser, tPoseGraph, [], device="cpu"))
    args = [str(jpkl), "--duration", "25", "--sweep"]
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["loop_replay"] + args
                        + ["--out", str(out)])
    jax_loop_replay().main()
    with open(out) as f:
        jres = json.load(f)
    tres = tlr.main(args + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-11].startswith("default ")
    assert list(tres) == list(jres) == [n for n, _ in tlr.VARIANTS]
    assert tres["default"]["loops"] >= 1
    for name in tres:
        for r in (tres[name], jres[name]):
            r.pop("wall_s")
        assert tres[name] == jres[name], name


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "empty.pkl"
    with open(path, "wb") as f:
        pickle.dump([], f)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlr.main([str(path), "--duration", "1"])
