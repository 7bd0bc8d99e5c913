"""The port's loop closer against the JAX package on the CPU: the
place-recognition descriptors, and the whole back-end (place index, ZNCC
patch matching, RANSAC PnP, 4-DoF pose graph) fed the same keyframes.

Inputs: tests/test_loop_closure.py's rendered scenes and its revisit with
injected drift; and a 60-keyframe stream of a small street circuit (a
4 x 2 m rounded rectangle, 0.8 m corners, keyframes 0.26 m apart, ~41 a
lap) from chip_smoke.StreetStream, which revisits its first keyframes.
Both packages get the same rendered images.

Tolerances, and why:
  * descriptors, matches and PlaceIndex retrieval: exact — the port's
    descriptors.py is a copy of the JAX package's NumPy code;
  * the loop closer: equal counts (loops found and rejected, sequence
    gating, optimizes, rollbacks, prunes), corrected keyframe positions
    within 1e-8 m — its decisions are host NumPy in both packages, and the
    pose graph's optimize differs by summation order only
    (tests/test_torch_posegraph.py).
"""

import numpy as np
import pytest
import torch

from cerberus_tpu.config import EstimatorConfig as jConfig
from cerberus_tpu.loop import descriptors as jD
from cerberus_tpu.loop.closer import LoopCloser as jCloser
from cerberus_tpu.loop.posegraph import PoseGraph as jPoseGraph
from cerberus_tpu_torch.config import EstimatorConfig as tConfig
from cerberus_tpu_torch.data.simulator import SimConfig
from cerberus_tpu_torch.loop import descriptors as tD
from cerberus_tpu_torch.loop.closer import LoopCloser as tCloser
from cerberus_tpu_torch.loop.posegraph import PoseGraph as tPoseGraph
from test_loop_closure import _fake_sim, _kf_inputs, _pose, _Renderer
from torch_port_util import assert_close

SMALL_STREET = SimConfig(path="street", speed=0.75, seed=77, street_w=4.0,
                         street_h=2.0, street_corner_r=0.8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers at once, and the
    port's many small ops run slower with eight threads contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_descriptors_and_place_index_exact(rng):
    sim = _fake_sim(rng)
    poses = [_pose(0, 0, 0), _pose(0.08, -0.03, 0.02), _pose(0, 3.0, 1.2)]
    r = _Renderer(sim, poses)
    cfg = jConfig()
    imgs, pxs = [], []
    for k in range(3):
        obs, img = _kf_inputs(r, k, cfg)
        ids = sorted(obs)
        imgs.append(img)
        pxs.append(np.array([[460 * obs[i][0][0] + 320,
                              460 * obs[i][0][1] + 240] for i in ids])
                   .reshape(-1, 2))
    got = [tD.extract_patches(im, px) for im, px in zip(imgs, pxs)]
    want = [jD.extract_patches(im, px) for im, px in zip(imgs, pxs)]
    for (gd, gok), (wd, wok) in zip(got, want):
        assert np.array_equal(gd, wd) and np.array_equal(gok, wok)
    for a, b in ((1, 0), (2, 0), (2, 1)):
        tm = tD.match_patches(*got[a], *got[b])
        jm = jD.match_patches(*want[a], *want[b])
        assert all(np.array_equal(x, y) for x, y in zip(tm, jm))
    assert len(tD.match_patches(*got[1], *got[0])[0]) >= 10
    ti, ji = tD.PlaceIndex(capacity=2), jD.PlaceIndex(capacity=2)
    for k, im in enumerate(imgs * 2):
        g = tD.tiny_image(im)
        assert np.array_equal(g, jD.tiny_image(im))
        assert ti.query(g, exclude_last=2) == ji.query(g, exclude_last=2)
        assert ti.add(g) == ji.add(g) == k
    assert np.array_equal(ti.descs, ji.descs)


def _closer_stats(c):
    return dict(loops_found=c.loops_found, loops_rejected=c.loops_rejected,
                seq_gated=c.seq_gated, kf_skipped=c.kf_skipped,
                best_sim=c.best_sim, n=c.pg.n, Nc=c.pg.Nc,
                edges=[e[:2] for e in c.pg.edges], **c.pg.stats)


def _assert_closers_equal(name, tc, jc):
    ts, js = _closer_stats(tc), _closer_stats(jc)
    assert ts == js, (ts, js)
    assert_close(name + ".corrected", tc.corrected(), jc.corrected(), 0,
                 1e-8)
    assert_close(name + ".odometric", tc.odometric(), jc.odometric(), 0, 0)


def test_loop_closer_revisit_matches_jax(rng):
    """tests/test_loop_closure.py::test_loop_closer_corrects_drift's
    scenario through both closers, each on a 16-node pose graph."""
    sim = _fake_sim(rng, n_lm=80)
    true_poses = [_pose(0.15 * i, 0.0, 0.0) for i in range(8)]
    true_poses += [_pose(0.15, 0.0, 0.0)]
    r = _Renderer(sim, true_poses)
    drift = np.array([0.35, -0.25, 0.0])
    kw = dict(exclude_last=3, min_sim=0.7, min_matches=10,
              optimize_every=1000, min_kf_dist=0.0, seq_weight=10.0,
              loop_weight=20.0)
    jc = jCloser(jConfig(), **kw)
    tc = tCloser(tConfig(), **kw, device="cpu")
    # a 16-node pool in both (the default 512 only pads: the JAX package's
    # one-hot assembly at 512 nodes costs ~1 s a GN iteration on a CPU)
    jc.pg = jPoseGraph(capacity_nodes=16, capacity_edges=16,
                       auto_detect=False, seq_weight=10.0)
    tc.pg = tPoseGraph(capacity_nodes=16, capacity_edges=16,
                       auto_detect=False, seq_weight=10.0, device="cpu")
    qid = np.array([1.0, 0, 0, 0])
    for k in range(9):
        obs, img = _kf_inputs(r, k, jConfig())
        p = true_poses[k][0]
        if k == 8:
            obs = {i: (uv, w + drift) for i, (uv, w) in obs.items()}
            p = p + drift
        for c in (jc, tc):
            c.add_keyframe(float(k), p, qid, list(obs), obs, img)
    jc.finish()
    tc.finish()
    assert jc.loops_found >= 1
    _assert_closers_equal("LoopCloser[revisit]", tc, jc)
    err = np.linalg.norm(tc.corrected()[8] - true_poses[8][0])
    assert err < 0.35 * np.linalg.norm(drift)


def test_loop_closer_stream_matches_jax():
    """60 keyframes of a small street circuit (~1.5 laps) with odometric
    drift through both closers, each on a 32-node pose graph that grows to
    64."""
    from chip_smoke import StreetStream

    stream = StreetStream(60, sim_cfg=SMALL_STREET, spacing=0.26,
                          sigma_p=0.002, sigma_yaw=2e-3)
    closers = []
    for Closer, PoseGraph, dev in ((jCloser, jPoseGraph, {}),
                                   (tCloser, tPoseGraph,
                                    dict(device="cpu"))):
        c = Closer(**dev)
        c.pg = PoseGraph(capacity_nodes=32, capacity_edges=64,
                         auto_detect=False, seq_weight=100.0, **dev)
        closers.append(c)
    jc, tc = closers
    for rec in stream:
        for c in closers:
            c.add_keyframe(*rec)
    for c in closers:
        c.finish()
    assert jc.loops_found >= 1 and jc.pg.Nc == 64
    assert jc.pg.stats["optimizes"] >= 2
    _assert_closers_equal("LoopCloser[street stream]", tc, jc)
