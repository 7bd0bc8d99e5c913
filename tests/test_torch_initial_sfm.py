"""The port's initialization machinery (estimator/initial_sfm.py,
estimator/initial_alignment.py) against the JAX package, f64 on the CPU,
on tests/test_initial_sfm.py's and tests/test_aux.py's inputs.

The JAX package draws RANSAC hypotheses from a JAX PRNG key, which torch
cannot reproduce; the comparison feeds JAX's hypothesis set to the port's
`relative_pose_from_hypotheses`, and the port's own draw
(`relative_pose_ransac(seed=...)`) is held to tests/test_initial_sfm.py's
accuracy gates instead (its inlier-count gate as a distribution over ten
draws, see test_relative_pose_own_draw).

Tolerances, and why: the two packages' SVDs may choose singular vectors of
other signs, so R, t, inliers and quaternions are compared up to sign (a
quaternion with w >= 0, or row by row up to sign), never E or V^T. Values
within 1e-8 relative to scale: the same formulas in f64, through SVDs and
a 15-iteration Gauss-Newton whose sums are taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberus_tpu.estimator import initial_alignment as jal
from cerberus_tpu.estimator import initial_sfm as jsfm
from cerberus_tpu.ops import il_preintegrate
from cerberus_tpu.utils import lie
from cerberus_tpu_torch import convert
from cerberus_tpu_torch.estimator import initial_alignment as tal
from cerberus_tpu_torch.estimator import initial_sfm as tsfm
from cerberus_tpu_torch.ops.preintegration import ILPreint
from test_initial_sfm import _project, _rand_rot
from torch_port_util import assert_rel

CPU = dict(device="cpu")
TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers at once, and the
    port's many small ops run slower with eight threads contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _relative_pose_inputs(rng):
    """TestRelativePose's correspondences (80 points, 0.15 px noise)."""
    N = 80
    X = rng.uniform([-3, -3, 4], [3, 3, 12], size=(N, 3))
    R = _rand_rot(rng, 0.2)
    t = np.array([0.4, -0.1, 0.15])
    p0, z0 = _project(np.eye(3), np.zeros(3), X)
    p1, z1 = _project(R.T, -R.T @ t, X)
    noise = 0.15 / 460.0
    p0 += rng.normal(size=p0.shape) * noise
    p1 += rng.normal(size=p1.shape) * noise
    return p0, p1, (z0 > 0) & (z1 > 0), R, t


def _gates(Re, te, inl, R, t, N):
    ang = np.degrees(np.arccos(np.clip((np.trace(Re @ R.T) - 1) / 2, -1, 1)))
    cos = abs(te @ t) / (np.linalg.norm(te) * np.linalg.norm(t))
    assert ang < 1.0 and cos > 0.995 and int(inl.sum()) > 0.8 * N, \
        (ang, cos, int(inl.sum()))


def test_relative_pose_on_jax_hypotheses(rng):
    p0, p1, mask, R, t = _relative_pose_inputs(rng)
    key = jax.random.PRNGKey(0)
    jR, jt, jinl = jsfm.relative_pose_ransac(key, jnp.asarray(p0),
                                             jnp.asarray(p1),
                                             jnp.asarray(mask))
    # the hypotheses relative_pose_ransac drew from that key
    N = len(p0)
    w = jnp.asarray(mask).astype(jnp.float32) + 1e-9
    idx = jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(8,), replace=False, p=w / w.sum()))(
        jax.random.split(key, 128))
    tR, tt, tinl = tsfm.relative_pose_from_hypotheses(
        torch.as_tensor(np.asarray(idx)).long(), torch.as_tensor(p0),
        torch.as_tensor(p1), torch.as_tensor(mask))
    assert np.array_equal(tinl.numpy(), np.asarray(jinl))
    assert_rel("relative_pose_ransac.R", tR.numpy(), np.asarray(jR), TOL)
    assert_rel("relative_pose_ransac.t", tt.numpy(), np.asarray(jt), TOL)
    _gates(tR.numpy(), tt.numpy(), tinl.numpy(), R, t, N)


def test_relative_pose_own_draw(rng):
    """The port's own draw (seeds 0-9) against the JAX package's (keys
    0-9): every draw passes tests/test_initial_sfm.py's angle and direction
    gates. Its third gate, inliers > 0.8 N, counts the inliers of the best
    minimal hypothesis at a 0.3 px threshold and is met by JAX's key 0 but
    by 5 of JAX's first 20 keys (and by 6 of the port's first 20 seeds), so
    it is held as a distribution: the port's mean inlier count over ten
    draws within 10 % of JAX's."""
    p0, p1, mask, R, t = _relative_pose_inputs(rng)
    N = len(p0)
    counts = {"port": [], "jax": []}
    for s in range(10):
        Re, te, inl = tsfm.relative_pose_ransac(p0, p1, mask, seed=s, **CPU)
        Re, te = Re.numpy(), te.numpy()
        ang = np.degrees(np.arccos(np.clip((np.trace(Re @ R.T) - 1) / 2,
                                           -1, 1)))
        cos = abs(te @ t) / (np.linalg.norm(te) * np.linalg.norm(t))
        assert ang < 1.0 and cos > 0.995, (s, ang, cos)
        counts["port"].append(int(inl.sum()))
        counts["jax"].append(int(np.asarray(jsfm.relative_pose_ransac(
            jax.random.PRNGKey(s), jnp.asarray(p0), jnp.asarray(p1),
            jnp.asarray(mask))[2]).sum()))
    print(f"PORT_DIFF relative_pose_ransac own draw: inliers of {N} "
          f"port {counts['port']} jax {counts['jax']}")
    assert abs(np.mean(counts["port"]) / np.mean(counts["jax"]) - 1) < 0.1
    idx = tsfm.draw_hypotheses(torch.as_tensor(mask), 128, 0)
    assert idx.shape == (128, 8)
    assert all(len(set(row)) == 8 for row in idx.tolist())


def test_calibrate_ex_rotation(rng):
    q_ic_true = np.asarray(lie.so3_exp_quat(jnp.asarray([0.2, -0.5, 0.15])))
    K = 30
    q_cam, q_imu = [], []
    for _ in range(K):
        qb = lie.so3_exp_quat(jnp.asarray(rng.normal(size=3) * 0.2))
        qc = lie.quat_mul(lie.quat_conj(jnp.asarray(q_ic_true)),
                          lie.quat_mul(qb, jnp.asarray(q_ic_true)))
        q_imu.append(np.asarray(qb))
        q_cam.append(np.asarray(qc))
    q_cam, q_imu = np.stack(q_cam), np.stack(q_imu)
    valid = np.ones(K, bool)
    valid[3] = False
    jq, jok = jsfm.calibrate_ex_rotation(jnp.asarray(q_cam),
                                         jnp.asarray(q_imu),
                                         jnp.asarray(valid))
    tq, tok = tsfm.calibrate_ex_rotation(q_cam, q_imu, valid, **CPU)
    assert bool(tok) == bool(jok) is True
    assert_rel("calibrate_ex_rotation.q", tq.numpy(), np.asarray(jq), TOL)
    assert abs(float(tq.numpy() @ q_ic_true)) > 0.9999


def _sfm_inputs(rng):
    """TestGlobalSFM's window: 11 frames on an arc, 60 points."""
    NF, F = 11, 60
    ts = np.linspace(0, 1, NF)
    centers = np.stack([2.0 * ts, 0.3 * np.sin(2 * ts), 0 * ts], -1)
    qs = np.stack([np.asarray(lie.so3_exp_quat(
        jnp.asarray([0.02 * k, 0.03 * k, 0.1 * k]))) for k in range(NF)])
    Rs = np.stack([np.asarray(lie.quat_to_rot(jnp.asarray(qk))) for qk in qs])
    X = rng.uniform([-4, -4, 3], [8, 4, 10], size=(F, 3))
    f_pts = np.zeros((F, NF, 2))
    f_obs = np.zeros((F, NF), bool)
    for i in range(NF):
        pc = (X - centers[i]) @ Rs[i]
        ok = pc[:, 2] > 0.5
        f_pts[ok, i] = pc[ok, :2] / pc[ok, 2:3]
        f_obs[:, i] = ok
    f_pts += rng.normal(size=f_pts.shape) * (0.3 / 460.0)
    return centers, Rs, X, f_pts, f_obs


@pytest.mark.parametrize("l", [0, 3])
def test_global_sfm(rng, l):
    """Seed frame 0 (the forward chain only, as TestGlobalSFM) and seed
    frame 3 (the backward chain too)."""
    centers, Rs, X, f_pts, f_obs = _sfm_inputs(rng)
    Rl, cl = Rs[l], centers[l]
    q_rel = np.asarray(lie.rot_to_quat(jnp.asarray(Rl.T @ Rs[-1])))
    p_rel = Rl.T @ (centers[-1] - cl)
    jres = jsfm.global_sfm(l, jnp.asarray(q_rel), jnp.asarray(p_rel),
                           jnp.asarray(f_pts), jnp.asarray(f_obs))
    tres = convert.sfm_result_to_numpy(
        tsfm.global_sfm(l, q_rel, p_rel, f_pts, f_obs, **CPU))
    assert bool(tres.ok) == bool(jres.ok) is True
    assert np.array_equal(tres.pts_ok, np.asarray(jres.pts_ok))
    jq = np.asarray(jres.q)
    tq = tres.q * np.sign(np.sum(tres.q * jq, axis=1))[:, None]
    assert_rel(f"global_sfm[l={l}].q", tq, jq, TOL)
    assert_rel(f"global_sfm[l={l}].p", tres.p, np.asarray(jres.p), TOL)
    ok = tres.pts_ok
    assert_rel(f"global_sfm[l={l}].pts", tres.pts[ok],
               np.asarray(jres.pts)[ok], TOL)
    # the JAX package's result carried into the port and back
    back = convert.sfm_result_to_numpy(convert.sfm_result_from_numpy(
        type(jres)(*map(np.asarray, jres)), device="cpu"))
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jres))
    # tests/test_initial_sfm.py's accuracy gates, on the port's result
    p_gt = (centers - cl) @ Rl
    assert np.linalg.norm(tres.p - p_gt, axis=1).max() < 0.05
    X_gt = (X - cl) @ Rl
    assert np.median(np.linalg.norm(tres.pts[ok] - X_gt[ok], axis=1)) < 0.05
    assert ok.sum() >= 0.8 * len(X)


def test_visual_imu_alignment(rng):
    """TestVisualIMUAlignment's trajectory: 10 intervals, scale 2.7."""
    K = 10
    dt = np.full(K, 0.3)
    g_w = np.array([0.0, 0.0, 9.805])
    scale_true = 2.7
    q = [np.array([1.0, 0, 0, 0])]
    for k in range(K):
        dq = lie.so3_exp_quat(jnp.asarray(rng.normal(size=3) * 0.15))
        q.append(np.asarray(lie.quat_mul(jnp.asarray(q[-1]), dq)))
    q = np.stack(q)
    v = rng.normal(size=(K + 1, 3)) * 0.5
    p = np.zeros((K + 1, 3))
    dp, dv = np.zeros((K, 3)), np.zeros((K, 3))
    for k in range(K):
        a_w = (v[k + 1] - v[k]) / dt[k]
        p[k + 1] = p[k] + v[k] * dt[k] + 0.5 * a_w * dt[k] ** 2
        Rk = np.asarray(lie.quat_to_rot(jnp.asarray(q[k])))
        dp[k] = Rk.T @ (p[k + 1] - p[k] - v[k] * dt[k]
                        + 0.5 * g_w * dt[k] ** 2)
        dv[k] = Rk.T @ (v[k + 1] - v[k] + g_w * dt[k])
    tic = np.array([0.1, 0.02, -0.03])
    Rb = np.stack([np.asarray(lie.quat_to_rot(jnp.asarray(qk))) for qk in q])
    p_c = (p + np.einsum("kij,j->ki", Rb, tic)) / scale_true
    args = (p_c, q, dp, dv, dt, tic, np.eye(3))
    jv, jg, js, jok = jsfm.visual_imu_alignment(*map(jnp.asarray, args),
                                                9.805)
    tv, tg, ts, tok = tsfm.visual_imu_alignment(*args, 9.805, **CPU)
    assert bool(tok) == bool(jok) is True
    for name, a, b in (("v", tv, jv), ("g", tg, jg), ("scale", ts, js)):
        assert_rel(f"visual_imu_alignment.{name}", a.numpy(), np.asarray(b),
                   TOL)
    assert abs(float(ts) - scale_true) < 0.02 * scale_true
    assert np.linalg.norm(tg.numpy() - g_w) < 0.05


def _port_preint(pre):
    return ILPreint(*(torch.as_tensor(np.asarray(x)) for x in pre))


def test_gyro_and_leg_bias():
    """tests/test_aux.py's inputs: a gyro bias on the rotating trajectory,
    then the pinned-foot leg scenario."""
    from test_preintegration import PARAMS, build_inputs, build_leg_inputs

    bg_true = jnp.array([0.004, -0.003, 0.002])
    S = 40
    d = build_inputs(S=S, dt_s=0.002)
    phi = jnp.tile(jnp.array([0.0, 0.8, -1.6]), (S, 4)).reshape(S, 12)
    pre = il_preintegrate(d["dt"], d["acc"], d["gyr"] + bg_true, phi,
                          jnp.zeros((S, 12)), jnp.ones((S, 4)), d["mask"],
                          jnp.zeros(3), jnp.zeros(3), jnp.full((4,), 0.21),
                          PARAMS)
    qs = jnp.stack([d["q"][0], d["q"][-1]])
    jd = jal.solve_gyroscope_bias(qs, [pre])
    td = tal.solve_gyroscope_bias(np.asarray(qs), [_port_preint(pre), None],
                                  **CPU)
    assert_rel("solve_gyroscope_bias", td.numpy(), np.asarray(jd), TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(bg_true), atol=5e-4)

    dl = build_leg_inputs(S=40)
    pre2 = il_preintegrate(dl["dt"], dl["acc"], dl["gyr"] + bg_true,
                           dl["phi"], dl["dphi"], dl["c"], dl["mask"],
                           jnp.zeros(3), jnp.zeros(3), dl["rho"], PARAMS)
    qs2 = jnp.stack([dl["q"][0], dl["q"][-1]])
    ps2 = jnp.stack([dl["p"][0], dl["p"][-1]])
    jbg, jrho = jal.solve_gyro_leg_bias(qs2, ps2, [pre2])
    tbg, trho = tal.solve_gyro_leg_bias(np.asarray(qs2), np.asarray(ps2),
                                        [_port_preint(pre2)], **CPU)
    assert_rel("solve_gyro_leg_bias.bg", tbg.numpy(), np.asarray(jbg), TOL)
    assert_rel("solve_gyro_leg_bias.rho", trho.numpy(), np.asarray(jrho), TOL)
    np.testing.assert_allclose(tbg.numpy(), np.asarray(bg_true), atol=2e-3)
