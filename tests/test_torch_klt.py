"""The port's KLT front end (ops/klt.py, frontend/tracker.py,
frontend/device_tracker.py) against the JAX package, on the CPU.

Inputs: tests/test_klt.py's `_textured` stream (smooth random texture,
numpy seed 0, shifted or warped with OpenCV) and 160x120 stereo frames
rendered by the port's ImageRenderer from SimConfig(duration=1.0,
speed=0.5, seed=5). Images are float32 in both packages.

Tolerances, and why:
  * build_pyramid, _scharr, shi_tomasi: 1e-5 relative — the same shifted
    adds in the same order (in practice equal, or a few ulps in the box sums);
  * _sample_patches: 1e-4 of the image's scale — gathers against the JAX
    package's hat-matrix contractions, the same taps and weights summed with
    or without fused multiply-adds;
  * LK and track_frame: positions kept by both within 1e-3 px; status,
    `keep` and stereo flags equal on >= 98 % of the slots (an ulp in a
    sampled patch can move a point across the fb or min-eig gate);
    detections: the two `ok` sets equal but for at most 2 points per frame
    (a one-ulp box sum can flip a quantized NMS score);
  * _greedy_mask and _maxpool on equal inputs: exact (integer decisions);
  * PinholeCamera.undistort_normalize against cv2.undistortPoints: 1e-9;
  * FeatureTracker (both packages' copies run OpenCV): exact.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from cerberus_tpu.frontend import device_tracker as jdt  # noqa: E402
from cerberus_tpu.frontend import tracker as jtr  # noqa: E402
from cerberus_tpu.ops import klt as jklt  # noqa: E402
from cerberus_tpu_torch.config import EstimatorConfig  # noqa: E402
from cerberus_tpu_torch.data.simulator import (ImageRenderer, SimConfig,  # noqa: E402
                                               simulate)
from cerberus_tpu_torch.frontend import device_tracker as tdt  # noqa: E402
from cerberus_tpu_torch.frontend import tracker as ttr  # noqa: E402
from cerberus_tpu_torch.ops import klt as tklt  # noqa: E402
from torch_port_util import assert_close, assert_rel  # noqa: E402

POS_TOL = 1e-3       # px, positions both packages kept
AGREE = 0.98         # share of slots whose flags must agree
DET_DIFF = 2         # detections in one package's ok set and not the other's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small ops: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _textured(rng, H=120, W=160):
    """tests/test_klt.py's smooth random texture."""
    img = rng.uniform(0, 255, size=(H // 4, W // 4)).astype(np.float32)
    img = cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC)
    return cv2.GaussianBlur(img, (5, 5), 1.0)


def _warp(img, deg, dx, dy):
    H, W = img.shape
    M = cv2.getRotationMatrix2D((W / 2, H / 2), deg, 1.0)
    M[:, 2] += [dx, dy]
    return cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)


@pytest.fixture(scope="module")
def rendered():
    """Four 160x120 stereo pairs (uint8) of sequence A's first frames."""
    sim = simulate(SimConfig(duration=1.0, speed=0.5, seed=5))
    r = ImageRenderer(sim, EstimatorConfig(image_width=160, image_height=120),
                      focal=115.0)
    return [r.render_stereo(int(k)) for k in sim["cam_idx"][:4]], r


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def agree(name, got, want):
    share = float(np.mean(np.asarray(got) == np.asarray(want)))
    print(f"PORT_DIFF {name} agree={share:.4f}")
    assert share >= AGREE, (name, share)


def assert_kept_close(name, got_pts, want_pts, got_ok, want_ok):
    both = np.asarray(got_ok) & np.asarray(want_ok)
    agree(f"{name}.status", got_ok, want_ok)
    assert_close(f"{name}.pts", np.asarray(got_pts)[both],
                 np.asarray(want_pts)[both], 0, POS_TOL)


def assert_detections(name, got_pts, got_ok, want_pts, want_ok):
    g = set(map(tuple, np.asarray(got_pts)[np.asarray(got_ok)].tolist()))
    w = set(map(tuple, np.asarray(want_pts)[np.asarray(want_ok)].tolist()))
    print(f"PORT_DIFF {name}.detections n={len(w)} differ={len(g ^ w)}")
    assert len(g ^ w) <= DET_DIFF, (name, sorted(g ^ w))


def test_pyramid_scharr_shi_tomasi(rng):
    img = _textured(rng)
    pj = jklt.build_pyramid(jnp.asarray(img), 4)
    pt = tklt.build_pyramid(t_(img), 4)
    for lvl, (a, b) in enumerate(zip(pj, pt)):
        assert b.dtype == torch.float32
        assert_rel(f"build_pyramid[{lvl}]", b.numpy(), np.asarray(a), 1e-5)
        for name, x, y in zip(("ix", "iy"), tklt._scharr(b),
                              jklt._scharr(a)):
            assert_rel(f"_scharr[{lvl}].{name}", x.numpy(), np.asarray(y),
                       1e-5)
    for u8 in (False, True):
        im = img.astype(np.uint8) if u8 else img
        assert_rel(f"shi_tomasi(u8={u8})", tklt.shi_tomasi(t_(im)).numpy(),
                   np.asarray(jklt.shi_tomasi(jnp.asarray(im))), 1e-5)


def test_sample_patches_match_both_jax_forms(rng):
    """The port's gathers against the JAX package's hat-matrix sampler and
    its gather-based `_bilinear`, centers inside and outside the image."""
    H, W, half = 48, 64, 5
    img = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    pts = rng.uniform([-3, -3], [W + 3, H + 3], size=(12, 2)).astype(
        np.float32)
    (got,) = tklt._sample_patches([t_(img)], t_(pts[:, 0]), t_(pts[:, 1]),
                                  half)
    (hat,) = jklt._sample_patches([jnp.asarray(img)], jnp.asarray(pts[:, 0]),
                                  jnp.asarray(pts[:, 1]), half)
    grid = jklt._patch_grid(half, jnp.float32)
    gather = np.stack([np.asarray(jklt._bilinear(jnp.asarray(img),
                                                 p[None, :] + grid))
                       .reshape(2 * half + 1, 2 * half + 1) for p in pts])
    assert_close("_sample_patches vs hat form", got.numpy(), np.asarray(hat),
                 0, 1e-4 * 255)
    assert_close("_sample_patches vs _bilinear", got.numpy(), gather, 0,
                 1e-4 * 255)
    xy = t_(pts[:, None, :] + np.asarray(grid)[None])
    assert_close("_bilinear", tklt._bilinear(t_(img), xy).numpy().reshape(
        got.shape), gather, 0, 1e-4 * 255)


@pytest.mark.parametrize("deg,dx,dy", [(0.0, 3.3, -2.7), (2.0, 1.5, -1.0)])
def test_lk_track_fb(rng, deg, dx, dy):
    img0 = _textured(rng)
    img1 = _warp(img0, deg, dx, dy)
    p0 = rng.uniform([20, 20], [140, 100], size=(60, 2)).astype(np.float32)
    valid = np.ones(60, bool)
    valid[::7] = False
    rj = jklt.lk_track_fb(jklt.build_pyramid(jnp.asarray(img0), 3),
                          jklt.build_pyramid(jnp.asarray(img1), 3),
                          jnp.asarray(p0), jnp.asarray(valid))
    rt = tklt.lk_track_fb(tklt.build_pyramid(t_(img0), 3),
                          tklt.build_pyramid(t_(img1), 3), t_(p0), t_(valid))
    assert rt.status.numpy().sum() > 30
    assert_kept_close("lk_track_fb", rt.pts.numpy(), rj.pts,
                      rt.status.numpy(), rj.status)
    assert_close("lk_track_fb.err", rt.err.numpy()[np.asarray(rj.status)],
                 np.asarray(rj.err)[np.asarray(rj.status)], 0, 1e-2)


def test_greedy_mask_and_maxpool_exact(rng):
    """Equal inputs, equal integer decisions: priorities that tie (the
    stable order matters), failed slots, points at the border."""
    N, H, W = 60, 120, 160
    pts = rng.uniform([-2, -2], [W + 2, H + 2], size=(N, 2)).astype(
        np.float32)
    status = rng.uniform(size=N) > 0.2
    prio = rng.integers(0, 3, size=N).astype(np.int32)
    kj, oj = jklt._greedy_mask(jnp.asarray(pts), jnp.asarray(status),
                               jnp.asarray(prio), 8, (H, W))
    kt, ot = tklt._greedy_mask(t_(pts), t_(status), t_(prio), 8, (H, W))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 5 < kt.numpy().sum() < N
    si = rng.integers(0, 10 ** 6, size=(H, W)).astype(np.int32)
    np.testing.assert_array_equal(tklt._maxpool(t_(si), 10).numpy(),
                                  np.asarray(jklt._maxpool(jnp.asarray(si),
                                                           10)))


def test_detect_features(rng):
    H, W = 96, 128
    board = np.zeros((H, W), np.float32)
    for i in range(0, H, 16):
        for j in range(0, W, 16):
            if ((i + j) // 16) % 2 == 0:
                board[i:i + 16, j:j + 16] = 255.0
    board = cv2.GaussianBlur(board, (3, 3), 0.8)
    occupied = np.zeros((H, W), bool)
    occupied[:, : W // 2] = True
    for name, img, occ, md in (("checkerboard", board, occupied, 6),
                               ("textured", _textured(rng, H, W), ~occupied,
                                6)):
        pj, okj = jklt.detect_features(jnp.asarray(img), jnp.asarray(occ),
                                       max_new=30, min_dist=md)
        pt, okt = tklt.detect_features(t_(img), t_(occ), max_new=30,
                                       min_dist=md)
        assert okt.numpy().sum() >= 4
        assert_detections(f"detect_features[{name}]", pt.numpy(), okt.numpy(),
                          pj, okj)


def _track_inputs(det_pts, det_ok, N, shift=(0.0, 0.0)):
    pts = np.zeros((N, 2), np.float32)
    k = int(det_ok.sum())
    pts[:k] = det_pts[det_ok]
    valid = np.arange(N) < k
    prio = np.where(valid, np.arange(N) % 3, -1).astype(np.int32)
    return pts, valid, pts + np.float32(shift), prio


def _compare_track_frame(name, jo, to, N):
    assert_kept_close(f"{name}.pts/keep", to["pts"].numpy(), jo["pts"],
                      to["keep"].numpy(), jo["keep"])
    assert_detections(name, to["det_pts"].numpy(), to["det_ok"].numpy(),
                      jo["det_pts"], jo["det_ok"])
    # stereo rows of the tracked slots; the detection rows follow the
    # detections, which the previous assertion holds
    assert_kept_close(f"{name}.r_pts/r_ok", to["r_pts"].numpy()[:N],
                      jo["r_pts"][:N], to["r_ok"].numpy()[:N],
                      jo["r_ok"][:N])


def test_track_frame_textured_stream(rng):
    """Frame k+1 of a translating texture tracked from frame k: both
    packages get the same slots (the JAX package's detections of frame k)."""
    N, H, W = 40, 120, 160
    base = _textured(rng, H, W + 40)
    frames = [(base[:, 2 * k:2 * k + W].astype(np.uint8),
               base[:, 2 * k + 4:2 * k + 4 + W].astype(np.uint8))
              for k in range(3)]
    kw = dict(levels=4, half=10, iters=10, min_dist=8, fb_thresh=0.5,
              stereo=True, det_stereo=16)
    for k in range(1, 3):
        occ = np.zeros((H, W), bool)
        dj, okj = jklt.detect_features(
            jnp.asarray(frames[k - 1][0].astype(np.float32)),
            jnp.asarray(occ), N, kw["min_dist"])
        pts, valid, guess, prio = _track_inputs(np.asarray(dj),
                                                np.asarray(okj), N,
                                                (-2.0, 0.0))
        jo = jklt.track_frame(
            tuple(jklt.build_pyramid(jnp.asarray(frames[k - 1][0]), 4)),
            jnp.asarray(frames[k][0]), jnp.asarray(frames[k][1]),
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(guess),
            jnp.asarray(prio), **kw)
        to = tklt.track_frame(
            tuple(tklt.build_pyramid(t_(frames[k - 1][0]), 4)),
            t_(frames[k][0]), t_(frames[k][1]), t_(pts), t_(valid), t_(guess),
            t_(prio), **kw)
        jo = {key: (v if key == "pyr0" else np.asarray(v))
              for key, v in jo.items()}
        assert to["keep"].numpy().sum() > 10
        _compare_track_frame(f"track_frame[textured {k}]", jo, to, N)


def test_track_frame_and_first_frame_rendered(rendered):
    """_first_frame on rendered frame 0, then track_frame on frames 1-3
    from the JAX package's detections in the frame before."""
    frames, _ = rendered
    N = 40
    args = dict(levels=4, half=10, iters=10, min_dist=8, fb_thresh=0.5,
                stereo=True)
    jf = jdt._first_frame(jnp.asarray(frames[0][0]),
                          jnp.asarray(frames[0][1]), max_new=N, **args)
    tf = tdt._first_frame(t_(frames[0][0]), t_(frames[0][1]), max_new=N,
                          **args)
    assert_detections("_first_frame", tf["det_pts"].numpy(),
                      tf["det_ok"].numpy(), jf["det_pts"], jf["det_ok"])
    assert_kept_close("_first_frame.r_pts/r_ok", tf["r_pts"].numpy(),
                      jf["r_pts"], tf["r_ok"].numpy(), jf["r_ok"])
    for lvl, (a, b) in enumerate(zip(tf["pyr0"], jf["pyr0"])):
        assert_rel(f"_first_frame.pyr0[{lvl}]", a.numpy(), np.asarray(b),
                   1e-5)
    for k in range(1, 4):
        dj, okj = jklt.detect_features(
            jnp.asarray(frames[k - 1][0].astype(np.float32)),
            jnp.zeros(frames[k][0].shape, bool), N, args["min_dist"])
        pts, valid, guess, prio = _track_inputs(np.asarray(dj),
                                                np.asarray(okj), N)
        jo = jklt.track_frame(
            tuple(jklt.build_pyramid(jnp.asarray(frames[k - 1][0]), 4)),
            jnp.asarray(frames[k][0]), jnp.asarray(frames[k][1]),
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(guess),
            jnp.asarray(prio), det_stereo=16, **args)
        to = tklt.track_frame(
            tuple(tklt.build_pyramid(t_(frames[k - 1][0]), 4)),
            t_(frames[k][0]), t_(frames[k][1]), t_(pts), t_(valid), t_(guess),
            t_(prio), det_stereo=16, **args)
        jo = {key: (v if key == "pyr0" else np.asarray(v))
              for key, v in jo.items()}
        assert to["keep"].numpy().sum() > 5
        _compare_track_frame(f"track_frame[rendered {k}]", jo, to, N)


def test_device_tracker_stream(rng):
    """tests/test_klt.py::test_device_tracker_stream's assertions on the
    port's DeviceTracker (CPU), and its ids equal to the JAX package's
    frame by frame; normalized positions within 1e-3 px / fx."""
    H, W = 120, 160
    cams = {pkg: mod.PinholeCamera(fx=100, fy=100, cx=W / 2, cy=H / 2,
                                   size=(W, H))
            for pkg, mod in (("jax", jtr), ("port", ttr))}
    jt = jdt.DeviceTracker(cams["jax"], cams["jax"], max_cnt=40, min_dist=8)
    tt = tdt.DeviceTracker(cams["port"], cams["port"], max_cnt=40,
                           min_dist=8, device="cpu")
    base = _textured(rng, H, W + 40)
    hist = []
    for k in range(4):
        img0 = base[:, k * 2: k * 2 + W]
        img1 = base[:, k * 2 + 4: k * 2 + 4 + W]   # 4 px disparity
        jout, tout = jt.track(k / 15.0, img0, img1), tt.track(k / 15.0, img0,
                                                              img1)
        assert list(tout) == list(jout), k
        stereo_j = {i for i in jout if jout[i][2] is not None}
        stereo_t = {i for i in tout if tout[i][2] is not None}
        assert len(stereo_j ^ stereo_t) <= (1 - AGREE) * len(jout) + 1
        assert_close(f"DeviceTracker[{k}].pt0",
                     np.stack([tout[i][0] for i in jout]),
                     np.stack([jout[i][0] for i in jout]), 0, POS_TOL / 100)
        hist.append(tout)
    assert tt.stats["frames"] == 4
    common = set(hist[1]) & set(hist[3])
    assert len(common) > 10
    vx = np.median([hist[3][i][1][0] for i in common])
    assert abs(vx - (-0.3)) < 0.08, vx
    st = [fid for fid in hist[3] if hist[3][fid][2] is not None]
    assert len(st) > 10
    dis = np.median([hist[3][fid][2][0] - hist[3][fid][0][0] for fid in st])
    assert abs(dis - (-0.04)) < 0.015, dis


@pytest.mark.parametrize("dist", [(0, 0, 0, 0), (-0.28, 0.07, 1e-4, -2e-4),
                                  (0.1, -0.05, 1e-3, 2e-3),
                                  (-0.28, 0.07, 1e-4, -2e-4, 0.01)])
def test_pinhole_undistort_matches_opencv(rng, dist):
    cam = ttr.PinholeCamera(458.6, 457.3, 367.2, 248.4, dist)
    pts = rng.uniform([0, 0], [640, 480], size=(400, 2)).astype(np.float32)
    want = cv2.undistortPoints(pts.reshape(-1, 1, 2).astype(np.float64),
                               cam.K, cam.dist).reshape(-1, 2)
    assert_close(f"undistort_normalize{dist}", cam.undistort_normalize(pts),
                 want, 0, 1e-9)
    assert cam.undistort_normalize(np.zeros((0, 2))).shape == (0, 2)


def test_feature_tracker_matches_jax(rendered):
    """Both packages' FeatureTracker run OpenCV on the same frames: equal
    ids and equal observations."""
    frames, r = rendered
    make = lambda mod: mod.FeatureTracker(
        mod.PinholeCamera(r.f, r.f, r.cx, r.cy), mod.PinholeCamera(
            r.f, r.f, r.cx, r.cy), max_cnt=40, min_dist=8)
    jt, tt = make(jtr), make(ttr)
    for k, (im0, im1) in enumerate(frames):
        jout, tout = jt.track(k / 15.0, im0, im1), tt.track(k / 15.0, im0,
                                                            im1)
        assert list(tout) == list(jout)
        for fid in jout:
            for a, b in zip(tout[fid], jout[fid]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
