"""KLT stereo feature tracker (vision front-end) and camera models (port of
`cerberus_tpu/frontend/tracker.py`).

Host-side re-implementation of the reference's FeatureTracker
(reference: src/featureTracker/feature_tracker.{h,cpp}): CLAHE equalization,
pyramidal Lucas-Kanade optical flow with optional prediction seeding and
forward-backward consistency check, min-distance masking preferring long
tracks, goodFeaturesToTrack replenishment, left->right stereo LK with reverse
check, undistortion to the normalized plane, and per-feature normalized-plane
velocities. Output format matches what the estimator consumes:
{id: (pt_left(3,), vel_left(2,), pt_right(3,)|None, vel_right(2,))} —
equivalent to the reference's featureFrame (feature_tracker.cpp:260-302).

`FeatureTracker` and `FisheyeCamera` run on OpenCV (`cv2`), imported when
they are used: without it they raise ImportError, and nothing switches to
another tracker. `PinholeCamera` needs no OpenCV: its undistortion is
OpenCV's rad-tan inversion written in NumPy, so the device tracker
(`frontend/device_tracker.py`) runs where OpenCV is missing.
"""

from __future__ import annotations

import numpy as np

# cv2.undistortPoints without a criteria argument iterates this many times
# (TermCriteria(COUNT, 5, 0.01) in OpenCV's undistort.dispatch.cpp)
UNDISTORT_ITERS = 5


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "OpenCV (cv2) is not installed: FeatureTracker and FisheyeCamera "
            "need it; the device tracker (frontend/device_tracker.py) with "
            "PinholeCamera does not") from e
    return cv2


class PinholeCamera:
    """Pinhole camera with radial-tangential distortion (camodocal PINHOLE
    equivalent; reference cameras are rectified realsense infra)."""

    def __init__(self, fx, fy, cx, cy, dist=(0, 0, 0, 0), size=(640, 480)):
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        self.dist = np.asarray(dist, float)
        self.size = size

    def undistort_normalize(self, pts: np.ndarray) -> np.ndarray:
        """(N, 2) pixels -> (N, 2) normalized-plane coordinates.

        cv2.undistortPoints(pts, K, dist) in f64: the normalized point, then
        UNDISTORT_ITERS fixed-point steps x = (x0 - delta(x)) / radial(x) of
        the distortion coefficients (k1, k2, p1, p2[, k3]); with every
        coefficient zero the steps leave the point unchanged."""
        if len(pts) == 0:
            return pts.reshape(0, 2)
        p = np.asarray(pts, np.float64).reshape(-1, 2)
        k = np.zeros(5)
        k[:min(len(self.dist), 5)] = self.dist[:5]
        k1, k2, p1, p2, k3 = k
        ifx, ify = 1.0 / self.K[0, 0], 1.0 / self.K[1, 1]
        x0 = x = (p[:, 0] - self.K[0, 2]) * ifx
        y0 = y = (p[:, 1] - self.K[1, 2]) * ify
        done = np.zeros(len(p), bool)
        for _ in range(UNDISTORT_ITERS):
            r2 = x * x + y * y
            icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            # at a negative radial factor OpenCV stops that point's
            # iteration and returns its normalized coordinates
            stop = ~done & (icdist < 0)
            done |= stop
            x = np.where(stop, x0, np.where(done, x, (x0 - dx) * icdist))
            y = np.where(stop, y0, np.where(done, y, (y0 - dy) * icdist))
        return np.stack([x, y], axis=1)


class FisheyeCamera:
    """Equidistant (Kannala-Brandt) fisheye camera (camodocal EQUIDISTANT
    equivalent, used by some VINS-Fusion configs); needs OpenCV."""

    def __init__(self, fx, fy, cx, cy, dist=(0, 0, 0, 0), size=(640, 480)):
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        self.dist = np.asarray(dist, float)
        self.size = size

    def undistort_normalize(self, pts: np.ndarray) -> np.ndarray:
        if len(pts) == 0:
            return pts.reshape(0, 2)
        pts = pts.reshape(-1, 1, 2).astype(np.float64)
        out = _cv2().fisheye.undistortPoints(pts, self.K,
                                             self.dist.reshape(4, 1))
        return out.reshape(-1, 2)


class FeatureTracker:
    def __init__(self, cam0: PinholeCamera, cam1: PinholeCamera | None = None,
                 max_cnt=120, min_dist=10, flow_back=True, use_clahe=True):
        cv2 = _cv2()
        self._cv2 = cv2
        self.cam0, self.cam1 = cam0, cam1
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.flow_back = flow_back
        self.clahe = cv2.createCLAHE(3.0, (8, 8)) if use_clahe else None

        self.prev_img = None
        self.prev_pts = np.zeros((0, 2), np.float32)
        self.ids = np.zeros((0,), np.int64)
        self.track_cnt = np.zeros((0,), np.int32)
        self.prev_un = {}
        self._prev_r_un = {}
        self.prev_time = None
        self.n_id = 0
        self.predict_pts: dict[int, np.ndarray] | None = None

    # ------------------------------------------------------------------
    def track(self, t: float, img0: np.ndarray, img1: np.ndarray | None = None):
        """Process a (stereo) frame; returns the feature dict
        (reference: trackImage, feature_tracker.cpp:94-302)."""
        cv2 = self._cv2
        if img0.ndim == 3:
            img0 = cv2.cvtColor(img0, cv2.COLOR_BGR2GRAY)
        if self.clahe is not None:
            img0 = self.clahe.apply(img0)

        cur_pts = np.zeros((0, 2), np.float32)
        # snapshot once: set_prediction may run from another thread while a
        # lookahead track() is in flight (data/replay.py pipelined front
        # end); the callback replaces the dict, so the snapshot stays valid
        predict = self.predict_pts
        if len(self.prev_pts):
            # seed with predictions when available (feature_tracker.cpp:112-133)
            seeds = self.prev_pts.copy()
            use_seed = False
            if predict:
                for i, fid in enumerate(self.ids):
                    if fid in predict:
                        seeds[i] = predict[fid]
                        use_seed = True
            flags = cv2.OPTFLOW_USE_INITIAL_FLOW if use_seed else 0
            cur, st, _ = cv2.calcOpticalFlowPyrLK(
                self.prev_img, img0, self.prev_pts, seeds.copy(),
                winSize=(21, 21), maxLevel=3, flags=flags)
            if use_seed and st.sum() < 10:  # fallback without seeding
                cur, st, _ = cv2.calcOpticalFlowPyrLK(
                    self.prev_img, img0, self.prev_pts, None,
                    winSize=(21, 21), maxLevel=3)
            st = st.reshape(-1).astype(bool)
            if self.flow_back and st.any():
                back, st2, _ = cv2.calcOpticalFlowPyrLK(
                    img0, self.prev_img, cur, self.prev_pts.copy(),
                    winSize=(21, 21), maxLevel=1,
                    flags=cv2.OPTFLOW_USE_INITIAL_FLOW)
                dist = np.linalg.norm(back - self.prev_pts, axis=1)
                st &= st2.reshape(-1).astype(bool) & (dist <= 0.5)
            st &= self._in_border(cur, img0.shape)
            cur_pts = cur[st]
            self.ids = self.ids[st]
            self.track_cnt = self.track_cnt[st] + 1
        # min-dist mask preferring long tracks + replenishment
        cur_pts = self._mask_and_detect(img0, cur_pts)

        # stereo matching (feature_tracker.cpp:202-245)
        right = {}
        if img1 is not None and self.cam1 is not None and len(cur_pts):
            if img1.ndim == 3:
                img1 = cv2.cvtColor(img1, cv2.COLOR_BGR2GRAY)
            if self.clahe is not None:
                img1 = self.clahe.apply(img1)
            curR, stR, _ = cv2.calcOpticalFlowPyrLK(
                img0, img1, cur_pts, None, winSize=(21, 21), maxLevel=3)
            stR = stR.reshape(-1).astype(bool)
            if self.flow_back and stR.any():
                backL, stB, _ = cv2.calcOpticalFlowPyrLK(
                    img1, img0, curR, cur_pts.copy(), winSize=(21, 21),
                    maxLevel=1, flags=cv2.OPTFLOW_USE_INITIAL_FLOW)
                dist = np.linalg.norm(backL - cur_pts, axis=1)
                stR &= stB.reshape(-1).astype(bool) & (dist <= 0.5)
            stR &= self._in_border(curR, img0.shape)
            un_r = self.cam1.undistort_normalize(curR)
            for i in np.nonzero(stR)[0]:
                right[int(self.ids[i])] = un_r[i]

        # normalized coords + velocities (feature_tracker.cpp:405-443)
        un = self.cam0.undistort_normalize(cur_pts)
        dt = (t - self.prev_time) if self.prev_time is not None else 1.0
        out = {}
        new_un = {}
        new_r_un = {}
        for i, fid in enumerate(self.ids):
            fid = int(fid)
            vel = ((un[i] - self.prev_un[fid]) / dt
                   if fid in self.prev_un else np.zeros(2))
            new_un[fid] = un[i]
            pt = np.array([un[i][0], un[i][1], 1.0])
            if fid in right:
                rv = ((right[fid] - self._prev_r_un[fid]) / dt
                      if fid in self._prev_r_un else np.zeros(2))
                new_r_un[fid] = right[fid]
                out[fid] = (pt, vel,
                            np.array([right[fid][0], right[fid][1], 1.0]), rv)
            else:
                out[fid] = (pt, vel, None, np.zeros(2))

        self.prev_img = img0
        self.prev_pts = cur_pts
        self.prev_un = new_un
        self._prev_r_un = new_r_un
        self.prev_time = t
        # compare-and-swap: clear only the snapshot this frame consumed (a
        # concurrent set_prediction must survive for the next frame)
        if self.predict_pts is predict:
            self.predict_pts = None
        return out

    # ------------------------------------------------------------------
    def set_prediction(self, pts: dict[int, np.ndarray]):
        """Motion-model seeds in pixels (reference: setPrediction)."""
        self.predict_pts = pts

    def remove_outliers(self, ids):
        keep = ~np.isin(self.ids, list(ids))
        self.prev_pts = self.prev_pts[keep]
        self.ids = self.ids[keep]
        self.track_cnt = self.track_cnt[keep]

    # ------------------------------------------------------------------
    def _in_border(self, pts, shape, border=1):
        h, w = shape[:2]
        return ((pts[:, 0] >= border) & (pts[:, 0] < w - border)
                & (pts[:, 1] >= border) & (pts[:, 1] < h - border))

    def _mask_and_detect(self, img, cur_pts):
        """Min-distance suppression preferring long tracks, then detect new
        corners in the free area (feature_tracker.cpp:55-84, 177-195)."""
        cv2 = self._cv2
        h, w = img.shape[:2]
        mask = np.full((h, w), 255, np.uint8)
        order = np.argsort(-self.track_cnt) if len(cur_pts) else []
        keep_idx = []
        for i in order:
            x, y = int(cur_pts[i][0]), int(cur_pts[i][1])
            if mask[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]:
                keep_idx.append(i)
                cv2.circle(mask, (x, y), self.min_dist, 0, -1)
        if len(cur_pts):
            keep_idx = np.array(keep_idx, int)
            cur_pts = cur_pts[keep_idx]
            self.ids = self.ids[keep_idx]
            self.track_cnt = self.track_cnt[keep_idx]

        n_new = self.max_cnt - len(cur_pts)
        if n_new > 0:
            new = cv2.goodFeaturesToTrack(img, n_new, 0.01, self.min_dist,
                                          mask=mask)
            if new is not None:
                new = new.reshape(-1, 2).astype(np.float32)
                cur_pts = np.vstack([cur_pts, new]) if len(cur_pts) else new
                nid = np.arange(self.n_id, self.n_id + len(new))
                self.n_id += len(new)
                self.ids = np.concatenate([self.ids, nid])
                self.track_cnt = np.concatenate(
                    [self.track_cnt, np.ones(len(new), np.int32)])
        return cur_pts
