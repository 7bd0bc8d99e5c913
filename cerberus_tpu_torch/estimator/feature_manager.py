"""Fixed-capacity feature track store for the sliding window.

The port's own copy of `cerberus_tpu/estimator/feature_manager.py` (NumPy only), so
that the port imports nothing of the JAX package.

Host-side re-design of the reference's FeatureManager
(reference: src/featureTracker/feature_manager.{h,cpp}): instead of
`list<FeaturePerId>` with per-frame vectors, features live in a fixed pool of
slots backed by numpy arrays that map 1:1 onto the device-side WindowData
feature block — packing for the solver is a masked copy, not a traversal.

Responsibilities (with reference call sites):
  * track bookkeeping + keyframe decision   (feature_manager.cpp:52-119)
  * triangulation (stereo + two-view DLT)   (feature_manager.cpp:302-431)
  * window-slide maintenance incl. depth re-anchoring
                                            (feature_manager.cpp:450-528)
  * outlier / failure removal               (feature_manager.cpp:532-562)
"""

from __future__ import annotations

import numpy as np

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.estimator import pnp

NF = C.NUM_FRAMES
MIN_PARALLAX_DEFAULT = 10.0 / C.FOCAL_LENGTH


class FeatureManager:
    def __init__(self, capacity: int = C.MAX_FEATURES,
                 min_parallax: float = MIN_PARALLAX_DEFAULT):
        self.capacity = capacity
        self.min_parallax = min_parallax
        self.active = np.zeros(capacity, bool)
        self.ids = np.full(capacity, -1, np.int64)
        self.start = np.zeros(capacity, np.int32)
        self.obs = np.zeros((capacity, NF), bool)
        self.stereo = np.zeros((capacity, NF), bool)
        self.pts = np.zeros((capacity, NF, 3))
        self.pts_r = np.zeros((capacity, NF, 3))
        self.vel = np.zeros((capacity, NF, 2))
        self.vel_r = np.zeros((capacity, NF, 2))
        self.td = np.zeros((capacity, NF))
        self.depth = np.full(capacity, -1.0)  # inverse depth; <=0 = uninit
        self.id_to_slot: dict[int, int] = {}
        self.last_track_num = 0
        self.new_feature_num = 0
        self.long_track_num = 0

    # ------------------------------------------------------------------
    def _alloc(self, fid: int, frame: int) -> int:
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            return -1
        s = int(free[0])
        self.active[s] = True
        self.ids[s] = fid
        self.start[s] = frame
        self.obs[s] = False
        self.stereo[s] = False
        self.depth[s] = -1.0
        self.pts[s] = 0
        self.pts_r[s] = 0
        self.vel[s] = 0
        self.vel_r[s] = 0
        self.td[s] = 0
        self.id_to_slot[fid] = s
        return s

    def _release(self, s: int):
        self.active[s] = False
        self.id_to_slot.pop(int(self.ids[s]), None)
        self.ids[s] = -1

    # ------------------------------------------------------------------
    def add_frame(self, frame: int, feats: dict, td: float = 0.0) -> bool:
        """Register observations for `frame`; returns True if keyframe
        (reference: addFeatureCheckParallax, feature_manager.cpp:52-119).

        feats: {id: (pt_left(3,), vel_left(2,), pt_right(3,)|None, vel_right(2,))}
        """
        self.last_track_num = 0
        self.new_feature_num = 0
        self.long_track_num = 0
        for fid, (o0, v0, o1, v1) in feats.items():
            s = self.id_to_slot.get(fid, -1)
            if s < 0 or not self.active[s]:
                s = self._alloc(fid, frame)
                if s < 0:
                    continue
                self.new_feature_num += 1
            else:
                self.last_track_num += 1
                if self.obs[s].sum() + 1 >= 4:
                    self.long_track_num += 1
            self.obs[s, frame] = True
            self.pts[s, frame] = o0
            self.vel[s, frame] = v0
            self.td[s, frame] = td
            if o1 is not None:
                self.stereo[s, frame] = True
                self.pts_r[s, frame] = o1
                self.vel_r[s, frame] = v1

        if frame < 2 or self.last_track_num < 20 or self.long_track_num < 40 \
                or self.new_feature_num > 0.5 * self.last_track_num:
            return True

        # compensated parallax between frame-2 and frame-1
        m = (self.active & (self.start <= frame - 2)
             & self.obs[:, frame - 1] & self.obs[:, frame - 2])
        if not m.any():
            return True
        du = self.pts[m, frame - 2, 0] - self.pts[m, frame - 1, 0]
        dv = self.pts[m, frame - 2, 1] - self.pts[m, frame - 1, 1]
        parallax = np.sqrt(du ** 2 + dv ** 2)
        return float(parallax.mean()) >= self.min_parallax

    # ------------------------------------------------------------------
    def init_frame_pose_by_pnp(self, frame: int, p_w, R_w, tic, ric,
                               min_pts: int = 6, max_jump: float = 1.0):
        """Vision-only pose initialization of `frame` from features with
        solved depth (reference: initFramePoseByPnP,
        feature_manager.cpp:259-300 — seeded at the previous frame's pose;
        plus a RANSAC recovery pass the reference lacks).

        Returns (p_new (3,), R_new (3,3)) for the BODY frame, or None.
        Does not mutate window state — the estimator decides adoption.
        """
        m = (self.active & (self.depth > 0) & self.obs[:, frame])
        slots = np.nonzero(m)[0]
        if len(slots) < min_pts:
            return None
        pts3d = np.empty((len(slots), 3))
        pts2d = np.empty((len(slots), 2))
        for n, s in enumerate(slots):
            sf = int(self.start[s])
            pc = self.pts[s, sf] / self.depth[s]          # anchor cam frame
            pb = ric[0] @ pc + tic[0]                     # anchor body frame
            pts3d[n] = R_w[sf] @ pb + p_w[sf]             # world
            pts2d[n] = self.pts[s, frame, :2]
        # seed: previous frame's camera pose (reference seeds RCam/PCam from
        # frame-1, feature_manager.cpp:283-285)
        prev = max(frame - 1, 0)
        R_seed = R_w[prev] @ ric[0]
        t_seed = R_w[prev] @ tic[0] + p_w[prev]
        R_cam, t_cam, ok, rms = pnp.solve_pnp_gn(pts3d, pts2d, R_seed, t_seed)
        if ok:
            uv, z = pnp.project(R_cam, t_cam, pts3d)
            err = np.linalg.norm(uv - pts2d, axis=1)
            inliers = (err < 5.0 / C.FOCAL_LENGTH) & (z > 0.05)
            ok = inliers.sum() >= max(min_pts, 0.4 * len(slots))
        if not ok:
            # seed-free recovery (no reference equivalent: cv::solvePnP just
            # fails there and the frame keeps its dead-reckoned pose)
            res = pnp.ransac_pnp(pts3d, pts2d)
            if res is None:
                return None
            R_cam, t_cam, _ = res
        # w_T_cam -> w_T_body (reference: feature_manager.cpp:290-292)
        R_new = R_cam @ ric[0].T
        p_new = t_cam - R_new @ tic[0]
        return p_new, R_new

    # ------------------------------------------------------------------
    def triangulate(self, p_w, R_w, tic, ric):
        """Initialize depths of active features lacking one
        (reference: feature_manager.cpp:302-431). p_w/R_w: (11,3)/(11,3,3)
        body poses; tic/ric: (2,3)/(2,3,3).

        Order follows the reference: stereo pair at the anchor frame first
        (feature_manager.cpp:309-345); otherwise multi-view SVD over ALL
        left-cam observations (feature_manager.cpp:379-431 — the reference
        codes this but its branch order only ever reaches a two-view DLT of
        frames i,i+1 (:348-377); here the multi-view form is the live path,
        degrading to two-view DLT when only 2 observations exist)."""
        for s in np.nonzero(self.active)[0]:
            if self.depth[s] > 0:
                continue
            sf = int(self.start[s])
            if not self.obs[s, sf]:
                continue
            P0 = R_w[sf] @ tic[0] + p_w[sf]
            R0 = R_w[sf] @ ric[0]
            frames = np.nonzero(self.obs[s])[0]
            if self.stereo[s, sf]:
                P1 = R_w[sf] @ tic[1] + p_w[sf]
                R1 = R_w[sf] @ ric[1]
                pt = _dlt(P0, R0, self.pts[s, sf], P1, R1, self.pts_r[s, sf])
                z = (R0.T @ (pt - P0))[2]
            elif len(frames) >= 3:
                z = _multiview_depth(self.pts[s], frames, sf, p_w, R_w,
                                     tic[0], ric[0])
            elif len(frames) == 2 and int(frames[-1]) != sf:
                lf = int(frames[-1])
                P1 = R_w[lf] @ tic[0] + p_w[lf]
                R1 = R_w[lf] @ ric[0]
                pt = _dlt(P0, R0, self.pts[s, sf], P1, R1, self.pts[s, lf])
                z = (R0.T @ (pt - P0))[2]
            else:
                continue
            if z < 0.1:
                z = 5.0  # INIT_DEPTH fallback (feature_manager.cpp:425)
            self.depth[s] = 1.0 / z

    # ------------------------------------------------------------------
    def slide_old(self, p0_old, R0_old, p0_new, R0_new, tic, ric):
        """Shift window after marginalizing frame 0; re-anchor depths of
        features that were anchored there (reference removeBackShiftDepth,
        feature_manager.cpp:450-500)."""
        for s in np.nonzero(self.active)[0]:
            if self.start[s] == 0 and self.obs[s, 0]:
                uv = self.pts[s, 0]
                if self.depth[s] > 0:
                    dep = 1.0 / self.depth[s]
                    pts_cam = uv * dep
                    pts_w = R0_old @ (ric[0] @ pts_cam + tic[0]) + p0_old
                    pts_new = ric[0].T @ (R0_new.T @ (pts_w - p0_new) - tic[0])
                    self.depth[s] = 1.0 / pts_new[2] if pts_new[2] > 0.05 else -1.0
            # shift observations left
            self.obs[s, :-1] = self.obs[s, 1:]
            self.obs[s, -1] = False
            self.stereo[s, :-1] = self.stereo[s, 1:]
            self.stereo[s, -1] = False
            for arr in (self.pts, self.pts_r):
                arr[s, :-1] = arr[s, 1:]
                arr[s, -1] = 0
            for arr in (self.vel, self.vel_r):
                arr[s, :-1] = arr[s, 1:]
                arr[s, -1] = 0
            self.td[s, :-1] = self.td[s, 1:]
            self.td[s, -1] = 0
            self.start[s] = max(0, int(self.start[s]) - 1)
            # fix start to the first remaining observation
            frames = np.nonzero(self.obs[s])[0]
            if len(frames) == 0:
                self._release(s)
            else:
                if not self.obs[s, self.start[s]]:
                    self.start[s] = frames[0]
                    self.depth[s] = -1.0

    def slide_new(self):
        """Drop frame W-1 (second newest), move frame W into its place
        (reference removeFront, feature_manager.cpp:502-528)."""
        i, j = C.WINDOW_SIZE - 1, C.WINDOW_SIZE
        for s in np.nonzero(self.active)[0]:
            self.obs[s, i] = self.obs[s, j]
            self.stereo[s, i] = self.stereo[s, j]
            self.pts[s, i] = self.pts[s, j]
            self.pts_r[s, i] = self.pts_r[s, j]
            self.vel[s, i] = self.vel[s, j]
            self.vel_r[s, i] = self.vel_r[s, j]
            self.td[s, i] = self.td[s, j]
            self.obs[s, j] = False
            self.stereo[s, j] = False
            if self.start[s] == j:
                self.start[s] = i
            frames = np.nonzero(self.obs[s])[0]
            if len(frames) == 0:
                self._release(s)

    # ------------------------------------------------------------------
    def remove_failures(self):
        """Drop features whose solved depth went negative
        (reference: removeFailures / solve_flag==2)."""
        for s in np.nonzero(self.active)[0]:
            if self.depth[s] < 0 and self.used_num(s) >= 4:
                # solved to negative depth: failure
                self._release(s)

    def remove_outliers(self, slots):
        for s in slots:
            if self.active[s]:
                self._release(s)

    def used_num(self, s) -> int:
        return int(self.obs[s].sum())

    # ------------------------------------------------------------------
    def export(self):
        """Feature dict for packing.pack_window_data + slot index map.

        Participation rule: used_num >= 4 and initialized depth
        (reference: estimator.cpp:1176-1178)."""
        act = np.nonzero(self.active)[0]
        valid = np.array([self.used_num(s) >= 4 and self.depth[s] > 0
                          for s in act], bool) if len(act) else np.zeros(0, bool)
        feats = dict(
            start=self.start[act], pts=self.pts[act], pts_r=self.pts_r[act],
            vel=self.vel[act], vel_r=self.vel_r[act], td=self.td[act],
            obs=self.obs[act], stereo=self.stereo[act], valid=valid,
        )
        return feats, act

    def depth_vector(self, slots):
        d = self.depth[slots].copy()
        d[d <= 0] = 1.0
        return d

    def set_depths(self, slots, inv_depths):
        for s, d in zip(slots, inv_depths):
            self.depth[s] = float(d)


def _multiview_depth(pts, frames, sf, p_w, R_w, tic0, ric0):
    """Multi-view SVD triangulation: anchor-frame depth from ALL left-cam
    observations (reference: feature_manager.cpp:379-431 — A rows
    f_x * P.row(2) - f_z * P.row(0) per observation, relative to the anchor
    camera; depth = V[2]/V[3])."""
    t0 = R_w[sf] @ tic0 + p_w[sf]
    R0 = R_w[sf] @ ric0
    A = np.zeros((2 * len(frames), 4))
    for n, j in enumerate(frames):
        t1 = R_w[j] @ tic0 + p_w[j]
        R1 = R_w[j] @ ric0
        Rrel = R0.T @ R1                 # anchor-cam <- cam j
        trel = R0.T @ (t1 - t0)
        P = np.zeros((3, 4))
        P[:, :3] = Rrel.T
        P[:, 3] = -Rrel.T @ trel
        f = pts[j] / np.linalg.norm(pts[j])
        A[2 * n] = f[0] * P[2] - f[2] * P[0]
        A[2 * n + 1] = f[1] * P[2] - f[2] * P[1]
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    v = Vt[-1]
    return v[2] / v[3] if abs(v[3]) > 1e-12 else -1.0


def _dlt(P0, R0, uv0, P1, R1, uv1):
    """Two-view DLT triangulation (reference: feature_manager.cpp:208-222).
    Returns the world point."""
    # camera projection matrices world->cam
    T0 = np.eye(4)
    T0[:3, :3] = R0.T
    T0[:3, 3] = -R0.T @ P0
    T1 = np.eye(4)
    T1[:3, :3] = R1.T
    T1[:3, 3] = -R1.T @ P1
    A = np.zeros((4, 4))
    A[0] = uv0[0] * T0[2] - T0[0]
    A[1] = uv0[1] * T0[2] - T0[1]
    A[2] = uv1[0] * T1[2] - T1[0]
    A[3] = uv1[1] * T1[2] - T1[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    return X[:3] / X[3]
