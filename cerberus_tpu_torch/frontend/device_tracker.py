"""Feature tracker on the card, built on ops/klt.py (port of
`cerberus_tpu/frontend/device_tracker.py`).

Same algorithmic pipeline and output format as frontend/tracker.FeatureTracker
(itself mirroring the reference's trackImage, feature_tracker.cpp:94-302):
pyramidal LK with forward-backward check, min-distance masking preferring
long tracks, Shi-Tomasi replenishment, left->right stereo LK, per-feature
normalized-plane velocities.

All per-frame device work — new-frame pyramid, the multi-level LK with
fb-check, greedy min-distance suppression, detection and the stereo pass —
is one program (klt.track_frame) queued without a read-back, with the
previous frame's pyramid carried on the device and images uploaded as
uint8; then ONE small fetch brings the frame's points and flags to the host.
On the card that work and the fetch run on a stream of the tracker's own:
the fetch then waits for the tracker's frame only, not for the estimator's
step queued on the default stream by another thread, and the pyramid carry
is ordered by that one stream.

Slot bookkeeping (ids, track counts) stays on the host — tiny, and keeps the
device program shape-static at max_cnt point slots.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from cerberus_tpu_torch.device import on_stream, resolve_device, side_stream
from cerberus_tpu_torch.ops import klt


def _first_frame(img0_u8, img1_u8, levels, half, iters, min_dist, max_new,
                 fb_thresh, stereo):
    """Frame-0 program: pyramid + unmasked detection + (stereo) left->right
    LK on the detections, so frame 0's features carry right-camera
    observations like every later frame (the reference's trackImage always
    stereo-matches cur_pts, feature_tracker.cpp:202-245)."""
    img0 = img0_u8.to(torch.float32)
    pyr0 = tuple(klt.build_pyramid(img0, levels))
    occ = torch.zeros(img0.shape, dtype=torch.bool, device=img0.device)
    det_pts, det_ok = klt._detect_with_occ(img0, occ, max_new, min_dist)
    if stereo:
        pyr1 = tuple(klt.build_pyramid(img1_u8.to(torch.float32), levels))
        right = klt.lk_track_fb(list(pyr0), list(pyr1), det_pts, det_ok,
                                half=half, iters=iters, fb_thresh=fb_thresh)
        r_pts, r_ok = right.pts, right.status
    else:
        r_pts, r_ok = det_pts, torch.zeros_like(det_ok)
    return dict(det_pts=det_pts, det_ok=det_ok, r_pts=r_pts, r_ok=r_ok,
                pyr0=pyr0)


def _fetch(*xs):
    """One device-to-host copy of float (..., 2) point tensors and bool flag
    tensors, packed as float32; returns them as numpy arrays of their own
    shapes (flags as bool)."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs]).cpu()
    out, at = [], 0
    for x in xs:
        a = flat[at:at + x.numel()].numpy().reshape(x.shape)
        at += x.numel()
        out.append(a.astype(bool) if x.dtype == torch.bool else a)
    return out


class DeviceTracker:
    """Drop-in tracker with FeatureTracker.track()'s output format:
    {id: (pt0 (3,), vel0 (2,), pt1 (3,)|None, vel1 (2,))}, normalized plane.
    Runs on `device`: the card unless the caller names another."""

    def __init__(self, cam0, cam1=None, max_cnt=120, min_dist=10,
                 flow_back=True, levels=4, half=10, iters=10,
                 det_stereo=32, device="cuda"):
        # levels=4 == OpenCV maxLevel=3 (four pyramid images): at 3 levels
        # the coarsest-level motion of a 15 Hz walking sequence exceeds the
        # attraction basin of small blob features (the JAX package's
        # measurement)
        self.cam0, self.cam1 = cam0, cam1
        self.max_cnt, self.min_dist = max_cnt, min_dist
        self.flow_back = flow_back
        self.levels, self.half, self.iters = levels, half, iters
        self.det_stereo = min(det_stereo, max_cnt)
        self.device = resolve_device(device)
        self.stream = side_stream(self.device)
        self.next_id = 0
        # host mirrors of the N compacted live tracks (N <= max_cnt)
        self.ids = np.zeros((0,), np.int64)
        self.track_cnt = np.zeros((0,), np.int64)
        self.prev_pts = np.zeros((0, 2), np.float32)
        self.prev_pyr = None            # pyramid carry, on the device
        self.prev_time = None
        self.prev_un: dict[int, np.ndarray] = {}
        self._prev_r_un: dict[int, np.ndarray] = {}
        self.predict_pts: dict[int, np.ndarray] | None = None
        self.stats = {"dispatches": 0, "frames": 0, "block_ms": 0.0}

    # ------------------------------------------------------------------
    @staticmethod
    def _u8(img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return img

    def _upload(self, img):
        """A uint8 image as a tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(self._u8(img))).to(
            self.device)

    def _pad_slots(self, predict):
        """Pack the compacted host tracks into max_cnt static slots.
        predict: the caller's snapshot of predict_pts (taken once per
        frame so a concurrent set_prediction cannot tear mid-pack)."""
        N = self.max_cnt
        n = len(self.prev_pts)
        pts = np.zeros((N, 2), np.float32)
        pts[:n] = self.prev_pts
        valid = np.zeros((N,), bool)
        valid[:n] = True
        guess = pts.copy()
        if predict:
            for i, fid in enumerate(self.ids):
                if fid in predict:
                    guess[i] = predict[fid]
        prio = np.full((N,), -1, np.int32)
        prio[:n] = np.minimum(self.track_cnt, 2**30)
        return pts, valid, guess, prio

    # ------------------------------------------------------------------
    def track(self, t: float, img0: np.ndarray, img1: np.ndarray | None = None):
        t_wall = time.time()
        stereo = img1 is not None and self.cam1 is not None
        predict = self.predict_pts   # snapshot: see FeatureTracker.track
        fb = 0.5 if self.flow_back else 1e9
        with on_stream(self.stream):
            if self.prev_pyr is None:
                cur_pts, right = self._first(stereo, fb, img0, img1)
            else:
                cur_pts, right = self._next(stereo, fb, img0, img1, predict)
        with record_function("tracker_host"):
            out_d = self._emit(t, cur_pts, right)
        # compare-and-swap: only clear the snapshot this frame consumed — a
        # set_prediction landing from the estimator thread between the
        # snapshot and here must survive for the NEXT frame
        if self.predict_pts is predict:
            self.predict_pts = None
        self.stats["frames"] += 1
        self.stats["block_ms"] += 1000.0 * (time.time() - t_wall)
        return out_d

    def _first(self, stereo, fb, img0, img1):
        """Frame 0: detections only. Returns (cur_pts, right)."""
        with record_function("track_frame"):
            img0_d = self._upload(img0)
            out = _first_frame(
                img0_d, self._upload(img1) if stereo else img0_d,
                self.levels, self.half, self.iters, self.min_dist,
                self.max_cnt, fb, stereo)
            self.stats["dispatches"] += 1
            det_pts, det_ok, r_pts, r_ok = _fetch(
                out["det_pts"], out["det_ok"], out["r_pts"], out["r_ok"])
        self.prev_pyr = out["pyr0"]
        with record_function("tracker_host"):
            didx = np.nonzero(det_ok)[0][: self.max_cnt]
            cur_pts = det_pts[didx].astype(np.float32)
            self.ids = np.arange(self.next_id, self.next_id + len(cur_pts))
            self.next_id += len(cur_pts)
            self.track_cnt = np.zeros(len(cur_pts), np.int64)
            right = {}
            if stereo and len(didx):
                r_sel = np.nonzero(r_ok[didx])[0]
                if len(r_sel):
                    un_r = self.cam1.undistort_normalize(
                        r_pts[didx][r_sel].astype(np.float32))
                    for j, sl in enumerate(r_sel):
                        right[int(self.ids[sl])] = un_r[j]
        return cur_pts, right

    def _next(self, stereo, fb, img0, img1, predict):
        """A later frame: tracks kept, then replenished. Returns (cur_pts,
        right)."""
        with record_function("tracker_host"):
            pts, valid, guess, prio = self._pad_slots(predict)
        with record_function("track_frame"):
            dev = self.device
            img0_d = self._upload(img0)
            out = klt.track_frame(
                self.prev_pyr, img0_d,
                self._upload(img1) if stereo else img0_d,
                torch.from_numpy(pts).to(dev),
                torch.from_numpy(valid).to(dev),
                torch.from_numpy(guess).to(dev),
                torch.from_numpy(prio).to(dev), levels=self.levels,
                half=self.half, iters=self.iters, min_dist=self.min_dist,
                fb_thresh=fb, stereo=stereo, det_stereo=self.det_stereo)
            self.stats["dispatches"] += 1
            # ONE small fetch; the new pyramid stays on the device
            new_pts, keep, det_pts, det_ok, r_pts, r_ok = _fetch(
                out["pts"], out["keep"], out["det_pts"], out["det_ok"],
                out["r_pts"], out["r_ok"])
        self.prev_pyr = out["pyr0"]

        with record_function("tracker_host"):
            N = self.max_cnt
            n = len(self.prev_pts)
            kept = np.nonzero(keep[:n])[0]
            cur_pts = new_pts[kept].astype(np.float32)
            self.ids = self.ids[kept]
            self.track_cnt = self.track_cnt[kept] + 1

            right = {}
            if stereo:
                # stereo rows [0:N] align with the tracked slots
                r_sel = np.nonzero(r_ok[kept])[0]  # rows of cur_pts/self.ids
                if len(r_sel):
                    un_r = self.cam1.undistort_normalize(
                        r_pts[kept][r_sel].astype(np.float32))
                    for j, sl in enumerate(r_sel):
                        right[int(self.ids[sl])] = un_r[j]

            # replenish from the detections; their stereo matches sit at
            # rows [N:N+det_stereo] of r_pts/r_ok (same-frame right obs for
            # new features — see klt.track_frame)
            n_new = self.max_cnt - len(cur_pts)
            if n_new > 0:
                didx = np.nonzero(det_ok)[0][:n_new]
                dets = det_pts[didx].astype(np.float32)
                if len(dets):
                    cur_pts = np.concatenate([cur_pts, dets])
                    new_ids = np.arange(self.next_id,
                                        self.next_id + len(dets))
                    self.next_id += len(dets)
                    self.ids = np.concatenate([self.ids, new_ids])
                    self.track_cnt = np.concatenate(
                        [self.track_cnt, np.zeros(len(dets), np.int64)])
                    if stereo:
                        # stereo rows exist only for the top det_stereo
                        # candidates; adoption order is score order, so in
                        # steady state every adopted detection has a row
                        ok_j = np.nonzero(
                            (didx < self.det_stereo)
                            & r_ok[np.minimum(N + didx,
                                              len(r_ok) - 1)])[0]
                        if len(ok_j):
                            un_r = self.cam1.undistort_normalize(
                                r_pts[N + didx[ok_j]].astype(np.float32))
                            for j, sl in enumerate(ok_j):
                                right[int(new_ids[sl])] = un_r[j]
        return cur_pts, right

    def _emit(self, t, cur_pts, right):
        """The frame's feature dict from the tracks of _first / _next, with
        normalized-plane velocities; advances the host mirrors."""
        un = (self.cam0.undistort_normalize(cur_pts) if len(cur_pts)
              else np.zeros((0, 2)))
        dt = (t - self.prev_time) if self.prev_time is not None else 1.0
        out_d, new_un, new_r_un = {}, {}, {}
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
                out_d[fid] = (pt, vel,
                              np.array([right[fid][0], right[fid][1], 1.0]),
                              rv)
            else:
                out_d[fid] = (pt, vel, None, np.zeros(2))
        self.prev_pts = cur_pts
        self.prev_un, self._prev_r_un = new_un, new_r_un
        self.prev_time = t
        return out_d

    def set_prediction(self, pts: dict[int, np.ndarray]):
        self.predict_pts = pts
