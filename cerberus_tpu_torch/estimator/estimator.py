"""Sliding-window VILO estimator: host orchestration over the port's device
functions (port of `cerberus_tpu/estimator/estimator.py`).

Re-design of the reference's Estimator class
(reference: src/estimator/estimator.{h,cpp}): a thin host loop that (a)
buffers sensor samples per inter-keyframe interval, (b) calls the device
functions for preintegration and the window solve, and (c) makes the
discrete keyframe / marginalize / slide decisions on the host.

Pipeline per camera frame (reference: processMeasurements + processImage,
estimator.cpp:400-846):
  1. drain the 500 Hz IMU+leg buffer into the newest interval
     [processIMULeg]
  2. feature bookkeeping + keyframe decision      [addFeatureCheckParallax]
  3. INITIAL phase: PnP-seeded poses, triangulation; at frame 10 the window
     solve with biases free, then every interval re-preintegrated at the
     solved biases and solved again
  4. NON_LINEAR: one per-frame step (`_streaming_step`): newest-interval
     preintegration -> WindowData -> LM solve -> reprojection errors ->
     3 px gate -> marginalization -> prior frame shift -> (non-keyframe)
     spliced re-preintegration, with no read-back to the host inside it;
     then ONE fetch of (state, errors, solve info) at the next frame's
     entry, and the host's outlier removal and window slide.

The port runs eagerly: the JAX package's jitted, cached closures are plain
functions here. Sensor synchronisation is the Python `PySensorSync` (the JAX
package's C++ `native.SensorSync` is not ported). Left out: the debug cost
breakdown and the metrics logger hooks (diagnostics of the evals), and
`_reject_outliers`, which nothing calls.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from cerberus_tpu_torch import config as C
from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.device import full_f32_matmuls, resolve_device
from cerberus_tpu_torch.estimator.feature_manager import FeatureManager
from cerberus_tpu_torch.estimator.packing import (build_window_data,
                                                  coerce_preints,
                                                  default_free_mask,
                                                  pack_window_data,
                                                  pad_features, zero_prior)
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.ops import marginalize as marg
from cerberus_tpu_torch.ops.preintegration import (ILPreint, PreintParams,
                                                   il_preintegrate_parallel)
from cerberus_tpu_torch.ops.solver import SolveOptions, solve_window
from cerberus_tpu_torch.utils import lie

NF = C.NUM_FRAMES
MARGIN_OLD, MARGIN_SECOND_NEW = 0, 1
INIT_ITERS = 20   # LM iterations of each initialization solve


def _preint_kernel(raw: dict, ba, bg, rho, params: PreintParams,
                   ff_init=None) -> ILPreint:
    """il_preintegrate_parallel of one padded raw buffer (tensors), at full
    float32 matmul precision (the JAX package pins 'highest' here: the small
    d eps / d rho terms are the rho-calibration signal)."""
    with full_f32_matmuls():
        return il_preintegrate_parallel(
            raw["dt"], raw["acc"], raw["gyr"], raw["phi"], raw["dphi"],
            raw["c"], raw["mask"], ba, bg, rho, params, ff_init=ff_init)


def _fold_preint(raw, pres, slot, ba, bg, rho, params):
    """Preintegrate a raw buffer, threading the adaptive foot-force tracker
    from the previous interval's preintegration (a zero placeholder there
    gives the cold start)."""
    prev = pres[slot - 1]
    ff = (prev.ff_min, prev.ff_max, prev.ff_window, prev.ff_idx)
    return _preint_kernel(raw, ba, bg, rho, params, ff_init=ff)


def _streaming_step(st0, pres, ivalid, feats_pad, prior, free_mask, gravity,
                    calib, raw9, raw8, params, *, max_iters: int, mode: str,
                    use_leg_odom: bool, marg_td_info: bool) -> dict:
    """The one per-frame program of the NON_LINEAR phase (the JAX package's
    `_streaming_kernel`): newest-interval preintegration -> WindowData ->
    LM solve -> reprojection errors -> 3 px gate -> marginalization ->
    prior frame shift -> (non-keyframe) spliced re-preintegration.

    Every argument is a tensor (or a dict / tuple of tensors) on one device;
    nothing here copies from the host or reads back, so on the card the
    whole step is queued without waiting for it. Profiler spans:
    `preint_fold` (both folds), `build_window_data`, the solver's
    `lm_solve`, `reproj_gate` and `marginalize`.

    mode: 'old' (MARGIN_OLD), 'new' (MARGIN_SECOND_NEW with a live prior),
      'none' (MARGIN_SECOND_NEW without a prior).
    raw9: padded raw buffer of the newest interval, preintegrated here at
      frame 9's linearization; None = interval 9 preintegrated already or
      absent.
    raw8: padded merged interval-8+9 buffer of the MARGIN_SECOND_NEW splice
      (reference: estimator.cpp:1567-1652), preintegrated here at the SOLVED
      frame-8 linearization; None = no splice.
    Returns dict(st, info, errs[, pre9][, prior][, pre8m])."""
    opts = SolveOptions(max_iters=max_iters)
    dtype = st0.p.dtype
    pre9 = None
    if raw9 is not None:
        with record_function("preint_fold"):
            pre9 = _fold_preint(raw9, pres, 9, st0.ba[9], st0.bg[9],
                                st0.rho[9], params)
        pres = tuple(pres[:9]) + (pre9,)
    with full_f32_matmuls():
        with record_function("build_window_data"):
            data = build_window_data(
                pres, ivalid, feats_pad, prior, free_mask, gravity, calib,
                use_leg_odom=use_leg_odom, cov_jitter=1e-14, dtype=dtype)
        st, info = solve_window(st0, data, opts)
        with record_function("reproj_gate"):
            errs = fac.feature_reproj_errors(st, data)
            # per-feature average reprojection gate — the reference's own
            # rule (ave_err * FOCAL_LENGTH > 3, estimator.cpp:1794-1796)
            # applied on the device so the marginalization sees the gated
            # feature set
            gate = data.f_valid & (errs * C.FOCAL_LENGTH > 3.0)
            data2 = data._replace(f_valid=data.f_valid & ~gate)
        out = dict(st=st, info=info, errs=errs)
        if pre9 is not None:
            out["pre9"] = pre9
        if mode != "none":
            with record_function("marginalize"):
                if mode == "old":
                    pj, pr, valid = marg.marginalize_old(st, data2)
                    lin = _shift_state(st)
                else:
                    pj, pr, valid = marg.marginalize_second_new(st, data2)
                    lin = _shift_state_second_new(st)
                if not marg_td_info:
                    pj[:, fac.TD_OFF] = 0.0
                # validity folded in on the device (a zeroed prior is a
                # skipped prior, reference estimator.cpp:1107) without
                # reading it back
                pj = torch.where(valid, pj, torch.zeros_like(pj))
                pr = torch.where(valid, pr, torch.zeros_like(pr))
            out["prior"] = (pj, pr, lin, valid)
    if raw8 is not None:
        with record_function("preint_fold"):
            out["pre8m"] = _fold_preint(raw8, pres, 8, st.ba[8], st.bg[8],
                                        st.rho[8], params)
    return out


def _fetch(st: fac.WindowState, info, errs=None):
    """ONE device-to-host copy of (state, solve info[, errors]): every
    tensor flattened to float64 (exact for these floats and int32 counts)
    and concatenated. Returns (WindowState of numpy arrays, info with numpy
    fields and `accepted` an int, errs or None)."""
    parts = list(st) + list(info) + ([] if errs is None else [errs])
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in parts])
    host = flat.cpu().numpy()
    out, i = [], 0
    for x in parts:
        out.append(host[i:i + x.numel()].reshape(tuple(x.shape)))
        i += x.numel()
    nst, ninfo = len(st), len(info)
    info_np = type(info)(*out[nst:nst + ninfo])
    info_np = info_np._replace(accepted=int(info_np.accepted))
    return (fac.WindowState(*out[:nst]), info_np,
            None if errs is None else out[-1])


@dataclass
class IntervalBuffer:
    """Raw 500 Hz samples of one inter-keyframe interval (incl. boundary
    sample shared with the previous interval)."""
    t: list = field(default_factory=list)
    acc: list = field(default_factory=list)
    gyr: list = field(default_factory=list)
    phi: list = field(default_factory=list)
    dphi: list = field(default_factory=list)
    c: list = field(default_factory=list)

    def append(self, t, acc, gyr, phi, dphi, c):
        self.t.append(t)
        self.acc.append(np.asarray(acc))
        self.gyr.append(np.asarray(gyr))
        self.phi.append(np.asarray(phi))
        self.dphi.append(np.asarray(dphi))
        self.c.append(np.asarray(c))

    def __len__(self):
        return len(self.t)


class PySensorSync:
    """Sensor ring buffer with boundary interpolation: all samples in
    (t0, t1], plus boundary samples lerped to exactly t0 / t1 when
    neighbors exist (contacts snap to the nearest sample). Modeled on the
    reference's boundary interpolation (utility.cpp:24-104
    lerpGyro/lerpLegSensors used by getIMUAndLegInterval,
    estimator.cpp:303-397)."""

    COLS = 35  # t, acc3, gyr3, phi12, dphi12, contact4

    def __init__(self, capacity: int = 1 << 20):
        self.buf: list[np.ndarray] = []
        self.capacity = capacity

    def push(self, t, acc, gyr, phi, dphi, contact):
        row = np.empty(self.COLS)
        row[0] = t
        row[1:4] = acc
        row[4:7] = gyr
        row[7:19] = phi
        row[19:31] = dphi
        row[31:35] = contact
        self.buf.append(row)
        if len(self.buf) > self.capacity:
            del self.buf[: len(self.buf) - self.capacity]

    def latest_time(self) -> float:
        return self.buf[-1][0] if self.buf else -1.0

    @staticmethod
    def _lerp(a, b, t):
        w = (t - a[0]) / (b[0] - a[0] + 1e-18)
        out = a + (b - a) * w
        out[0] = t
        out[31:35] = a[31:35] if w < 0.5 else b[31:35]  # snap flags
        return out

    def extract(self, t0: float, t1: float, max_out: int = 4096):
        """Rows (n, 35) for (t0, t1] with boundary lerp, or None if the
        stream has not yet reached t1. Consumes rows older than the last
        interval so the next extract can still boundary-interpolate."""
        if not self.buf or self.buf[-1][0] < t1:
            return None
        rows = []
        i, n = 0, len(self.buf)
        prev = None
        while i < n and self.buf[i][0] <= t0:
            prev = self.buf[i]
            i += 1
        if prev is not None and i < n:
            rows.append(self._lerp(prev, self.buf[i], t0))
        while i < n and self.buf[i][0] <= t1:
            rows.append(self.buf[i])
            prev = self.buf[i]
            i += 1
        if i < n and prev is not None and prev[0] < t1:
            rows.append(self._lerp(prev, self.buf[i], t1))
        if i > 1:
            del self.buf[: i - 1]
        if len(rows) > max_out:
            rows = rows[:max_out]
        return np.stack(rows) if rows else np.zeros((0, self.COLS))


class Estimator:
    INITIAL, NON_LINEAR = 0, 1

    def __init__(self, cfg: EstimatorConfig | None = None,
                 max_samples: int = 128, dtype=torch.float64,
                 device="cuda", pipeline: bool = True):
        # max_samples: padded per-interval sample capacity. At 500 Hz / 15 Hz
        # an interval holds ~34 samples; MARGIN_SECOND_NEW merges consecutive
        # non-keyframe intervals, so 128 covers ~3 merges. Overflow truncates
        # the oldest samples (reference keeps unbounded std::vectors,
        # estimator.h:141-149).
        self.cfg = cfg or EstimatorConfig()
        self.dtype = dtype
        self.device = resolve_device(device)
        self.S = max_samples
        self.pipeline = pipeline
        self.params = PreintParams.from_config(self.cfg, dtype,
                                               device=self.device)
        self.F = self.cfg.max_features
        self.fm = FeatureManager(self.F, self.cfg.min_parallax)
        self.clear_state()

    def _dev(self, x, dtype=None):
        """A host array (or scalar) as a tensor on the estimator's device;
        float arrays take the estimator's dtype."""
        a = np.asarray(x)
        if dtype is None:
            dtype = self.dtype if a.dtype.kind == "f" else None
        return torch.tensor(a, dtype=dtype, device=self.device)

    def _dev_raw(self, raw: dict | None):
        return None if raw is None else {k: self._dev(v)
                                         for k, v in raw.items()}

    # ------------------------------------------------------------------
    def clear_state(self):
        """Full reboot (reference: clearState, estimator.cpp:24-110)."""
        cfg = self.cfg
        ric, tic = cfg.ric_tic(n=2)  # state always holds 2 cams (mono masks)
        self.p = np.zeros((NF, 3))
        self.q = np.tile([1.0, 0, 0, 0], (NF, 1))
        self.v = np.zeros((NF, 3))
        self.ba = np.zeros((NF, 3))
        self.bg = np.zeros((NF, 3))
        self.rho = np.tile(cfg.robot.rho_init(), (NF, 1))
        self.tic = tic.copy()
        self.qic = np.stack([_rot_to_quat_np(ric[i]) for i in range(2)])
        self.td = cfg.td
        self.headers = np.zeros(NF)

        self.frame_count = 0
        self.solver_flag = self.INITIAL
        self.first_imu = False
        self.open_ex_estimation = False

        self.buffers: list[IntervalBuffer | None] = [None] * 10
        self.preints = [None] * 10
        self.prior = None          # (J, r, lin_state, valid), on the device
        self.prev_img_t = None
        self._pending = None       # dispatched, not yet adopted step
        self._pending_frames = []  # frames waiting for proprio to reach t+td
        self._last_raw = None      # (acc, gyr) of the newest pushed sample
        self.sync = PySensorSync()
        self.fm = FeatureManager(self.F, self.cfg.min_parallax)

        # IMU-rate fast prediction state (reference: fastPredictIMU)
        self.latest = None
        self._last_pose = None
        self.keyframe_callback = None  # fn(t, p, q, ids, {id: (uv, world)})
        self.predict_callback = None   # fn({feature_id: pts_cam(3,)})
        self.predicted_pts: dict[int, np.ndarray] = {}
        # reboots survive clear_state so replays can report recovery events
        # (reference: failureDetection -> clearState, estimator.cpp:823-831)
        prev_stats = getattr(self, "stats", {})
        self.stats = {"solves": 0, "solve_time": 0.0, "keyframes": 0,
                      "reboots": prev_stats.get("reboots", 0),
                      "dispatches": 0,
                      "init_solves": prev_stats.get("init_solves", 0)}
        if "failure_reasons" in prev_stats:
            self.stats["failure_reasons"] = prev_stats["failure_reasons"]

        # static per-config step arguments, on the device once
        cw = np.zeros(13)
        if cfg.ex_prior_sigma_t > 0:
            cw[[0, 1, 2, 6, 7, 8]] = 1.0 / cfg.ex_prior_sigma_t
        if cfg.ex_prior_sigma_r > 0:
            cw[[3, 4, 5, 9, 10, 11]] = 1.0 / cfg.ex_prior_sigma_r
        if cfg.td_prior_sigma > 0:
            cw[12] = 1.0 / cfg.td_prior_sigma
        ric_ref, tic_ref = cfg.ric_tic(n=2)
        qic_ref = np.stack([_rot_to_quat_np(ric_ref[i]) for i in range(2)])
        self._calib_base = (tic_ref, qic_ref, cw)
        self._calib_dev = (self._dev(tic_ref), self._dev(qic_ref),
                           self._dev(cw))
        self._gravity = np.array([0.0, 0.0, cfg.g_norm])
        self._gravity_dev = self._dev(self._gravity)

    @property
    def _calib(self):
        """Calibration prior for the solve. Extrinsics anchor at the
        factory calibration; td anchors at the RUNNING estimate — a
        per-solve damper, not an absolute anchor (the reference has no td
        prior at all, estimator.cpp:1097-1105)."""
        tic_ref, qic_ref, cw = self._calib_base
        return (tic_ref, qic_ref, self.td, cw)

    # ------------------------------------------------------------------
    def input_imu_leg(self, t, acc, gyr, phi, dphi, contact):
        """500 Hz proprioceptive tick (reference: inputIMU + inputLeg,
        estimator.cpp:255-300)."""
        self.sync.push(t, acc, gyr, phi, dphi, contact)
        self._last_raw = (np.asarray(acc, float), np.asarray(gyr, float))
        if self.latest is not None:
            self._fast_predict(t, np.asarray(acc), np.asarray(gyr))
        # drain frames that were waiting for the proprio stream to reach
        # their exposure instant t_img + td (reference: processMeasurements
        # spin-waits on IMUAvailable(curTime), estimator.cpp:414-429)
        while (self._pending_frames
               and self.sync.latest_time() >= self._pending_frames[0][0]
               + self.td):
            t_img, feats = self._pending_frames.pop(0)
            self._process_image(t_img, feats)

    def _fast_predict(self, t, acc, gyr):
        """IMU-rate forward propagation of the newest state
        (reference: fastPredictIMU, estimator.cpp:1800-1840)."""
        L = self.latest
        dt = t - L["t"]
        if dt <= 0:
            return
        g = np.array([0, 0, self.cfg.g_norm])
        q = L["q"]
        un_acc_0 = _rot_np(q, L["acc"] - L["ba"]) - g
        un_gyr = 0.5 * (L["gyr"] + gyr) - L["bg"]
        q = _quat_mul_np(q, _delta_q_np(un_gyr * dt))
        un_acc_1 = _rot_np(q, acc - L["ba"]) - g
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        L["p"] = L["p"] + dt * L["v"] + 0.5 * dt * dt * un_acc
        L["v"] = L["v"] + dt * un_acc
        L["q"], L["t"], L["acc"], L["gyr"] = q, t, acc, gyr

    # ------------------------------------------------------------------
    def input_image(self, t, feats: dict):
        """15 Hz camera tick. feats: {id: (pt0(3,), vel0(2,), pt1|None, vel1)}.

        If the proprioceptive stream has not yet reached the frame's
        exposure instant t + td, the frame is queued and processed from the
        sensor tick that completes its interval (see input_imu_leg); past
        10 queued frames the oldest is processed anyway (vision only)."""
        if (self.cfg.use_imu and self.frame_count > 0
                and self.sync.latest_time() < t + self.td):
            self._pending_frames.append((t, feats))
            self.stats["deferred_frames"] = \
                self.stats.get("deferred_frames", 0) + 1
            if len(self._pending_frames) > 10:
                t_old, f_old = self._pending_frames.pop(0)
                self.stats["stalled_frames"] = \
                    self.stats.get("stalled_frames", 0) + 1
                self._process_image(t_old, f_old)
            return
        self._process_image(t, feats)

    def _process_image(self, t, feats: dict):
        # adopt the previous frame's dispatched step FIRST: the deferred
        # slide must consume buffers/preints before this frame's
        # _close_interval overwrites them
        self._finish_pending()
        fc = self.frame_count
        if not self.cfg.stereo:
            # mono mode: drop right-cam observations (changeSensorType)
            feats = {fid: (o0, v0, None, v1)
                     for fid, (o0, v0, o1, v1) in feats.items()}
        # 1. interval measurements + preintegration + state propagation,
        # drained to t + td (reference: curTime = t + td, estimator.cpp:414)
        if fc > 0:
            k = fc - 1 if self.solver_flag == self.INITIAL else 9
            self._close_interval(
                k, t + self.td,
                defer_preint=(self.solver_flag == self.NON_LINEAR
                              and self.cfg.use_imu))
            stale = self.cfg.use_imu and self._imu_stale(self.buffers[k])
            if stale:
                # hung IMU driver (identical consecutive samples): the
                # interval's inertial factor is dropped and the frame rides
                # vision (PnP fallback)
                self.stats["stale_imu_intervals"] = \
                    self.stats.get("stale_imu_intervals", 0) + 1
                if self.solver_flag != self.NON_LINEAR:
                    self.preints[k] = None
            elif self.cfg.use_imu:
                self._propagate_frame(k)
            else:
                # no dead-reckoning available: seed with previous pose,
                # PnP below refines (estimator.cpp:806-808)
                j = (fc if self.solver_flag == self.INITIAL
                     else C.WINDOW_SIZE)
                for arr in (self.p, self.q, self.v):
                    arr[j] = arr[j - 1]
        elif self.cfg.use_imu:
            # consume the pending buffer up to t for gravity alignment
            self._init_first_pose(t)
        else:
            self.prev_img_t = t
        self.headers[min(fc, NF - 1)] = t

        # 2. feature bookkeeping + keyframe decision; each observation
        # records the running td (feature_manager.h:33-46)
        is_kf = self.fm.add_frame(min(fc, NF - 1), feats, self.td)
        margin_flag = MARGIN_OLD if is_kf else MARGIN_SECOND_NEW
        if is_kf:
            self.stats["keyframes"] += 1

        ric, tic_, p_w, R_w = self._poses_np()
        if self.solver_flag == self.INITIAL:
            # per-frame PnP pose seeding during init (estimator.cpp:736)
            fi = min(fc, NF - 1)
            if fi > 0:
                res = self.fm.init_frame_pose_by_pnp(fi, p_w, R_w, tic_, ric)
                if res is not None:
                    self.p[fi], R_w[fi] = res[0], res[1]
                    self.q[fi] = _rot_to_quat_np(res[1])
                    p_w[fi] = res[0]
            self.fm.triangulate(p_w, R_w, tic_, ric)
            if fc == C.WINDOW_SIZE:
                self._initialize()
                self._post_solve(margin_flag)
                self.solver_flag = self.NON_LINEAR
            else:
                self.frame_count += 1
                # replicate newest state (estimator.cpp:793-804)
                for arr in (self.p, self.q, self.v, self.ba, self.bg, self.rho):
                    arr[self.frame_count] = arr[self.frame_count - 1]
        else:
            # PnP as a recovery watchdog every 3rd frame, and always when
            # dead-reckoning is unavailable or suspect (no IMU, stale
            # interval); adopted when it disagrees strongly with it
            want_pnp = (not self.cfg.use_imu or stale
                        or (self.cfg.pnp_fallback
                            and self.stats["solves"] % 3 == 0))
            if want_pnp:
                res = self.fm.init_frame_pose_by_pnp(C.WINDOW_SIZE, p_w, R_w,
                                                     tic_, ric)
                if res is not None:
                    dp = np.linalg.norm(res[0] - self.p[C.WINDOW_SIZE])
                    dang = _rot_angle_np(
                        R_w[C.WINDOW_SIZE].T @ res[1])
                    if not self.cfg.use_imu or stale or dp > 0.3 \
                            or dang > 0.26:
                        self.p[C.WINDOW_SIZE], R_w[C.WINDOW_SIZE] = res
                        self.q[C.WINDOW_SIZE] = _rot_to_quat_np(res[1])
                        p_w[C.WINDOW_SIZE] = res[0]
            self.fm.triangulate(p_w, R_w, tic_, ric)
            t0 = time.time()
            self._dispatch_step(t, t0, margin_flag, is_kf)
            if not self.pipeline:
                self._finish_pending()
                if self.solver_flag == self.INITIAL:   # reboot fired
                    return
        self._update_latest(t)

    def _dispatch_step(self, t, t0, margin_flag, is_kf):
        """Move the frame's inputs to the device and queue its step; the
        fetch and the post-solve host work run at the next frame's entry
        (pipelined adoption, the reference's own split of optimization and
        output, estimator.cpp:133-137, 1800-1840)."""
        feats_d, slots = self.fm.export()
        feats_pad = {k: self._dev(v)
                     for k, v in pad_features(feats_d, self.F).items()}
        depths = self.fm.depth_vector(slots)
        st0 = self._window_state(depths)
        mode = ("old" if margin_flag == MARGIN_OLD
                else ("new" if self.prior is not None else "none"))
        # newest-interval raw samples, preintegrated IN the step
        raw9 = raw8 = None
        stale9 = self.cfg.use_imu and self._imu_stale(self.buffers[9])
        if self.cfg.use_imu and self.preints[9] is None \
                and self.buffers[9] is not None and not stale9:
            raw9 = self._pad_buffer(self.buffers[9])
        if mode != "old" and self.cfg.use_imu and not stale9:
            # splice buffer for the post-solve MARGIN_SECOND_NEW slide
            b8, b9 = self.buffers[8], self.buffers[9]
            if b8 is not None and b9 is not None and len(b8) and len(b9):
                self._merged_buffer = _merge_buffers(b8, b9)
                raw8 = self._pad_buffer(self._merged_buffer)
        pres, ivalid = coerce_preints(
            self.preints if self.cfg.use_imu else [None] * 10, self.dtype,
            device=self.device)
        if raw9 is not None:
            ivalid = ivalid.copy()
            ivalid[9] = True
        prior_t = self.prior if self.prior is not None \
            else zero_prior(self.F, self.dtype, device=self.device)
        tic_ref, qic_ref, cw = self._calib_dev
        calib = (tic_ref, qic_ref, self._dev(self.td), cw)
        free_mask = self._dev(self._free_mask())
        self.stats["pack_time"] = self.stats.get("pack_time", 0.0) \
            + (time.time() - t0)
        t1 = time.time()
        out = _streaming_step(
            st0, pres, self._dev(ivalid), feats_pad, prior_t, free_mask,
            self._gravity_dev, calib, self._dev_raw(raw9),
            self._dev_raw(raw8), self.params,
            max_iters=self.cfg.max_num_iterations, mode=mode,
            use_leg_odom=self.cfg.use_leg_odom,
            marg_td_info=self.cfg.marg_td_info)
        self.stats["dispatches"] = self.stats.get("dispatches", 0) + 1
        # the in-step preint stays on the device for the next frame (the
        # deferred slide reads preints[9] before close_interval overwrites it)
        if "pre9" in out:
            self.preints[9] = out["pre9"]
        self._pending = dict(out=out, slots=slots, feats_d=feats_d,
                             margin_flag=margin_flag, t=t, t0=t0, t1=t1,
                             is_kf=is_kf)

    def _finish_pending(self):
        """The one fetch of the previously dispatched step and the
        post-solve host bookkeeping. Runs at the next frame's entry, or
        from flush()."""
        pend = self._pending
        if pend is None:
            return
        self._pending = None
        out, slots, feats_d = pend["out"], pend["slots"], pend["feats_d"]
        margin_flag, t0, t1 = pend["margin_flag"], pend["t0"], pend["t1"]
        tf = time.time()
        st_np, info, errs = _fetch(out["st"], out["info"], out["errs"])
        self.stats["solve_only_time"] = \
            self.stats.get("solve_only_time", 0.0) + (time.time() - t1)
        self.stats["block_time"] = self.stats.get("block_time", 0.0) \
            + (time.time() - tf)
        self._adopt(st_np, slots, feats_d)
        self.last_info = info
        self.stats["solve_time"] += time.time() - t0
        self.stats["solves"] += 1

        # host-side outlier bookkeeping — the SAME 3 px average-error rule
        # the step applied on the device before marginalizing
        # (reference: ave_err * FOCAL_LENGTH > 3, estimator.cpp:1794-96)
        errs = errs[: len(slots)]
        bad_local = [n for n in range(len(slots))
                     if feats_d["valid"][n]
                     and errs[n] * C.FOCAL_LENGTH > 3.0]
        self.fm.remove_outliers([slots[n] for n in bad_local])

        if self.predict_callback is not None:
            self._predict_next_frame()
        if self.failure_detection():
            # system reboot (reference: estimator.cpp:823-831), with pose
            # continuity (see _rebase_world)
            self.stats["reboots"] += 1
            self._rebase_world()
            self.clear_state()
            return
        if "prior" in out:
            self.prior = out["prior"]
        self._emit_keyframe_and_slide(margin_flag, pre8m=out.get("pre8m"))
        self.fm.remove_failures()

    def flush(self):
        """Adopt any dispatched step (end of stream, or before reading the
        solved state)."""
        self._finish_pending()

    # ------------------------------------------------------------------
    def _init_first_pose(self, t):
        """Gravity-align the first frame (reference: initFirstIMUPose,
        estimator.cpp:524-544)."""
        t_ext = min(t, self.sync.latest_time())
        rows = self.sync.extract(-1e18, t_ext) if t_ext > -1e17 else None
        self.prev_img_t = t
        if rows is None or len(rows) == 0:
            return
        acc_mean = rows[:, 1:4].mean(axis=0)
        # g2R(acc): body->world rotation putting measured gravity on +z with
        # zero yaw
        R0 = lie.g_to_rot(torch.as_tensor(acc_mean)).numpy()
        self.q[0] = _rot_to_quat_np(R0)

    def _close_interval(self, k: int, t_img, defer_preint: bool = False):
        """Move the samples spanning (prev image, this image] into interval
        k's buffer and preintegrate (reference: getIMUAndLegInterval,
        estimator.cpp:303-397).

        defer_preint: streaming path — leave preints[k] unset; the
        per-frame step preintegrates the raw buffer."""
        rows = self.sync.extract(self.prev_img_t, t_img)
        self.prev_img_t = t_img
        buf = IntervalBuffer()
        if rows is not None:
            for r in rows:
                buf.append(r[0], r[1:4], r[4:7], r[7:19], r[19:31],
                           r[31:35])
        self.buffers[k] = buf
        if defer_preint:
            self.preints[k] = None
        else:
            self.preints[k] = self._run_preint(buf, self.ba[k], self.bg[k],
                                               self.rho[k],
                                               prev=self.preints[k - 1]
                                               if k > 0 else None)

    def _imu_stale(self, buf: IntervalBuffer | None,
                   frac: float = 0.25) -> bool:
        """True if a CONSECUTIVE RUN of bitwise-identical IMU samples (acc
        AND gyr) covers more than `frac` of the interval — the signature of
        a hung driver repeating its last reading. cfg.stale_imu_guard=False
        restores the reference's semantics (it integrates the hang,
        estimator.cpp:554-653); the first fire logs a warning."""
        if not getattr(self.cfg, "stale_imu_guard", True):
            return False
        if buf is None or len(buf) < 4:
            return False
        acc = np.asarray(buf.acc)
        gyr = np.asarray(buf.gyr)
        rep = np.all(acc[1:] == acc[:-1], axis=1) \
            & np.all(gyr[1:] == gyr[:-1], axis=1)
        best = cur = 0
        for r in rep:
            cur = cur + 1 if r else 0
            best = max(best, cur)
        stale = best >= max(4, frac * len(buf))
        if stale and not self.stats.get("stale_imu_intervals"):
            logging.getLogger("cerberus_tpu_torch").warning(
                "stale IMU interval detected (%d identical consecutive "
                "samples of %d): dropping inertial factor, riding vision",
                best + 1, len(buf))
        return stale

    def _pad_buffer(self, buf: IntervalBuffer):
        """Pad a raw interval buffer into fixed-size numpy arrays.

        Returns dict(dt, acc, gyr, phi, dphi, c, mask) with leading dim S
        (48 or max_samples), or None if the buffer holds < 2 samples."""
        n = len(buf)
        if n < 2:
            return None
        n = min(n, self.S)
        S = next((b for b in (48, self.S) if n <= b and b <= self.S), self.S)
        dt = np.zeros(S)
        arr = {k: np.zeros((S,) + np.asarray(getattr(buf, k)[0]).shape)
               for k in ("acc", "gyr", "phi", "dphi", "c")}
        ts = np.asarray(buf.t[:n])
        dt[1:n] = np.diff(ts)
        for key in arr:
            vals = getattr(buf, key)[:n]
            arr[key][:n] = np.stack(vals)
            arr[key][n:] = arr[key][n - 1]
        mask = np.zeros(S, bool)
        mask[1:n] = True
        return dict(dt=dt, mask=mask, **arr)

    def _run_preint(self, buf: IntervalBuffer, ba, bg, rho, prev=None):
        """prev: the previous interval's ILPreint — its final adaptive
        foot-force tracker state seeds this interval. None = cold start."""
        raw = self._pad_buffer(buf)
        if raw is None:
            return None
        self.stats["dispatches"] = self.stats.get("dispatches", 0) + 1
        ff_init = (None if prev is None else
                   (prev.ff_min, prev.ff_max, prev.ff_window, prev.ff_idx))
        return _preint_kernel(self._dev_raw(raw), self._dev(ba),
                              self._dev(bg), self._dev(rho), self.params,
                              ff_init=ff_init)

    def _propagate_frame(self, k: int):
        """Initialize frame k+1 by midpoint dead-reckoning through interval
        k's RAW samples, on the host (reference: processIMULeg forward
        propagation, estimator.cpp:639-646). The result only seeds the LM
        solve."""
        buf = self.buffers[k]
        if buf is None or len(buf) < 2:
            return
        i, j = k, k + 1
        g = np.array([0, 0, self.cfg.g_norm])
        ba, bg = self.ba[i], self.bg[i]
        q = self.q[i].copy()
        p = self.p[i].copy()
        v = self.v[i].copy()
        acc_p, gyr_p = buf.acc[0], buf.gyr[0]
        for n in range(1, len(buf)):
            dt = buf.t[n] - buf.t[n - 1]
            acc_c, gyr_c = buf.acc[n], buf.gyr[n]
            un_acc_0 = _rot_np(q, acc_p - ba) - g
            un_gyr = 0.5 * (gyr_p + gyr_c) - bg
            q = _quat_mul_np(q, _delta_q_np(un_gyr * dt))
            un_acc_1 = _rot_np(q, acc_c - ba) - g
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            p = p + dt * v + 0.5 * dt * dt * un_acc
            v = v + dt * un_acc
            acc_p, gyr_p = acc_c, gyr_c
        self.q[j] = q / np.linalg.norm(q)
        self.p[j] = p
        self.v[j] = v
        self.ba[j] = self.ba[i]
        self.bg[j] = self.bg[i]
        self.rho[j] = self.rho[i]

    # ------------------------------------------------------------------
    def _poses_np(self):
        ric = np.stack([_quat_to_rot_np(self.qic[i]) for i in range(2)])
        R_w = np.stack([_quat_to_rot_np(self.q[i]) for i in range(NF)])
        return ric, self.tic, self.p.copy(), R_w

    def _window_state(self, depths) -> fac.WindowState:
        """The window's state on the device, copied (torch.tensor, never an
        alias of the host arrays that the slide updates in place)."""
        d = np.ones(self.F)
        d[: len(depths)] = depths
        a = self._dev
        return fac.WindowState(
            p=a(self.p), q=a(self.q), v=a(self.v), ba=a(self.ba),
            bg=a(self.bg), rho=a(self.rho), tic=a(self.tic), qic=a(self.qic),
            td=a(self.td), depth=a(d))

    def _free_mask(self, init=False):
        if init:
            # initialization solve: poses/velocities/IMU biases only (the
            # reference's init frees just the gyro bias, estimator.cpp:750)
            return default_free_mask(optimize_leg_bias=False,
                                     optimize_extrinsic=False,
                                     optimize_td=False,
                                     use_imu=self.cfg.use_imu)
        opt_ex = bool(self.cfg.estimate_extrinsic
                      and (np.linalg.norm(self.v[0]) > 0.2
                           or self.open_ex_estimation))
        if opt_ex:
            self.open_ex_estimation = True
        return default_free_mask(
            optimize_leg_bias=self.cfg.optimize_leg_bias and self.cfg.use_leg_odom,
            optimize_extrinsic=opt_ex,
            optimize_td=bool(self.cfg.estimate_td
                             and np.linalg.norm(self.v[0]) > 0.2),
            use_imu=self.cfg.use_imu)

    def _pack(self, init=False):
        feats, slots = self.fm.export()
        preints = self.preints if self.cfg.use_imu else [None] * 10
        data = pack_window_data(
            preints, feats, prior=self.prior,
            free_mask=self._free_mask(init),
            gravity=(0, 0, self.cfg.g_norm), F=self.F, dtype=self.dtype,
            calib_prior=self._calib, use_leg_odom=self.cfg.use_leg_odom,
            device=self.device)
        depths = self.fm.depth_vector(slots)
        return data, feats, slots, depths

    def _optimize(self, init=False):
        data, feats, slots, depths = self._pack(init)
        st0 = self._window_state(depths)
        iters = INIT_ITERS if init else self.cfg.max_num_iterations
        st, info = solve_window(st0, data, SolveOptions(max_iters=iters))
        st_np, info, _ = _fetch(st, info)
        self._adopt(st_np, slots, feats)
        self.last_info = info
        self.last_data = data
        if init:
            self.stats["init_solves"] += 1
        return st_np, info

    def _adopt(self, st, slots, feats):
        self.p = np.array(st.p)
        self.q = np.array(st.q)
        self.v = np.array(st.v)
        self.ba = np.array(st.ba)
        self.bg = np.array(st.bg)
        self.rho = np.array(st.rho)
        self.tic = np.array(st.tic)
        self.qic = np.array(st.qic)
        self.td = float(st.td)
        valid = feats["valid"]
        d = np.asarray(st.depth)[: len(slots)]
        for n, s in enumerate(slots):
            if valid[n]:
                self.fm.depth[s] = d[n]

    def _initialize(self):
        """Stereo+IMU+leg init at frame 10: one full solve with biases free
        replaces solveGyroscopeBias + repropagate (estimator.cpp:734-770),
        then all intervals are re-preintegrated at the solved biases."""
        self._optimize(init=True)
        for k in range(10):
            if self.buffers[k] is not None:
                self.preints[k] = self._run_preint(
                    self.buffers[k], self.ba[k], self.bg[k], self.rho[k],
                    prev=self.preints[k - 1] if k > 0 else None)
        self._optimize(init=True)

    def _predict_next_frame(self):
        """Constant-velocity prediction of tracked features in the next
        image (reference: predictPtsInNextFrame, estimator.cpp:1694-1727),
        passed to self.predict_callback as {feature_id: pts_cam (3,)}."""
        self.predicted_pts = {}
        i, j = C.WINDOW_SIZE - 1, C.WINDOW_SIZE
        R_prev, R_cur = _quat_to_rot_np(self.q[i]), _quat_to_rot_np(self.q[j])
        p_prev, p_cur = self.p[i], self.p[j]
        R_d = R_prev.T @ R_cur
        p_d = R_prev.T @ (p_cur - p_prev)
        R_dn, p_dn = R_d, p_d
        for _ in range(int(getattr(self, "predict_steps", 1)) - 1):
            R_dn, p_dn = R_dn @ R_d, R_dn @ p_d + p_dn
        R_next = R_cur @ R_dn
        p_next = p_cur + R_cur @ p_dn
        ric = _quat_to_rot_np(self.qic[0])
        fm = self.fm
        for s in np.nonzero(fm.active & (fm.depth > 0) & fm.obs[:, j])[0]:
            sf = int(fm.start[s])
            pc = fm.pts[s, sf] / fm.depth[s]
            pw = _quat_to_rot_np(self.q[sf]) @ (ric @ pc + self.tic[0]) \
                + self.p[sf]
            pl = R_next.T @ (pw - p_next)
            pcam = ric.T @ (pl - self.tic[0])
            if pcam[2] > 0.1:
                self.predicted_pts[int(fm.ids[s])] = pcam
        if self.predict_callback is not None and self.predicted_pts:
            self.predict_callback(self.predicted_pts)

    def change_sensor_type(self, use_imu: bool, use_stereo: bool):
        """Runtime sensor hot-swap (reference: changeSensorType,
        estimator.cpp:175-212): re-enabling the IMU restarts the system,
        disabling it drops the marginalization prior; stereo toggles take
        effect immediately. At least one of (imu, stereo) must stay on."""
        if not use_imu and not use_stereo:
            raise ValueError("at least two sensors required: imu or stereo")
        self.flush()
        restart = False
        if use_imu != self.cfg.use_imu:
            self.cfg = self.cfg.replace(use_imu=use_imu)
            if use_imu:
                restart = True
            else:
                self.prior = None
        if use_stereo != self.cfg.stereo:
            self.cfg = self.cfg.replace(
                stereo=use_stereo, num_of_cam=2 if use_stereo else 1)
        if restart:
            self.stats["reboots"] += 1
            self.clear_state()

    def failure_detection(self) -> bool:
        """Divergence checks. The reference defines these thresholds but
        disables them with an early return (estimator.cpp:1005-1050); here
        they are live."""
        i = C.WINDOW_SIZE

        def fail(reason):
            self.stats.setdefault("failure_reasons", []).append(
                (float(self.headers[i]), reason))
            return True

        if self.cfg.use_imu and np.linalg.norm(self.ba[i]) > 2.5:
            return fail(f"big acc bias {self.ba[i]}")
        if self.cfg.use_imu and np.linalg.norm(self.bg[i]) > 1.0:
            return fail(f"big gyr bias {self.bg[i]}")
        if self._last_pose is not None:
            last_p, last_q = self._last_pose
            if np.linalg.norm(self.p[i] - last_p) > 5.0:
                return fail(f"position jump {self.p[i]} vs {last_p}")
            if abs(self.p[i][2] - last_p[2]) > 1.0:
                return fail(f"z jump {self.p[i][2]} vs {last_p[2]}")
            dq = _quat_mul_np(np.array([last_q[0], -last_q[1], -last_q[2],
                                        -last_q[3]]), self.q[i])
            ang = np.degrees(2 * np.arccos(np.clip(abs(dq[0]), -1, 1)))
            if ang > 50.0:
                return fail(f"rotation jump {ang:.1f} deg")
        self._last_pose = (self.p[i].copy(), self.q[i].copy())
        return False

    # ------------------------------------------------------------------
    def _post_solve(self, margin_flag):
        """Marginalize + slide, eager path (reference: estimator.cpp:
        1243-1678), used by the INITIAL phase; the NON_LINEAR path
        marginalizes inside `_streaming_step`."""
        data, feats, slots, depths = self._pack()
        st = self._window_state(depths)
        if margin_flag == MARGIN_OLD or self.prior is not None:
            with full_f32_matmuls():
                if margin_flag == MARGIN_OLD:
                    pj, pr, valid = marg.marginalize_old(st, data)
                    lin = _shift_state(st)
                else:
                    pj, pr, valid = marg.marginalize_second_new(st, data)
                    lin = _shift_state_second_new(st)
            if not self.cfg.marg_td_info:
                pj[:, fac.TD_OFF] = 0.0
            # an invalid prior ("unstable tracking",
            # marginalization_factor.cpp:205-210) is dropped: zeroed on the
            # device, as the reference skips the factor (estimator.cpp:1107)
            pj = torch.where(valid, pj, torch.zeros_like(pj))
            pr = torch.where(valid, pr, torch.zeros_like(pr))
            self.prior = (pj, pr, lin, valid)
        self._emit_keyframe_and_slide(margin_flag)

    def _emit_keyframe_and_slide(self, margin_flag, pre8m=None):
        """Keyframe export for the loop back-end, then the window slide.

        pre8m: spliced interval-8+9 preint computed in the streaming step;
        None = eager path, _slide_new re-preintegrates."""
        if margin_flag == MARGIN_OLD:
            if self.keyframe_callback is not None:
                # the frame leaving the window: final pose, its observed
                # feature ids, per-feature (normalized obs, world point)
                # (reference: pubKeyframe, visualization.cpp:345-398)
                fm = self.fm
                R0 = _quat_to_rot_np(self.q[0])
                ric0 = _quat_to_rot_np(self.qic[0])
                ids, obs = [], {}
                for s in np.nonzero(fm.active & fm.obs[:, 0])[0]:
                    fid = int(fm.ids[s])
                    ids.append(fid)
                    world = None
                    if fm.depth[s] > 0 and fm.start[s] == 0:
                        pc = fm.pts[s, 0] / fm.depth[s]
                        world = R0 @ (ric0 @ pc + self.tic[0]) + self.p[0]
                    obs[fid] = (fm.pts[s, 0, :2].copy(), world)
                self.keyframe_callback(self.headers[0], self.p[0].copy(),
                                       self.q[0].copy(), ids, obs)
            self._slide_old()
        else:
            self._slide_new(pre8m=pre8m)

    def _slide_old(self):
        p0_old = self.p[0].copy()
        R0_old = _quat_to_rot_np(self.q[0])
        for arr in (self.p, self.q, self.v, self.ba, self.bg, self.rho,
                    self.headers):
            arr[:-1] = arr[1:]
        p0_new = self.p[0].copy()
        R0_new = _quat_to_rot_np(self.q[0])
        ric = np.stack([_quat_to_rot_np(self.qic[i]) for i in range(2)])
        self.fm.slide_old(p0_old, R0_old, p0_new, R0_new, self.tic, ric)
        self.buffers = self.buffers[1:] + [None]
        self.preints = self.preints[1:] + [None]

    def _slide_new(self, pre8m=None):
        """Merge interval 8 and 9 (splice frame-10 samples into frame 9;
        reference: estimator.cpp:1567-1652).

        pre8m: merged preint computed in the streaming step (at the same
        solved frame-8 linearization) — adopted instead of a
        re-preintegration."""
        b8, b9 = self.buffers[8], self.buffers[9]
        if b8 is not None and b9 is not None and len(b8) and len(b9):
            merged = (self._merged_buffer if pre8m is not None
                      else _merge_buffers(b8, b9))
            self.buffers[8] = merged
            if pre8m is not None:
                self.preints[8] = pre8m
            elif self._imu_stale(merged):
                self.preints[8] = None  # hung-IMU samples: drop the factor
            else:
                self.preints[8] = self._run_preint(
                    merged, self.ba[8], self.bg[8], self.rho[8],
                    prev=self.preints[7])
        elif b9 is not None:
            self.buffers[8] = b9
            self.preints[8] = self.preints[9]
        self.buffers[9] = None
        self.preints[9] = None
        # frame 10 -> 9
        for arr in (self.p, self.q, self.v, self.ba, self.bg, self.rho,
                    self.headers):
            arr[C.WINDOW_SIZE - 1] = arr[C.WINDOW_SIZE]
        self.fm.slide_new()

    def _update_latest(self, t):
        i = min(self.frame_count, NF - 1)
        if self._last_raw is not None:
            acc, gyr = self._last_raw
        elif self.buffers[9] is not None and len(self.buffers[9]):
            acc, gyr = self.buffers[9].acc[-1], self.buffers[9].gyr[-1]
        else:
            acc, gyr = np.zeros(3), np.zeros(3)
        self.latest = dict(t=t, p=self.p[i].copy(), q=self.q[i].copy(),
                           v=self.v[i].copy(), ba=self.ba[i].copy(),
                           bg=self.bg[i].copy(), acc=acc, gyr=gyr)

    # ------------------------------------------------------------------
    def _rebase_world(self):
        """Reboot pose continuity: before clear_state wipes the window, fold
        the last published pose into a persistent world offset so the
        re-initialized estimator continues the trajectory instead of
        teleporting to the origin. Both frames are gravity-aligned, so the
        offset is a yaw rotation plus a translation, anchored at the last
        pose that PASSED failure detection."""
        if getattr(self, "_last_pose", None) is not None:
            p_raw, q_raw = self._last_pose
        else:
            i = min(self.frame_count, NF - 1)
            p_raw, q_raw = self.p[i], self.q[i]
        off = getattr(self, "_world_offset", None)
        if off is None:
            p_pub = np.asarray(p_raw, float)
            q_pub = np.asarray(q_raw, float)
        else:
            p_off0, R_off0, q_off0 = off
            p_pub = R_off0 @ p_raw + p_off0
            q_pub = _quat_mul_np(q_off0, q_raw)
        yaw = np.arctan2(
            2 * (q_pub[0] * q_pub[3] + q_pub[1] * q_pub[2]),
            1 - 2 * (q_pub[2] ** 2 + q_pub[3] ** 2))
        c, s = np.cos(yaw), np.sin(yaw)
        R_off = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        q_off = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
        self._world_offset = (np.asarray(p_pub, float), R_off, q_off)

    @property
    def pose(self):
        i = min(self.frame_count, NF - 1)
        off = getattr(self, "_world_offset", None)
        if off is None:
            return self.p[i].copy(), self.q[i].copy()
        p_off, R_off, q_off = off
        return (R_off @ self.p[i] + p_off,
                _quat_mul_np(q_off, self.q[i]))

    @property
    def velocity(self):
        v = self.v[min(self.frame_count, NF - 1)].copy()
        off = getattr(self, "_world_offset", None)
        return v if off is None else off[1] @ v


def _merge_buffers(b8: IntervalBuffer, b9: IntervalBuffer) -> IntervalBuffer:
    """Interval 8's samples, then interval 9's without the shared boundary
    sample."""
    merged = IntervalBuffer()
    for i in range(len(b8)):
        merged.append(b8.t[i], b8.acc[i], b8.gyr[i], b8.phi[i], b8.dphi[i],
                      b8.c[i])
    for i in range(1, len(b9)):
        merged.append(b9.t[i], b9.acc[i], b9.gyr[i], b9.phi[i], b9.dphi[i],
                      b9.c[i])
    return merged


def _shift_state(st: fac.WindowState) -> fac.WindowState:
    sh = lambda a: torch.cat([a[1:], a[-1:]], dim=0)
    return st._replace(p=sh(st.p), q=sh(st.q), v=sh(st.v), ba=sh(st.ba),
                       bg=sh(st.bg), rho=sh(st.rho))


def _shift_state_second_new(st: fac.WindowState) -> fac.WindowState:
    i, j = C.WINDOW_SIZE - 1, C.WINDOW_SIZE
    rep = lambda a: torch.cat([a[:i], a[j:j + 1], a[j:]], dim=0)
    return st._replace(p=rep(st.p), q=rep(st.q), v=rep(st.v), ba=rep(st.ba),
                       bg=rep(st.bg), rho=rep(st.rho))


# ---- small numpy quaternion helpers (host-side only) ----

def _quat_mul_np(q, p):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = p
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _delta_q_np(theta):
    q = np.concatenate([[1.0], theta / 2.0])
    return q / np.linalg.norm(q)


def _quat_to_rot_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _rot_np(q, v):
    return _quat_to_rot_np(q) @ v


def _rot_angle_np(R):
    """Rotation angle (rad) of a rotation matrix."""
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)))


def _rot_to_quat_np(R):
    from scipy.spatial.transform import Rotation
    return np.roll(Rotation.from_matrix(R).as_quat(), 1)
