"""Loop-closure pipeline: place recognition -> patch matching -> PnP ->
4-DoF pose graph.

End-to-end equivalent of the reference's external loop_fusion process
(launch/hardware_a1/hardware_a1_vilo.launch:8-10 + VINS-Fusion pose_graph:
keyframe topics -> DBoW2 retrieval -> BRIEF matching -> PnP relative pose ->
4-DoF graph). Runs in-process off the estimator's keyframe_callback and the
replay loop's rendered keyframe images.

The port's own copy of `cerberus_tpu/loop/closer.py`: the same host logic on
the port's `pnp`, `descriptors`, `config` and `posegraph`; the pose graph
optimizes on `device` (the card unless the caller names another).
"""

from __future__ import annotations

import numpy as np

from cerberus_tpu_torch.config import EstimatorConfig
from cerberus_tpu_torch.estimator import pnp
from cerberus_tpu_torch.loop import descriptors as desc
from cerberus_tpu_torch.loop.posegraph import PoseGraph, _np_rot_z


def _yaw_of_quat(q):
    w, x, y, z = q
    return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))


def _wrap(a):
    return float(np.arctan2(np.sin(a), np.cos(a)))


class LoopCloser:
    """Consumes keyframes (pose + feature obs + image), maintains the place
    index and pose graph, and produces a loop-corrected trajectory."""

    def __init__(self, cfg=None, focal: float = 460.0, cx: float = 320.0,
                 cy: float = 240.0, min_matches: int = 12,
                 min_sim: float = 0.50, exclude_last: int = 40,
                 optimize_every: int = 10, min_kf_dist: float = 0.25,
                 min_kf_yaw: float = 0.2, seq_window: int = 5,
                 seq_radius: int = 8, strong_sim: float = 0.90,
                 seq_weight: float = 100.0, loop_weight: float = 10.0,
                 robust_kind: str = "cauchy", record: bool = False,
                 device="cuda"):
        # min_sim gates only the PROPOSAL; every candidate still has to
        # survive mutual-best ZNCC patch matching and RANSAC PnP before an
        # edge is added, so a permissive default is safe (0.85 found zero
        # candidates over a 240 s rendered circuit whose true revisit
        # similarity peaked lower; measured via stats['best_sim']). In the
        # permissive band (min_sim..0.85) the required match count scales
        # up to 2x so weak place-recognition evidence needs strong
        # geometric evidence (guards perceptually aliased scenes).
        self.cfg = cfg or EstimatorConfig()
        ric, tic = self.cfg.ric_tic()
        self.ric0, self.tic0 = ric[0], tic[0]
        self.f, self.cx, self.cy = focal, cx, cy
        # auto_detect off: this front-end supplies verified, MEASURED edges
        # (ZNCC + RANSAC PnP); the posegraph's feature-overlap proposals
        # would add unverified edges invisible to loops_found
        # seq_weight/loop_weight: sqrt-information of the odometric chain
        # vs a PnP loop measurement. The defaults model the production
        # VILO (relative keyframe error ~10 mm, PnP ~0.1 m) so a loop
        # dominates only across chains long enough for accumulated drift
        # to exceed PnP noise; a deliberately-bad odometry source should
        # pass a lower seq_weight.
        self.pg = PoseGraph(auto_detect=False, seq_weight=seq_weight,
                            robust_kind=robust_kind, device=device)
        self.loop_weight = loop_weight
        self.index = desc.PlaceIndex()
        self.db: list[dict] = []
        self.min_matches = min_matches
        self.min_sim = min_sim
        self.exclude_last = exclude_last
        self.optimize_every = optimize_every
        # keyframe subsampling: the estimator marks nearly every frame a
        # keyframe (MARGIN_OLD at ~14 Hz); the pose graph only needs nodes
        # every ~min_kf_dist meters (VINS-Fusion's pose_graph similarly
        # skips keyframes). Keeps the node pool within capacity over
        # multi-hundred-meter runs instead of silently truncating at 512.
        self.min_kf_dist = min_kf_dist
        self.min_kf_yaw = min_kf_yaw
        self._last_p = None
        self._last_yaw = None
        self.kf_skipped = 0
        self.loops_found = 0
        self.loops_rejected = 0
        self.seq_gated = 0     # candidates dropped by sequence consistency
        self.best_sim = -1.0   # max place-recognition score seen (diagnostic)
        self._since_opt = 0
        # sequence-consistency gate (VINS pose_graph-style): a
        # place-recognition candidate is only verified geometrically if a
        # RECENT keyframe also retrieved a nearby old node (within
        # seq_radius nodes, over the last seq_window keyframes), or its
        # similarity alone is overwhelming (>= strong_sim). Lets min_sim
        # sit lower (more recall) without admitting isolated aliases.
        self.seq_window = seq_window
        self.seq_radius = seq_radius
        self.strong_sim = strong_sim
        self._recent_cands: list[tuple[int, int]] = []  # (db_idx, old_idx)
        # record=True keeps every ingested keyframe record (descriptors
        # included) on self.records for offline loop-back-end replay
        self.record = record
        self.records: list[dict] = []

    def dump_records(self, path: str):
        """Persist the recorded keyframe stream for evals/loop_replay.py."""
        import pickle
        with open(path, "wb") as f:
            pickle.dump(self.records, f)

    # ------------------------------------------------------------------
    def add_keyframe(self, t, p, q, ids, obs: dict, img: np.ndarray | None):
        """obs: {fid: (uv_norm (2,), world_pt (3,) | None)} from the
        estimator; img: the keyframe's left image (None disables visual
        loop detection for this keyframe)."""
        yaw = _yaw_of_quat(q)
        p = np.asarray(p, float)
        if self._last_p is not None and \
                np.linalg.norm(p - self._last_p) < self.min_kf_dist and \
                abs(_wrap(yaw - self._last_yaw)) < self.min_kf_yaw:
            self.kf_skipped += 1
            return -2
        rec = dict(t=t, p_odo=p.copy(), yaw=yaw,
                   ids=np.asarray(sorted(obs), dtype=np.int64))
        fids = rec["ids"]
        uv = np.array([obs[i][0] for i in fids]) if len(fids) else \
            np.zeros((0, 2))
        world = np.array([obs[i][1] if obs[i][1] is not None
                          else [np.nan] * 3 for i in fids]) if len(fids) \
            else np.zeros((0, 3))
        rec["uv"] = uv
        rec["world"] = world
        if img is not None and len(fids):
            px = np.column_stack([self.f * uv[:, 0] + self.cx,
                                  self.f * uv[:, 1] + self.cy])
            rec["descs"], rec["ok"] = desc.extract_patches(img, px)
            rec["g"] = desc.tiny_image(img)
        else:
            rec["descs"] = np.zeros((len(fids), desc.PATCH_DIM), np.float32)
            rec["ok"] = np.zeros(len(fids), bool)
            rec["g"] = None
        if self.record:
            import copy
            self.records.append(copy.deepcopy(rec))
        return self.add_keyframe_precomputed(rec)

    def add_keyframe_precomputed(self, rec: dict) -> int:
        """Ingest a keyframe whose descriptors are already computed
        (offline replay of a recorded keyframe stream — evals/loop_replay.py
        re-runs the loop back-end under different gating/weighting without
        re-running the estimator). rec: t, p_odo, yaw, ids, uv, world,
        descs, ok, g (tiny-image vector or None)."""
        rec = dict(rec)
        node = self.pg.add_keyframe(rec["p_odo"], rec["yaw"],
                                    [int(i) for i in rec["ids"]])
        if node < 0:
            self.kf_skipped += 1
            return node
        self._last_p = np.asarray(rec["p_odo"], float)
        self._last_yaw = float(rec["yaw"])
        rec["node"] = node
        g = rec.get("g")
        if g is not None:
            cand = self.index.query(g, self.exclude_last, min_sim=0.0)
            self.index.add(g)
            if cand is not None:
                self.best_sim = max(self.best_sim, cand[1])
                if cand[1] >= self.min_sim:
                    db_idx = len(self.db)
                    consistent = any(
                        db_idx - i <= self.seq_window
                        and abs(cand[0] - o) <= self.seq_radius
                        for i, o in self._recent_cands)
                    self._recent_cands.append((db_idx, cand[0]))
                    self._recent_cands = [
                        (i, o) for i, o in self._recent_cands
                        if db_idx - i <= self.seq_window]
                    if consistent or cand[1] >= self.strong_sim:
                        self._try_close(cand[0], rec, sim=cand[1],
                                        seq_consistent=consistent)
                    else:
                        self.seq_gated += 1
        else:
            self.index.add(np.zeros(desc.TINY_H * desc.TINY_W, np.float32))
        self.db.append(rec)
        self._since_opt += 1
        # only optimize once a loop edge exists: the sequential chain alone
        # is consistent by construction (optimizing it is a costly no-op,
        # and any numeric wobble would DEGRADE the copied odometry)
        if self._since_opt >= self.optimize_every and \
                self.pg.n_loop_edges > 0:
            self.pg.optimize()
            self._since_opt = 0
        return node

    # ------------------------------------------------------------------
    def _required_matches(self, sim: float) -> int:
        """Match threshold vs place-recognition confidence: at sim>=0.85
        the base min_matches; decaying to 2x at sim==min_sim (weak place
        evidence needs stronger geometric evidence — guards aliased
        scenes, ADVICE r2)."""
        hi = 0.85
        if sim >= hi:
            return self.min_matches
        frac = (hi - sim) / max(hi - self.min_sim, 1e-9)
        return int(round(self.min_matches * (1.0 + min(frac, 1.0))))

    def _try_close(self, old_idx: int, rec: dict, sim: float = 1.0,
                   seq_consistent: bool = False):
        """Verify a place-recognition candidate: patch matching + RANSAC PnP
        of the NEW keyframe against the OLD keyframe's 3D points, then add a
        measured relative-pose edge.

        seq_consistent: the candidate carries temporal evidence (a
        neighboring keyframe retrieved a nearby node) — currently
        informational; geometric requirements stay at full strength."""
        old = self.db[old_idx]
        # sequence consistency gates the PROPOSAL; geometric evidence
        # requirements stay at full strength (a relaxed match count here
        # admitted weaker PnP edges whose errors the pose graph then
        # propagated — measured on the 3-lap run)
        need = self._required_matches(sim)
        i_new, i_old = desc.match_patches(rec["descs"], rec["ok"],
                                          old["descs"], old["ok"])
        if len(i_new) < need:
            self.loops_rejected += 1
            return
        w_old = old["world"][i_old]
        good = ~np.isnan(w_old[:, 0])
        if good.sum() < need:
            self.loops_rejected += 1
            return
        pts3d = w_old[good]
        pts2d = rec["uv"][i_new][good]
        res = pnp.ransac_pnp(pts3d, pts2d, min_inliers=need)
        if res is None:
            self.loops_rejected += 1
            return
        R_cam, t_cam, inl = res
        # camera -> body (left cam extrinsics)
        R_body = R_cam @ self.ric0.T
        p_body = t_cam - R_body @ self.tic0
        yaw_meas = float(np.arctan2(R_body[1, 0], R_body[0, 0]))
        i = old["node"]
        j = rec["node"]
        # the PnP pose lives in the ODOMETRIC world frame (the old
        # keyframe's 3D points were triangulated there), so the relative
        # measurement must be taken against node i's odometric pose — using
        # the optimized pg.p[i]/yaw[i] mixes frames once any correction has
        # moved node i
        Ri = _np_rot_z(self.pg.yaw_odo[i])
        rel_p = Ri.T @ (p_body - self.pg.p_odo[i])
        rel_yaw = yaw_meas - self.pg.yaw_odo[i]
        self.pg.add_loop_edge(i, j, rel_p=rel_p, rel_yaw=rel_yaw,
                              weight=self.loop_weight)
        self.loops_found += 1
        # optimize on every accepted loop (the reference's loop_fusion is an
        # always-on corrector, not a batch post-processor)
        self.pg.optimize()
        self._since_opt = 0

    # ------------------------------------------------------------------
    def finish(self):
        if self.pg.edges:
            self.pg.optimize(iters=16)

    def corrected(self) -> np.ndarray:
        """(n, 3) loop-corrected keyframe positions."""
        return self.pg.p[: self.pg.n].copy()

    def odometric(self) -> np.ndarray:
        """(n, 3) raw odometric keyframe positions at the same times as
        corrected() — apples-to-apples comparison on the identical
        subsampled trajectory."""
        return np.array([r["p_odo"] for r in self.db]) if self.db else \
            np.zeros((0, 3))

    def times(self) -> np.ndarray:
        return np.array([r["t"] for r in self.db])
