"""4-DoF pose-graph optimization (loop closure back-end), on torch tensors
(port of `cerberus_tpu/loop/posegraph.py`).

Capability equivalent of the external loop_fusion node the reference launches
alongside (reference: launch/hardware_a1/hardware_a1_vilo.launch:8-9,
consuming the keyframe pose/point topics published by visualization.cpp:
345-398). VINS-Fusion's pose graph optimizes 4 DoF (position + yaw) because
roll/pitch are observable from gravity; we keep the same design.

`optimize_pose_graph` is a damped Gauss-Newton on the card. Where the JAX
package widens per-edge `jacfwd` Jacobians into a one-hot (E*4, 4N) matrix
and multiplies it out (scatter-free, for the TPU), the port writes each
edge's 4 x 8 Jacobian in closed form, batched over edges, and accumulates
its four 4 x 4 blocks of J^T J and two 4-vectors of J^T r into H (4N x 4N)
and b with `index_put_(accumulate=True)` / `index_add_`: the same H and b up
to summation order. The gauge, damping, LU solve and robust IRLS weights
are the JAX package's. The iterations queue on the device with no host
read-back; `PoseGraph` fetches the result once. Profiler spans:
`posegraph_assemble` and `posegraph_solve`, once per iteration.

`PoseGraph`, `save_pose_graph` and `load_pose_graph` are host NumPy, as in
the JAX package; an `.npz` saved by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from cerberus_tpu_torch.device import on_device, resolve_device


def _edge_residual_jacobian(p, yaw, e_i, e_j, rel_p, rel_yaw):
    """Residuals (E, 4) of every edge at (p, yaw) and their Jacobians (E, 4, 8)
    with respect to [dp_i(3), dyaw_i, dp_j(3), dyaw_j], in closed form.

    r_p = R_i^T (p_j - p_i) - rel_p and r_yaw = wrap(yaw_j - yaw_i - rel_yaw)
    (JAX `_edge_residual`): d r_p / d p_i = -R_i^T, d r_p / d p_j = R_i^T,
    d r_p / d yaw_i = dR_i^T/dyaw (p_j - p_i); the wrap's derivative is 1, so
    d r_yaw / d yaw_i = -1 and d r_yaw / d yaw_j = 1."""
    yi = yaw[e_i]
    c, s = torch.cos(yi), torch.sin(yi)
    d = p[e_j] - p[e_i]                                     # (E, 3)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    RiT = torch.stack([c, s, z, -s, c, z, z, z, o], -1).reshape(-1, 3, 3)
    r_p = (RiT @ d[..., None])[..., 0] - rel_p
    dy = yaw[e_j] - yi - rel_yaw
    dy = torch.atan2(torch.sin(dy), torch.cos(dy))
    r = torch.cat([r_p, dy[:, None]], dim=1)
    # dR_i^T/dyaw (p_j - p_i)
    d_yaw = torch.stack([-s * d[:, 0] + c * d[:, 1],
                         -c * d[:, 0] - s * d[:, 1], z], dim=-1)
    zc = torch.zeros_like(d)[..., None]                     # (E, 3, 1)
    top = torch.cat([-RiT, d_yaw[..., None], RiT, zc], dim=2)     # (E, 3, 8)
    bottom = torch.stack([z, z, z, -o, z, z, z, o], dim=-1)[:, None, :]
    return r, torch.cat([top, bottom], dim=1)


def _normal_equations(J, r, e_i, e_j, N):
    """H (4N, 4N) and b (4N,) of the weighted edge Jacobians J (E, 4, 8) and
    residuals r (E, 4): each edge's blocks J_a^T J_b added at node pair
    (a, b) of (i, j), and J_a^T r at node a."""
    Ji, Jj = J[..., 0:4], J[..., 4:8]
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    H4 = torch.zeros((N, N, 4, 4), dtype=J.dtype, device=J.device)
    for a, b, blk in ((e_i, e_i, JiT @ Ji), (e_i, e_j, JiT @ Jj),
                      (e_j, e_i, JjT @ Ji), (e_j, e_j, JjT @ Jj)):
        H4.index_put_((a, b), blk, accumulate=True)
    b4 = torch.zeros((N, 4), dtype=J.dtype, device=J.device)
    b4.index_add_(0, e_i, (JiT @ r[..., None])[..., 0])
    b4.index_add_(0, e_j, (JjT @ r[..., None])[..., 0])
    return H4.permute(0, 2, 1, 3).reshape(4 * N, 4 * N), b4.reshape(-1)


def optimize_pose_graph(p, yaw, e_i, e_j, rel_p, rel_yaw, e_w, e_mask,
                        e_robust=None, iters: int = 8, lam: float = 1e-6,
                        robust_scale: float = 2.0,
                        robust_kind: str = "cauchy", device="cuda"):
    """Gauss-Newton over (p (N,3), yaw (N,)); node 0 fixed (gauge).

    e_i/e_j: (E,) int node ids; rel_p (E,3) measured p_j-p_i in frame i;
    rel_yaw (E,); e_w (E,) edge weights (sqrt-information scalar);
    e_mask (E,) bool. e_robust (E,) bool marks edges under the robust loss
    (IRLS reweighting per GN iteration: Cauchy, or Huber with
    robust_kind="huber") — loop-closure measurements, whose PnP outliers
    would otherwise drag whole trajectory segments; sequential odometry
    edges stay quadratic. robust_scale is in whitened residual units.

    Inputs may be tensors or numpy arrays; they are moved to `device` (the
    card unless the caller names another), float data in p's float type.
    Returns the optimized (p, yaw) there, with nothing read back to the
    host: every iteration is queued on the device."""
    dev = resolve_device(device)
    p = on_device(p, dev)
    dtype = p.dtype
    yaw = on_device(yaw, dev, dtype)
    e_i = on_device(e_i, dev).long()
    e_j = on_device(e_j, dev).long()
    rel_p = on_device(rel_p, dev, dtype)
    rel_yaw = on_device(rel_yaw, dev, dtype)
    e_w = on_device(e_w, dev, dtype)
    e_mask = on_device(e_mask, dev).bool()
    rb = (torch.zeros_like(e_mask) if e_robust is None
          else on_device(e_robust, dev).bool())
    N = p.shape[0]
    dim = 4 * N
    s0 = torch.where(e_mask, e_w, torch.zeros_like(e_w))
    # gauge: fix node 0 (zero out its dims, unit diagonal)
    mask = torch.ones(dim, dtype=dtype, device=dev)
    mask[0:4] = 0.0
    for _ in range(iters):
        with record_function("posegraph_assemble"):
            r, J = _edge_residual_jacobian(p, yaw, e_i, e_j, rel_p, rel_yaw)
            nr2 = torch.sum((r * s0[:, None]) ** 2, dim=1)
            if robust_kind == "huber":
                nr = torch.sqrt(nr2 + 1e-12)
                cw = torch.sqrt(torch.clamp(robust_scale / nr, max=1.0))
            else:
                cw = 1.0 / torch.sqrt(1.0 + nr2 / robust_scale ** 2)
            s = s0 * torch.where(rb, cw, torch.ones_like(cw))
            H, b = _normal_equations(J * s[:, None, None], r * s[:, None],
                                     e_i, e_j, N)
            H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
            b = b * mask
            Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H),
                                                  min=1e-8))
        # LU, as jnp.linalg.solve; solve_ex does not read its info flag back
        with record_function("posegraph_solve"):
            dx = -torch.linalg.solve_ex(Hd, b).result.reshape(N, 4)
        p = p + dx[:, 0:3]
        yaw = yaw + dx[:, 3]
    return p, yaw


class PoseGraph:
    """Host-side keyframe database + loop detection + batched optimization.

    Keyframes carry the ids of their observed features; loop candidates are
    proposed by feature-id overlap (works with any front-end that provides
    stable ids; a place-recognition front-end can feed `add_loop_edge`
    directly, like loop_fusion's BoW does). The pools live on the host;
    `optimize` runs `optimize_pose_graph` on `device` (the card unless the
    caller names another) in `dtype`."""

    def __init__(self, capacity_nodes=512, capacity_edges=2048,
                 min_overlap=20, min_gap=30, dtype=torch.float64,
                 auto_detect=True, max_nodes=2048, seq_weight=100.0,
                 robust_kind: str = "cauchy", robust_scale: float = 2.0,
                 prune_chi2: float = 25.0, device="cuda"):
        self.device = resolve_device(device)
        self.Nc, self.Ec = capacity_nodes, capacity_edges
        self.max_nodes = max_nodes
        self.dtype = dtype
        self.n = 0
        self.p = np.zeros((capacity_nodes, 3))
        self.yaw = np.zeros(capacity_nodes)
        # raw odometric inputs per node: edge MEASUREMENTS must always come
        # from the odometric stream — after an optimize has moved nodes,
        # a sequential edge computed from self.p[k-1] (corrected) to the
        # incoming p (odometric) encodes the correction as fake motion,
        # and every later optimize fights it
        self.p_odo = np.zeros((capacity_nodes, 3))
        self.yaw_odo = np.zeros(capacity_nodes)
        self.feat_ids: list[set] = []
        self.edges = []   # (i, j, rel_p, rel_yaw, weight)
        self.n_loop_edges = 0   # edges beyond the sequential chain
        self.min_overlap = min_overlap
        self.min_gap = min_gap
        self.seq_weight = seq_weight
        self.robust_kind = robust_kind
        self.robust_scale = robust_scale
        # consistency guard (see optimize): whitened-residual^2 above which
        # a loop edge is pruned as an outlier at the solution (a ~5-sigma
        # gate on the 4-dim edge)
        self.prune_chi2 = prune_chi2
        self.stats = {"rollbacks": 0, "pruned_edges": 0, "optimizes": 0}
        # feature-id-overlap loop proposal (uses the CURRENT relative
        # estimate as the edge measurement). Disable when an external
        # verified front-end (LoopCloser: place index + ZNCC + RANSAC PnP)
        # supplies measured edges instead.
        self.auto_detect = auto_detect

    def _grow(self):
        """Double the node pool (padded shapes are powers of two)."""
        new = min(2 * self.Nc, self.max_nodes)
        if new <= self.Nc:
            return False

        def grow(a, shape):
            b = np.zeros(shape)
            b[: self.Nc] = a
            return b

        self.p = grow(self.p, (new, 3))
        self.yaw = grow(self.yaw, (new,))
        self.p_odo = grow(self.p_odo, (new, 3))
        self.yaw_odo = grow(self.yaw_odo, (new,))
        self.Nc = new
        return True

    def add_keyframe(self, p, yaw, feature_ids=None) -> int:
        """Append a keyframe; creates the sequential edge automatically.
        Returns node id (or -1 when full at max capacity)."""
        if self.n >= self.Nc and not self._grow():
            return -1
        k = self.n
        self.p_odo[k] = p
        self.yaw_odo[k] = yaw
        self.feat_ids.append(set(feature_ids or ()))
        if k > 0:
            # sequential edge from the ODOMETRIC deltas; the new node's
            # initial state composes that delta onto the (possibly
            # corrected) previous node
            Ri = _np_rot_z(self.yaw_odo[k - 1])
            rel_p = Ri.T @ (self.p_odo[k] - self.p_odo[k - 1])
            rel_yaw = self.yaw_odo[k] - self.yaw_odo[k - 1]
            Rc = _np_rot_z(self.yaw[k - 1])
            self.p[k] = self.p[k - 1] + Rc @ rel_p
            self.yaw[k] = self.yaw[k - 1] + rel_yaw
            # sqrt-information of the odometric chain (~10 mm relative
            # error between keyframes 0.25 m apart -> weight ~100)
            self.edges.append((k - 1, k, rel_p, rel_yaw, self.seq_weight))
        else:
            self.p[k] = p
            self.yaw[k] = yaw
        self.n += 1
        if self.auto_detect:
            loop = self.detect_loop(k)
            if loop is not None:
                self.add_loop_edge(loop, k)
        return k

    def detect_loop(self, k: int):
        ids_k = self.feat_ids[k]
        if not ids_k:
            return None
        best, best_ov = None, 0
        for i in range(0, k - self.min_gap):
            ov = len(ids_k & self.feat_ids[i])
            if ov > best_ov:
                best, best_ov = i, ov
        return best if best_ov >= self.min_overlap else None

    def add_loop_edge(self, i: int, j: int, rel_p=None, rel_yaw=None,
                      weight: float = 5.0):
        """Add a loop constraint. Without an explicit measurement, the
        current relative estimate is used."""
        if rel_p is None:
            Ri = _np_rot_z(self.yaw[i])
            rel_p = Ri.T @ (self.p[j] - self.p[i])
            rel_yaw = self.yaw[j] - self.yaw[i]
        self.edges.append((int(i), int(j), np.asarray(rel_p), float(rel_yaw),
                           weight))
        self.n_loop_edges += 1

    def _edge_costs(self, p, yaw):
        """(total robust cost, per-edge (is_loop, whitened nr2)) at (p, yaw)
        — the weighting and robust loss the device IRLS minimizes, on the
        host."""
        total = 0.0
        per_edge = []
        c = self.robust_scale
        for (i, j, rp, ry, w) in self.edges:
            Ri = _np_rot_z(yaw[i])
            r_p = Ri.T @ (p[j] - p[i]) - rp
            dy = yaw[j] - yaw[i] - ry
            dy = np.arctan2(np.sin(dy), np.cos(dy))
            nr2 = float(w * w * (np.sum(r_p ** 2) + dy * dy))
            is_loop = (j - i) != 1
            if is_loop:
                if self.robust_kind == "huber":
                    nr = np.sqrt(nr2)
                    cost = 0.5 * nr2 if nr <= c else c * nr - 0.5 * c * c
                else:
                    cost = 0.5 * c * c * np.log1p(nr2 / (c * c))
            else:
                cost = 0.5 * nr2
            total += cost
            per_edge.append((is_loop, nr2))
        return total, per_edge

    def optimize(self, iters: int = 8):
        """Run the device GN over the padded pools; updates node states.

        A no-op without loop edges. Consistency guard: (a) an optimize that
        raises the total robust cost is rolled back; (b) loop edges whose
        whitened residual^2 still exceeds prune_chi2 at the solution are
        pruned, the entry state restored, and the graph re-optimized
        without them (<= 3 rounds)."""
        if self.n < 2 or not self.edges or self.n_loop_edges == 0:
            return
        for _ in range(3):
            p0 = self.p.copy()
            yaw0 = self.yaw.copy()
            c0, _ = self._edge_costs(p0, yaw0)
            self._optimize_once(iters)
            self.stats["optimizes"] += 1
            c1, per_edge = self._edge_costs(self.p, self.yaw)
            if c1 > c0 + 1e-9:
                self.p, self.yaw = p0, yaw0
                self.stats["rollbacks"] += 1
                return
            bad = [k for k, (is_loop, nr2) in enumerate(per_edge)
                   if is_loop and nr2 > self.prune_chi2]
            if not bad:
                return
            self.edges = [e for k, e in enumerate(self.edges)
                          if k not in set(bad)]
            self.n_loop_edges -= len(bad)
            self.stats["pruned_edges"] += len(bad)
            # restore the entry state and re-optimize without the outliers
            self.p, self.yaw = p0, yaw0
            if self.n_loop_edges <= 0:
                return

    def padded_edges(self):
        """The edge pool as `_optimize_once` hands it to the device: padded
        to the next power of two >= the live edge count (at least
        capacity_edges), as the JAX package pads it. Returns (e_i, e_j,
        rel_p, rel_yaw, e_w, e_mask, e_robust) numpy arrays."""
        E = max(self.Ec, 1 << (len(self.edges) - 1).bit_length())
        e_i = np.zeros(E, np.int32)
        e_j = np.zeros(E, np.int32)
        rel_p = np.zeros((E, 3))
        rel_yaw = np.zeros(E)
        e_w = np.zeros(E)
        e_mask = np.zeros(E, bool)
        for n, (i, j, rp, ry, w) in enumerate(self.edges[:E]):
            e_i[n], e_j[n] = i, j
            rel_p[n] = rp
            rel_yaw[n] = ry
            e_w[n] = w
            e_mask[n] = True
        # non-adjacent edges are loop measurements -> robust loss
        e_robust = e_mask & ((e_j - e_i) != 1)
        return e_i, e_j, rel_p, rel_yaw, e_w, e_mask, e_robust

    def _optimize_once(self, iters: int = 8):
        p, yaw = optimize_pose_graph(
            torch.as_tensor(self.p, dtype=self.dtype),
            self.yaw, *self.padded_edges(), iters=iters,
            robust_scale=self.robust_scale, robust_kind=self.robust_kind,
            device=self.device)
        # one fetch: p and yaw together
        out = torch.cat([p, yaw[:, None]], dim=1).cpu().numpy()
        self.p, self.yaw = out[:, 0:3].copy(), out[:, 3].copy()


def _np_rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def save_pose_graph(pg: PoseGraph, path: str):
    """Persist nodes + edges (the reference's loop_fusion offers pose-graph
    save/load via pose_graph_save_path, config a1 yaml:101-104). The file is
    the JAX package's format."""
    e_i = np.array([e[0] for e in pg.edges], np.int64)
    e_j = np.array([e[1] for e in pg.edges], np.int64)
    rel_p = (np.stack([e[2] for e in pg.edges])
             if pg.edges else np.zeros((0, 3)))
    rel_yaw = np.array([e[3] for e in pg.edges])
    e_w = np.array([e[4] for e in pg.edges])
    np.savez(path, n=pg.n, p=pg.p[: pg.n], yaw=pg.yaw[: pg.n],
             p_odo=pg.p_odo[: pg.n], yaw_odo=pg.yaw_odo[: pg.n],
             e_i=e_i, e_j=e_j, rel_p=rel_p, rel_yaw=rel_yaw, e_w=e_w,
             n_loop_edges=pg.n_loop_edges)


def load_pose_graph(path: str, **kwargs) -> PoseGraph:
    """Rebuild a PoseGraph saved by save_pose_graph (of either package);
    further keyframes can be appended and re-optimized against the loaded
    map. kwargs go to PoseGraph (device= among them)."""
    z = np.load(path)
    n = int(z["n"])
    cap = max(512, 1 << max(n - 1, 1).bit_length())
    pg = PoseGraph(capacity_nodes=cap, auto_detect=False, **kwargs)
    pg.n = n
    pg.p[:n] = z["p"]
    pg.yaw[:n] = z["yaw"]
    pg.p_odo[:n] = z["p_odo"] if "p_odo" in z else z["p"]
    pg.yaw_odo[:n] = z["yaw_odo"] if "yaw_odo" in z else z["yaw"]
    pg.feat_ids = [set() for _ in range(n)]
    pg.edges = [(int(i), int(j), rp, float(ry), float(w))
                for i, j, rp, ry, w in zip(z["e_i"], z["e_j"], z["rel_p"],
                                           z["rel_yaw"], z["e_w"])]
    pg.n_loop_edges = int(z["n_loop_edges"])
    return pg
