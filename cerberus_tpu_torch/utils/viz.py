"""Trajectory and feature-track visualization (port of
`cerberus_tpu/utils/viz.py`; matplotlib and OpenCV imported lazily).

Offline equivalent of the reference's ROS visualization layer
(reference: src/utils/visualization.{h,cpp} — odometry/path topics rendered
in rviz, and the tracked-image overlay feature_tracker.cpp:445-499). No ROS
here: figures render straight to PNG for eval reports and debugging.
"""

from __future__ import annotations

import numpy as np


def plot_trajectory(est_p: np.ndarray, gt_p: np.ndarray | None = None,
                    path: str = "trajectory.png", title: str = "",
                    extra: dict | None = None):
    """Top-down (x, y) + height profile. `extra`: {label: (n,3) array} for
    additional trajectories (e.g. loop-corrected, EKF-only)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax0, ax1) = plt.subplots(
        1, 2, figsize=(11, 5), gridspec_kw={"width_ratios": [1.4, 1]})
    ax0.plot(est_p[:, 0], est_p[:, 1], "-", lw=1.2, label="estimate")
    if gt_p is not None and len(gt_p):
        ax0.plot(gt_p[:, 0], gt_p[:, 1], "--", lw=1.0, label="ground truth")
    for label, arr in (extra or {}).items():
        ax0.plot(arr[:, 0], arr[:, 1], ":", lw=1.2, label=label)
    ax0.set_xlabel("x [m]")
    ax0.set_ylabel("y [m]")
    ax0.axis("equal")
    ax0.legend(fontsize=8)
    ax0.set_title(title or "trajectory (top-down)")

    n = len(est_p)
    ax1.plot(np.arange(n), est_p[:, 2], lw=1.0, label="estimate z")
    if gt_p is not None and len(gt_p):
        ax1.plot(np.arange(len(gt_p)), gt_p[:, 2], "--", lw=1.0, label="gt z")
    ax1.set_xlabel("keyframe")
    ax1.set_ylabel("z [m]")
    ax1.legend(fontsize=8)
    ax1.set_title("height")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def draw_tracks(img: np.ndarray, pts: np.ndarray, track_cnt: np.ndarray,
                predictions: np.ndarray | None = None,
                max_cnt: int = 20) -> np.ndarray:
    """Tracked-image overlay (reference: FeatureTracker::drawTrack,
    feature_tracker.cpp:445-499): color encodes track age from blue (new)
    to red (long-lived); optional predicted positions in yellow."""
    import cv2

    vis = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR) if img.ndim == 2 else \
        img.copy()
    for i in range(len(pts)):
        frac = min(1.0, track_cnt[i] / float(max_cnt))
        color = (int(255 * (1 - frac)), 0, int(255 * frac))
        cv2.circle(vis, (int(pts[i, 0]), int(pts[i, 1])), 2, color, 2)
    if predictions is not None:
        for p in predictions:
            cv2.circle(vis, (int(p[0]), int(p[1])), 2, (0, 170, 255), 1)
    return vis


def plot_metrics(metrics_path: str, out_path: str = "metrics.png"):
    """Render the JSONL metrics stream (utils/metrics.py): solve cost and
    latency over time, reboot markers."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from cerberus_tpu_torch.utils.metrics import read_metrics
    recs = read_metrics(metrics_path)
    solves = [r for r in recs if r.get("kind") == "solve"]
    reboots = [r for r in recs if r.get("kind") == "reboot"]
    if not solves:
        return None
    t = np.array([r["t"] for r in solves])
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    ax0.semilogy(t, [max(r["cost"], 1e-9) for r in solves], lw=0.8,
                 label="cost")
    ax0.semilogy(t, [max(r["cost0"], 1e-9) for r in solves], lw=0.5,
                 alpha=0.5, label="cost0")
    for r in reboots:
        ax0.axvline(r["t"], color="r", ls="--", lw=0.8)
    ax0.set_ylabel("window cost")
    ax0.legend(fontsize=8)
    ax1.plot(t, [r["solve_ms"] for r in solves], lw=0.8)
    ax1.set_ylabel("solve ms")
    ax1.set_xlabel("t [s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
