"""Visual place recognition for loop closure: global + local descriptors.

The port's own copy of `cerberus_tpu/loop/descriptors.py` (NumPy only), so
that the port imports nothing of the JAX package; bit-identical.

Capability equivalent of the reference's external loop_fusion node front-end
(VINS-Fusion pose_graph: DBoW2 bag-of-BRIEF for place retrieval + BRIEF
patch matching + PnP for the relative pose; launched by
reference: launch/hardware_a1/hardware_a1_vilo.launch:8-10, fed by the
keyframe pose/point topics of visualization.cpp:345-398).

TPU-native design: both descriptor stages are dense linear algebra instead
of trees/hamming —
  * global: a z-normalized tiny image (SeqSLAM-style); retrieval over the
    keyframe database is ONE matvec (cosine similarity), batched on device.
  * local: z-normalized intensity patches at tracked feature locations;
    matching two keyframes is ONE (N_new x N_old) matmul + mutual-best +
    ratio test. At 120 features x 121-dim patches this is MXU-trivial and
    scales to thousands of keyframes.
"""

from __future__ import annotations

import numpy as np

TINY_H, TINY_W = 12, 16
# 23x23 patches: point-feature-centered patches need enough CONTEXT (the
# constellation of neighboring structure) to disambiguate repetitive
# blob/corner-like appearance. Measured on true-revisit pairs of the
# rendered street circuit (evals/diag_loop.py): half=5 gave p50 8
# mutual-best matches (below any usable gate); half=11 gives p50 26 with
# 0/40 false pairs surviving RANSAC PnP.
PATCH_HALF = 11
PATCH_DIM = (2 * PATCH_HALF + 1) ** 2


def tiny_image(img: np.ndarray) -> np.ndarray:
    """(H, W) grayscale -> z-normalized (TINY_H*TINY_W,) global descriptor."""
    H, W = img.shape
    bh, bw = H // TINY_H, W // TINY_W
    t = img[: bh * TINY_H, : bw * TINY_W].astype(np.float32)
    t = t.reshape(TINY_H, bh, TINY_W, bw).mean(axis=(1, 3)).reshape(-1)
    t = t - t.mean()
    n = np.linalg.norm(t)
    return t / (n + 1e-6)


def extract_patches(img: np.ndarray, pts: np.ndarray,
                    half: int = PATCH_HALF) -> tuple[np.ndarray, np.ndarray]:
    """z-normalized square patches at integer-rounded pixel locations.

    Returns (descs (N, (2h+1)^2) float32, ok (N,) bool) — ok False where the
    patch would leave the image."""
    H, W = img.shape
    n = len(pts)
    d = 2 * half + 1
    descs = np.zeros((n, d * d), np.float32)
    ok = np.zeros(n, bool)
    xi = np.round(pts[:, 0]).astype(int)
    yi = np.round(pts[:, 1]).astype(int)
    for i in range(n):
        x, y = xi[i], yi[i]
        if x - half < 0 or x + half >= W or y - half < 0 or y + half >= H:
            continue
        p = img[y - half:y + half + 1, x - half:x + half + 1].astype(
            np.float32).reshape(-1)
        p = p - p.mean()
        nrm = np.linalg.norm(p)
        if nrm < 1e-3:
            continue  # textureless
        descs[i] = p / nrm
        ok[i] = True
    return descs, ok


def match_patches(d_new: np.ndarray, ok_new: np.ndarray,
                  d_old: np.ndarray, ok_old: np.ndarray,
                  min_score: float = 0.6, ratio: float = 0.97):
    """Mutual-best ZNCC matching with a Lowe-style ratio test.

    Returns (idx_new, idx_old) integer arrays of accepted pairs. The score
    matrix is one (N, M) matmul — on TPU this is where a pod-scale loop
    search runs, vmapped over candidate keyframes.

    Defaults are deliberately permissive (measured sweep in
    evals/diag_loop.py: the strict 0.75/0.85 pair rejected nearly all TRUE
    revisit matches on repetitive imagery): mutual-best + a soft ratio
    proposes, and RANSAC PnP downstream is the accept/reject authority —
    0/40 false place pairs survive it at these settings."""
    if not ok_new.any() or not ok_old.any():
        return np.zeros(0, int), np.zeros(0, int)
    S = d_new @ d_old.T                              # (N, M) cosine = ZNCC
    S = np.where(ok_new[:, None] & ok_old[None, :], S, -2.0)
    best_old = S.argmax(axis=1)
    best_new = S.argmax(axis=0)
    idx_new = []
    idx_old = []
    for i, j in enumerate(best_old):
        if best_new[j] != i:
            continue
        s = S[i, j]
        if s < min_score:
            continue
        row = S[i].copy()
        row[j] = -2.0
        if row.max() > ratio * s:
            continue  # ambiguous
        idx_new.append(i)
        idx_old.append(int(j))
    return np.asarray(idx_new, int), np.asarray(idx_old, int)


class PlaceIndex:
    """Append-only global-descriptor index with matvec retrieval."""

    def __init__(self, capacity: int = 4096):
        self.descs = np.zeros((capacity, TINY_H * TINY_W), np.float32)
        self.n = 0

    def add(self, desc: np.ndarray) -> int:
        k = self.n
        if k >= len(self.descs):
            self.descs = np.concatenate(
                [self.descs, np.zeros_like(self.descs)])
        self.descs[k] = desc
        self.n += 1
        return k

    def query(self, desc: np.ndarray, exclude_last: int = 40,
              min_sim: float = 0.0):
        """Best matching past keyframe (id, cosine) — or None when the
        database is empty-after-exclusion or below min_sim. exclude_last
        keeps recent keyframes from matching themselves (reference
        loop_fusion skips recent frames the same way). Callers that gate on
        similarity themselves should pass min_sim=0 and read the score —
        place recognition only PROPOSES; geometric verification (patch
        matching + RANSAC PnP) is the accept/reject authority."""
        m = self.n - exclude_last
        if m <= 0:
            return None
        sims = self.descs[:m] @ desc
        j = int(np.argmax(sims))
        return (j, float(sims[j])) if sims[j] >= min_sim else None
