"""Batched pyramidal Lucas-Kanade optical flow + Shi-Tomasi detection on
torch tensors (port of `cerberus_tpu/ops/klt.py`).

The equivalent of the reference's OpenCV front-end — pyramidal
cv::calcOpticalFlowPyrLK with forward-backward consistency checking
(reference: src/featureTracker/feature_tracker.cpp:112-151) and
cv::goodFeaturesToTrack replenishment (feature_tracker.cpp:177-195) — as one
static-shape program per frame that never reads back to the host:

  * N point slots with a validity mask (no dynamic feature counts),
  * L pyramid levels built by separable Gaussian blur + 2x subsample,
  * K fixed Gauss-Newton iterations per level,
  * bilinear patch gathers (~N*P^2 elements per image and iteration),
  * 2x2 normal equations solved in closed form per point.

Images are float32 whatever the estimator's dtype, as in the JAX package.
Coordinates are (x, y) pixels at level-0 resolution, matching OpenCV.

Where the JAX package differs for the TPU, the port follows the math:
  * patches are sampled by gathers (`_bilinear`'s math), not by the JAX
    package's hat-matrix contractions (`_sample_patches`, a workaround for
    slow TPU gathers; its test shows the two are one function);
  * the greedy min-distance suppression keeps its decision on an N x N
    "covered-by" relation and paints the kept squares at once, instead of a
    sequential slice-and-update of the occupancy image;
  * blur, Scharr and box sums add shifted images in the JAX package's order,
    so the quantized NMS scores tie and break as they do there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cerberus_tpu_torch.device import matmul_precision

_G5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_INT32_MAX = 2 ** 31 - 1


def _edge_rows(img, r):
    """img (H, W) with r rows replicated above and below."""
    H = img.shape[0]
    idx = torch.clamp(torch.arange(-r, H + r, device=img.device), 0, H - 1)
    return img[idx]


def _edge_cols(img, r):
    W = img.shape[1]
    idx = torch.clamp(torch.arange(-r, W + r, device=img.device), 0, W - 1)
    return img[:, idx]


def _shift_sum(p, k, n, axis):
    """sum_i p[i : i + n] * k[i] along axis, added in index order."""
    out = 0.0
    for i, ki in enumerate(k):
        sl = p[i:i + n] if axis == 0 else p[:, i:i + n]
        out = out + sl * ki
    return out


def _sep_blur(img: torch.Tensor) -> torch.Tensor:
    """5-tap separable Gaussian blur with edge replication, (H, W) f32."""
    img = _shift_sum(_edge_rows(img, 2), _G5, img.shape[0], 0)
    return _shift_sum(_edge_cols(img, 2), _G5, img.shape[1], 1)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Gaussian pyramid [level0 (H,W), level1 (H/2,W/2), ...], f32."""
    img = img.to(torch.float32)
    pyr = [img]
    for _ in range(levels - 1):
        img = _sep_blur(img)[::2, ::2].contiguous()
        pyr.append(img)
    return pyr


def _scharr(img: torch.Tensor):
    """Scharr x/y derivative images (3/32 · [3 10 3] ⊗ [-1 0 1])."""
    s = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    d = (-1.0, 0.0, 1.0)

    def conv1d(a, k, axis):
        if axis == 0:
            return _shift_sum(_edge_rows(a, 1), k, a.shape[0], 0)
        return _shift_sum(_edge_cols(a, 1), k, a.shape[1], 1)

    ix = conv1d(conv1d(img, d, 1), s, 0)
    iy = conv1d(conv1d(img, d, 0), s, 1)
    return ix, iy


def _bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at xy (..., 2) float (x, y) with border clamping."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    idx = y0 * W + x0
    v00 = flat[idx]
    v01 = flat[idx + 1]
    v10 = flat[idx + W]
    v11 = flat[idx + W + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


class LKResult(NamedTuple):
    pts: torch.Tensor      # (N, 2) tracked positions, level-0 pixels
    status: torch.Tensor   # (N,) bool — tracked successfully
    err: torch.Tensor      # (N,) mean absolute patch residual


def _taps(centers, half: int, size: int):
    """Per point and patch offset, the two bilinear taps along one axis:
    (i0 (N, P) int64, w0, w1 (N, P)). The weights are the JAX package's
    hat functions max(0, 1 - |w - x|) at the taps' pixels w = i0, i0 + 1,
    taken at x = clip(center + offset) as there."""
    offs = torch.arange(-half, half + 1, device=centers.device,
                        dtype=centers.dtype)
    xi = torch.clamp(centers[:, None] + offs[None, :], 0.0, size - 1.001)
    i0 = torch.floor(xi)
    w0 = torch.clamp(1.0 - torch.abs(i0 - xi), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(i0 + 1.0 - xi), min=0.0)
    return i0.to(torch.int64), w0, w1


def _sample_patches(imgs: list[torch.Tensor], cx, cy, half: int):
    """Bilinear (P, P) patches of each image at centers (cx, cy) (N,), by
    gathers: along x first, then y — the order in which the JAX package's
    separable contractions weight the taps."""
    H, W = imgs[0].shape
    ix0, wx0, wx1 = _taps(cx, half, W)                 # (N, P)
    iy0, wy0, wy1 = _taps(cy, half, H)
    # flat index of the (y0, x0) tap of every patch pixel: (N, P_y, P_x)
    base = iy0[:, :, None] * W + ix0[:, None, :]
    out = []
    for img in imgs:
        flat = img.reshape(-1)
        r0 = flat[base] * wx0[:, None, :] + flat[base + 1] * wx1[:, None, :]
        r1 = (flat[base + W] * wx0[:, None, :]
              + flat[base + W + 1] * wx1[:, None, :])
        out.append(r0 * wy0[:, :, None] + r1 * wy1[:, :, None])
    return out


def _lk_level(img0, ix0, iy0, img1, pts, guess, half=10, iters=10,
              min_eig=1e-4, margin=1):
    """One pyramid level of LK for all points. pts/guess in THIS level's
    pixels. Returns (new_guess, ok, err)."""
    H, W = img0.shape
    P2 = (2 * half + 1) ** 2
    t, gx, gy = _sample_patches([img0, ix0, iy0], pts[:, 0], pts[:, 1], half)
    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    mineig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    ok_g = mineig / P2 > min_eig
    inv = torch.where(det > 1e-12, 1.0 / torch.clamp(det, min=1e-12),
                      torch.zeros_like(det))

    v = guess - pts
    for _ in range(iters):
        (cur,) = _sample_patches([img1], pts[:, 0] + v[:, 0],
                                 pts[:, 1] + v[:, 1], half)
        d = cur - t
        bx = torch.sum(d * gx, dim=(1, 2))
        by = torch.sum(d * gy, dim=(1, 2))
        dv = -inv[:, None] * torch.stack([gyy * bx - gxy * by,
                                          gxx * by - gxy * bx], dim=1)
        v = v + dv
    (cur,) = _sample_patches([img1], pts[:, 0] + v[:, 0],
                             pts[:, 1] + v[:, 1], half)
    err = torch.mean(torch.abs(cur - t), dim=(1, 2))
    newp = pts + v
    # patch sampling clamps at borders, so only a small margin is required
    # per level; the caller applies the strict half-window margin at the
    # finest level (a point near the border of a COARSE level is still
    # trackable, as in OpenCV)
    inb = ((newp[:, 0] >= margin) & (newp[:, 0] < W - margin)
           & (newp[:, 1] >= margin) & (newp[:, 1] < H - margin))
    return newp, ok_g & inb, err


def lk_track(pyr0: list[torch.Tensor], pyr1: list[torch.Tensor],
             pts: torch.Tensor, valid: torch.Tensor,
             guess: torch.Tensor | None = None, half: int = 10,
             iters: int = 10) -> LKResult:
    """Pyramidal LK: track level-0 pixel points pts (N, 2) from pyr0 to pyr1.

    guess: optional (N, 2) motion-prediction seed at level 0 (reference:
    feature_tracker.cpp:112-133 uses predicted points when available)."""
    L = len(pyr0)
    if guess is None:
        guess = pts
    g = guess / (2 ** (L - 1))
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[0], dtype=pyr0[0].dtype, device=pts.device)
    for lvl in range(L - 1, -1, -1):
        scale = 2 ** lvl
        ix, iy = _scharr(pyr0[lvl])
        g, ok, err = _lk_level(pyr0[lvl], ix, iy, pyr1[lvl], pts / scale, g,
                               half=half, iters=iters,
                               margin=half if lvl == 0 else 1)
        ok_all = ok_all & ok
        if lvl > 0:
            g = g * 2.0
    return LKResult(pts=g, status=ok_all & valid, err=err)


def lk_track_fb(pyr0, pyr1, pts, valid, guess=None, half=10, iters=10,
                fb_thresh=0.5) -> LKResult:
    """LK with forward-backward consistency check <= fb_thresh px
    (reference: flow_back, feature_tracker.cpp:135-151). The backward pass
    runs on a single pyramid level seeded at the original points, like the
    reference's cv::calcOpticalFlowPyrLK(..., maxLevel=1,
    OPTFLOW_USE_INITIAL_FLOW)."""
    fwd = lk_track(pyr0, pyr1, pts, valid, guess, half, iters)
    bwd = lk_track(pyr1[:1], pyr0[:1], fwd.pts, fwd.status, pts, half, iters)
    dist = torch.linalg.vector_norm(bwd.pts - pts, dim=-1)
    ok = fwd.status & bwd.status & (dist <= fb_thresh)
    return LKResult(pts=fwd.pts, status=ok, err=fwd.err)


# ---------------------------------------------------------------------------
# Fused per-frame tracking program (serving path)
# ---------------------------------------------------------------------------


def _greedy_mask(pts, status, priority, min_dist, shape):
    """Greedy min-distance suppression preferring long tracks (reference:
    feature_tracker.cpp:55-84 — iterate tracks by descending track count,
    keep a point iff its pixel is unmasked, then mask its min_dist
    neighborhood). The masked square is shifted (not clipped) within
    min_dist of the border, as in the JAX package.

    The sequential decision runs on the N x N relation cov[i, j] = "point
    i's pixel lies in point j's square" (in visiting order), one small step
    per slot; the kept squares are then painted at once. Returns (keep (N,)
    bool, occupancy (H, W) bool)."""
    H, W = shape
    N = pts.shape[0]
    dev = pts.device
    side = 2 * min_dist + 1
    # invalid/failed slots sort last and are never kept; the stable sort
    # keeps equal priorities in slot order, as jnp.argsort does
    key = torch.where(status, -priority.to(torch.int64),
                      torch.full_like(priority, _INT32_MAX, dtype=torch.int64))
    order = torch.sort(key, stable=True).indices
    x = torch.clamp(torch.round(pts[:, 0]).to(torch.int64), 0, W - 1)[order]
    y = torch.clamp(torch.round(pts[:, 1]).to(torch.int64), 0, H - 1)[order]
    y0 = torch.clamp(y - min_dist, 0, H - side)
    x0 = torch.clamp(x - min_dist, 0, W - side)
    cov = ((y[:, None] >= y0[None, :]) & (y[:, None] < y0[None, :] + side)
           & (x[:, None] >= x0[None, :]) & (x[:, None] < x0[None, :] + side))
    st = status[order]
    keep_o = torch.zeros(N, dtype=torch.bool, device=dev)
    for i in range(N):
        keep_o[i] = st[i] & ~torch.any(cov[i] & keep_o)
    keep = torch.zeros(N, dtype=torch.bool, device=dev)
    keep[order] = keep_o
    # paint: occ[r, c] = any kept square covers row r and column c; the
    # counts are small integers, exact in full f32
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    in_r = ((rows >= y0[None, :]) & (rows < y0[None, :] + side)
            & keep_o[None, :]).to(torch.float32)                # (H, N)
    in_c = ((cols.T >= x0[None, :])
            & (cols.T < x0[None, :] + side)).to(torch.float32)  # (W, N)
    with matmul_precision("highest"):
        occ = (in_r @ in_c.T) > 0
    return keep, occ


def track_frame(prev_pyr, img0_u8, img1_u8, pts, valid, guess, priority,
                levels=4, half=10, iters=10, min_dist=10, fb_thresh=0.5,
                stereo=True, det_stereo=32):
    """ONE program for a full tracker frame: build the new pyramid,
    pyramidal LK prev->cur with forward-backward check, greedy min-distance
    suppression, Shi-Tomasi replenishment candidates, and (stereo) the
    left->right LK — the whole per-frame device work of the reference's
    trackImage (feature_tracker.cpp:94-302), with no read-back to the host.

    prev_pyr: tuple of L tensors from the previous call (on the device; pass
      the returned `pyr0`). Images enter as uint8 tensors.
    Returns dict: pts (N,2), keep (N,), err (N,), det_pts (N,2), det_ok
      (N,), r_pts (N+det_stereo,2), r_ok (N+det_stereo,), pyr0 (tuple,
      carry to next call). The stereo pass covers BOTH the kept tracked
      points (rows [0:N]) and the top-`det_stereo` replenishment candidates
      (rows [N:N+det_stereo], aligned with det_pts[:det_stereo] — detections
      come in score order, the order the host adopts them), so a newly
      detected feature gets its right-camera observation in the SAME frame,
      as the reference matches stereo after replenishment
      (feature_tracker.cpp:202-245).
    """
    img0 = img0_u8.to(torch.float32)
    pyr0 = tuple(build_pyramid(img0, levels))
    fwd = lk_track_fb(list(prev_pyr), list(pyr0), pts, valid, guess,
                      half=half, iters=iters, fb_thresh=fb_thresh)
    keep, occ = _greedy_mask(fwd.pts, fwd.status, priority, min_dist,
                             img0.shape)
    det_pts, det_ok = _detect_with_occ(pyr0[0], occ, pts.shape[0], min_dist)
    ds = min(det_stereo, pts.shape[0])
    s_pts = torch.cat([fwd.pts, det_pts[:ds]], dim=0)
    s_val = torch.cat([keep, det_ok[:ds]], dim=0)
    if stereo:
        pyr1 = tuple(build_pyramid(img1_u8.to(torch.float32), levels))
        right = lk_track_fb(list(pyr0), list(pyr1), s_pts, s_val,
                            half=half, iters=iters, fb_thresh=fb_thresh)
        r_pts, r_ok = right.pts, right.status
    else:
        r_pts, r_ok = s_pts, torch.zeros_like(s_val)
    return dict(pts=fwd.pts, keep=keep, err=fwd.err, det_pts=det_pts,
                det_ok=det_ok, r_pts=r_pts, r_ok=r_ok, pyr0=pyr0)


# ---------------------------------------------------------------------------
# Shi-Tomasi detection (cv::goodFeaturesToTrack equivalent)
# ---------------------------------------------------------------------------

def shi_tomasi(img: torch.Tensor, win: int = 3) -> torch.Tensor:
    """(H, W) min-eigenvalue corner response over a (2*win+1)^2 window."""
    ix, iy = _scharr(img.to(torch.float32))

    def box(a):
        k = 2 * win + 1
        p = _edge_cols(_edge_rows(a, win), win)
        out = torch.zeros_like(a)
        for dy in range(k):
            for dx in range(k):
                out = out + p[dy:dy + a.shape[0], dx:dx + a.shape[1]]
        return out / (k * k)

    gxx = box(ix * ix)
    gxy = box(ix * iy)
    gyy = box(iy * iy)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


def _maxpool(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over the (2 radius + 1)^2 window, outside the image ignored. The
    window is a float32 max pool (padded with -inf): integer scores here
    are below 2^24 (quantized scores <= 1e6, flat indices < H*W), exact in
    float32, and a max is exact in any order."""
    k = 2 * radius + 1
    out = F.max_pool2d(score.to(torch.float32)[None, None], k, stride=1,
                       padding=radius)[0, 0]
    return out.to(score.dtype)


def detect_features(img: torch.Tensor, occupied: torch.Tensor, max_new: int,
                    min_dist: int = 10, border: int = 12,
                    quality: float = 0.01):
    """Top-`max_new` Shi-Tomasi corners with non-max suppression and an
    occupancy mask (existing tracks + their min_dist neighborhoods), the
    static-shape counterpart of the reference's mask+goodFeaturesToTrack
    (feature_tracker.cpp:55-84, 177-195).

    occupied: (H, W) bool — True where new detections are forbidden.
    Returns (pts (max_new, 2) float32 (x, y), ok (max_new,) bool)."""
    return _detect_with_occ(img, occupied, max_new, min_dist, border, quality)


def _detect_with_occ(img, occupied, max_new, min_dist, border=12,
                     quality=0.01):
    H, W = img.shape
    dev = img.device
    score = shi_tomasi(img)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    # exact NMS with tie-breaking: corner responses plateau (checkerboards),
    # and a >=-only NMS keeps whole plateaus. Quantize the score to int32 and
    # argmax-by-index among window ties (two integer maxpools) — survivors are
    # then strictly > min_dist apart.
    smax = torch.max(score)
    si = torch.round(score / torch.clamp(smax, min=1e-30)
                     * 1e6).to(torch.int32)
    idx32 = (xx + W * yy).to(torch.int32)
    m1 = _maxpool(si, min_dist)
    m2 = _maxpool(torch.where(si == m1, idx32, torch.full_like(idx32, -1)),
                  min_dist)
    nms = (si == m1) & (idx32 == m2)
    # block detections near occupied pixels
    occ = _maxpool(occupied.to(torch.float32), min_dist) > 0
    inb = ((xx >= border) & (xx < W - border)
           & (yy >= border) & (yy < H - border))
    good = nms & inb & (~occ) & (score > quality * smax)
    flat = torch.where(good, score,
                       torch.full_like(score, float("-inf"))).reshape(-1)
    # top max_new by score, ties in index order (as lax.top_k)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_new], idx[:max_new]
    pts = torch.stack([(idx % W).to(torch.float32),
                       (idx // W).to(torch.float32)], -1)
    return pts, vals > float("-inf")
