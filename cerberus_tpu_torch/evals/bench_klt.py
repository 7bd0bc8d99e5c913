"""Throughput of the on-device KLT front-end, batched over camera streams
(port of the JAX repo's `evals/bench_klt.py`).

The reference's front-end is single-threaded OpenCV, one KLT per process.
Here the pyramidal forward-backward LK of N point slots runs under
`torch.func.vmap` over B independent streams (environment variable
KLT_BATCH, default 16), pyramids built inside the timed program, on
640x480 images (a smoothed default_rng(0) texture and its 3 px roll).

Runs on the card unless `--device cpu` is given (no fallback); images and
points are float32 on either, as in the JAX driver. Prints one JSON line:
streams tracked per second and point tracks per second. `--out FILE`
writes it too; without it no file is written.

    KLT_BATCH=16 python -m cerberus_tpu_torch.evals.bench_klt [--reps 8] \
        [--device cuda|cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch.func import vmap

from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.evals.measure import Timer, device_name
from cerberus_tpu_torch.ops import klt

H, W, N = 480, 640, 150    # reference: 640x480, max_cnt 120-250
LEVELS = 4                 # the DeviceTracker default (OpenCV maxLevel=3)
SHIFT = 3                  # px, the second image's roll along x


def make_inputs(B, dev, H=H, W=W, N=N):
    """The JAX driver's inputs (:41-51): per stream a default_rng(0)
    uniform texture at a quarter of the size, upsampled 4x and blurred
    twice, the same image rolled by SHIFT px along x, and N points uniform
    30 px inside the border, all valid. Returns (img0, img1, pts, valid)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(B, H // 4, W // 4)).astype(np.float32)
    img0 = torch.as_tensor(np.repeat(np.repeat(base, 4, 1), 4, 2),
                           device=dev)
    img0 = vmap(lambda im: klt._sep_blur(klt._sep_blur(im)))(img0)
    img1 = torch.roll(img0, SHIFT, dims=2)
    pts = torch.as_tensor(
        rng.uniform([30, 30], [W - 30, H - 30], size=(B, N, 2)),
        dtype=torch.float32, device=dev)
    valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    return img0, img1, pts, valid


def track(i0, i1, p, v, levels=LEVELS):
    """One stream: both pyramids, then forward-backward LK; LKResult."""
    return klt.lk_track_fb(klt.build_pyramid(i0, levels),
                           klt.build_pyramid(i1, levels), p, v)


def track_batch(img0, img1, pts, valid, levels=LEVELS):
    """`track` over the streams (leading axis B) under vmap."""
    return vmap(lambda *a: track(*a, levels))(img0, img1, pts, valid)


def one(i0, i1, p, v, levels=LEVELS):
    """The JAX driver's per-stream scalar: sum of the tracked points plus
    the count of tracked points."""
    res = track(i0, i1, p, v, levels)
    return res.pts.sum() + res.status.sum()


def batch_scalar(img0, img1, pts, valid):
    return vmap(one)(img0, img1, pts, valid).sum()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where everything runs; no fallback when the card "
                         "is missing")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B = int(os.environ.get("KLT_BATCH", "16"))
    img0, img1, pts, valid = make_inputs(B, dev)
    timer = Timer(args.reps, verbose=False)
    dt = timer.ms("klt", batch_scalar, img0, img1, pts, valid,
                  vary=lambda a, k: (a[0], a[1], a[2] + 0.001 * k, a[3])) \
        / 1e3
    result = dict(
        metric="klt_streams_per_s", value=round(B / dt, 2),
        unit="streams/s", point_tracks_per_s=round(B * N / dt, 0),
        batch=B, points=N, resolution=f"{W}x{H}", levels=LEVELS,
        platform=dev.type, device_name=device_name(dev),
        batch_latency_ms=round(dt * 1000, 3),
        note="fb-checked pyramidal LK incl. pyramid build, per stereo-pair "
             "tick", _launches=timer.launches)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
