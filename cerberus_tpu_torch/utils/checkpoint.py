"""Checkpoint / resume of estimator state (port of
`cerberus_tpu/utils/checkpoint.py`).

The reference has no persistence at all — a crash loses the trajectory
(SURVEY.md §5). Here the full sliding-window state (poses, biases, rho,
extrinsics, marginalization prior + linearization point, feature slots,
interval buffers, samples not yet closed into an interval) round-trips
through one `.npz`, so a run can resume mid-trajectory, on the card or the
CPU.

The file keeps the JAX package's keys, so either package loads what the
other wrote. The port adds the interval preintegrations themselves
(`preint_saved`, `pre<k>_<field>`): a port checkpoint then resumes exactly
where it was saved. A file without them (the JAX package's) re-preintegrates
each buffer at the saved biases and rho on load, as the JAX package's
loader does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_STATE = ("p", "q", "v", "ba", "bg", "rho", "tic", "qic")
_FM = ("active", "ids", "start", "obs", "stereo", "pts", "pts_r", "vel",
       "vel_r", "td", "depth")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_estimator(est, path: str):
    """Serialize an Estimator to a single .npz (atomic rename). The step in
    flight is adopted first (est.flush()); the estimator goes on as if it
    had not been saved."""
    from cerberus_tpu_torch.ops.preintegration import ILPreint

    est.flush()
    fm = est.fm
    payload = dict(
        p=est.p, q=est.q, v=est.v, ba=est.ba, bg=est.bg, rho=est.rho,
        tic=est.tic, qic=est.qic, td=np.asarray(est.td),
        headers=est.headers, frame_count=np.asarray(est.frame_count),
        solver_flag=np.asarray(est.solver_flag),
        open_ex=np.asarray(est.open_ex_estimation),
        **{f"fm_{k}": getattr(fm, k) for k in _FM},
    )
    if est.prior is not None:
        pj, pr, lin = est.prior[:3]
        payload["prior_J"] = _np(pj)
        payload["prior_r"] = _np(pr)
        payload["prior_valid"] = _np(est.prior[3] if len(est.prior) > 3
                                     else True)
        for k in _STATE:
            payload[f"prior_lin_{k}"] = _np(getattr(lin, k))
        payload["prior_lin_td"] = _np(lin.td)
    for k in range(10):
        buf = est.buffers[k]
        if buf is not None and len(buf):
            payload[f"buf{k}_t"] = np.asarray(buf.t)
            for f in ("acc", "gyr", "phi", "dphi", "c"):
                payload[f"buf{k}_{f}"] = np.stack(getattr(buf, f))
    saved = np.array([pre is not None for pre in est.preints])
    payload["preint_saved"] = saved
    for k in np.nonzero(saved)[0]:
        for f in ILPreint._fields:
            payload[f"pre{k}_{f}"] = _np(getattr(est.preints[k], f))
    # in-flight samples not yet closed into an interval; extract() consumes
    # them, so the estimator's sync is refilled with the same rows (the
    # boundary sample at prev_img_t first, which interpolates to itself)
    if est.prev_img_t is not None:
        latest = est.sync.latest_time()
        if latest > est.prev_img_t:
            rows = est.sync.extract(est.prev_img_t, latest)
            if rows is not None and len(rows):
                payload["pending_rows"] = rows
                est.sync = type(est.sync)()
                _push_rows(est.sync, rows)
        payload["prev_img_t"] = np.asarray(est.prev_img_t)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _push_rows(sync, rows):
    for r in rows:
        sync.push(r[0], r[1:4], r[4:7], r[7:19], r[19:31], r[31:35])


def load_estimator(est, path: str):
    """Restore state saved by save_estimator (of either package) into an
    Estimator instance (constructed with the same config/capacities); its
    tensors go to the estimator's device and dtype."""
    from cerberus_tpu_torch.estimator.estimator import IntervalBuffer
    from cerberus_tpu_torch.ops import factors as fac
    from cerberus_tpu_torch.ops.preintegration import ILPreint

    z = np.load(path, allow_pickle=False)
    for k in (*_STATE, "headers"):
        getattr(est, k)[...] = z[k]
    est.td = float(z["td"])
    est.frame_count = int(z["frame_count"])
    est.solver_flag = int(z["solver_flag"])
    est.open_ex_estimation = bool(z["open_ex"])
    fm = est.fm
    for k in _FM:
        getattr(fm, k)[...] = z[f"fm_{k}"]
    fm.id_to_slot = {int(fm.ids[s]): int(s)
                     for s in np.nonzero(fm.active)[0]}
    dev = lambda a, dtype=est.dtype: torch.tensor(np.asarray(a), dtype=dtype,
                                                  device=est.device)
    if "prior_J" in z:
        lin = fac.WindowState.zero(est.F, est.dtype, device=est.device)
        lin = lin._replace(**{k: dev(z[f"prior_lin_{k}"]) for k in _STATE},
                           td=dev(z["prior_lin_td"]))
        valid = dev(z["prior_valid"] if "prior_valid" in z else True,
                    torch.bool)
        est.prior = (dev(z["prior_J"]), dev(z["prior_r"]), lin, valid)
    else:
        est.prior = None
    saved = z["preint_saved"] if "preint_saved" in z else None
    for k in range(10):
        if f"buf{k}_t" in z:
            buf = IntervalBuffer()
            ts = z[f"buf{k}_t"]
            for i in range(len(ts)):
                buf.append(ts[i], z[f"buf{k}_acc"][i], z[f"buf{k}_gyr"][i],
                           z[f"buf{k}_phi"][i], z[f"buf{k}_dphi"][i],
                           z[f"buf{k}_c"][i])
            est.buffers[k] = buf
        else:
            est.buffers[k] = None
        if saved is not None:
            est.preints[k] = None if not saved[k] else ILPreint(**{
                f: dev(z[f"pre{k}_{f}"], _preint_dtype(f, est.dtype))
                for f in ILPreint._fields})
        elif est.buffers[k] is not None:
            est.preints[k] = est._run_preint(est.buffers[k], est.ba[k],
                                             est.bg[k], est.rho[k])
        else:
            est.preints[k] = None
    if "prev_img_t" in z:
        est.prev_img_t = float(z["prev_img_t"])
    if "pending_rows" in z:
        _push_rows(est.sync, z["pending_rows"])
    return est


def _preint_dtype(field: str, dtype):
    return {"integration_contact": torch.bool,
            "ff_idx": torch.int32}.get(field, dtype)
