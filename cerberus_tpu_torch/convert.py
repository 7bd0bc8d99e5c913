"""Carry a window between the JAX package and the port as numpy arrays.

`window_from_numpy` takes a WindowState and a WindowData whose leaves are
numpy arrays (the JAX package's NamedTuples after `np.asarray` on every
leaf, or any object with the same field names as attributes) and makes the
port's.
`window_to_numpy` goes back: the port's NamedTuples with numpy leaves, from
which the JAX package's types are made field by field.
`ekf_state_from_numpy` / `ekf_state_to_numpy` carry the legged EKF's
`EKFState` the same way, `sfm_result_*` the initial SfM's `SfmResult` and
`fleet_result_*` the fleet's `FleetResult`. (The pose graph's carrier is
its `.npz` file: `loop.posegraph.save_pose_graph` / `load_pose_graph`.)
Nothing of the JAX package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from cerberus_tpu_torch.device import resolve_device
from cerberus_tpu_torch.estimator.initial_sfm import SfmResult
from cerberus_tpu_torch.frontend.ekf import EKFState
from cerberus_tpu_torch.ops import factors as fac
from cerberus_tpu_torch.parallel.fleet import FleetResult


def _to_port(cls, obj, conv):
    fields = {}
    for name in cls._fields:
        x = getattr(obj, name)
        fields[name] = (_to_port(fac.WindowState, x, conv)
                        if name == "prior_lin" else conv(x))
    return cls(**fields)


def _converter(device, dtype):
    dev = resolve_device(device)

    def conv(x):
        a = np.asarray(x)      # torch.tensor copies: the port owns its data
        if a.dtype.kind == "f":
            return torch.tensor(a, dtype=dtype, device=dev)
        return torch.tensor(a, device=dev)

    return conv


def window_from_numpy(state_np, data_np, *, device="cuda",
                      dtype=torch.float64):
    """(WindowState, WindowData) of the port on `device`: float leaves in
    `dtype`, bool and int leaves keep their type."""
    conv = _converter(device, dtype)
    return (_to_port(fac.WindowState, state_np, conv),
            _to_port(fac.WindowData, data_np, conv))


def window_to_numpy(state: fac.WindowState, data: fac.WindowData):
    """The port's (WindowState, WindowData) with numpy leaves."""
    to_np = lambda t: t.detach().cpu().numpy()
    return fac.map_tensors(to_np, state), fac.map_tensors(to_np, data)


def ekf_state_from_numpy(state_np, *, device="cuda", dtype=torch.float64):
    """The port's EKFState on `device` from an object with EKFState's field
    names whose leaves are numpy arrays (the JAX package's EKFState after
    `np.asarray` on every leaf): float leaves in `dtype`, the int32 ring
    index as it is."""
    return _to_port(EKFState, state_np, _converter(device, dtype))


def ekf_state_to_numpy(state: EKFState) -> EKFState:
    """The port's EKFState with numpy leaves."""
    return EKFState(*(t.detach().cpu().numpy() for t in state))


def sfm_result_from_numpy(res_np, *, device="cuda", dtype=torch.float64):
    """The port's SfmResult on `device` from an object with SfmResult's
    field names and numpy leaves (the JAX package's after `np.asarray`)."""
    return _to_port(SfmResult, res_np, _converter(device, dtype))


def sfm_result_to_numpy(res: SfmResult) -> SfmResult:
    """The port's SfmResult with numpy leaves."""
    return SfmResult(*(t.detach().cpu().numpy() for t in res))


def fleet_result_from_numpy(res_np, *, device="cuda", dtype=torch.float32):
    """The port's FleetResult on `device` from an object with FleetResult's
    field names (its states a WindowState's) and numpy leaves."""
    conv = _converter(device, dtype)
    return FleetResult(
        states=_to_port(fac.WindowState, res_np.states, conv),
        **{k: conv(getattr(res_np, k)) for k in FleetResult._fields[1:]})


def fleet_result_to_numpy(res: FleetResult) -> FleetResult:
    """The port's FleetResult with numpy leaves."""
    to_np = lambda t: t.detach().cpu().numpy()
    return FleetResult(fac.map_tensors(to_np, res.states),
                       *(to_np(t) for t in res[1:]))
