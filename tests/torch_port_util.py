"""Shared helpers of the tests that hold the PyTorch port (cerberus_tpu_torch)
against the JAX package: a JAX window carried to the port as numpy arrays
(cerberus_tpu_torch.convert), and comparisons that report their largest
difference."""

import numpy as np
import torch

from cerberus_tpu_torch import convert


def to_port(state, data, dtype=torch.float64):
    """JAX package (WindowState, WindowData) -> the port's, on the CPU."""
    as_np = lambda nt: type(nt)(*(as_np(x) if isinstance(x, tuple)
                                  else np.asarray(x) for x in nt))
    return convert.window_from_numpy(as_np(state), as_np(data),
                                     device="cpu", dtype=dtype)


def np_tree(nt, prefix=""):
    """Flatten a (port or JAX) NamedTuple, dict or tuple, nested, to
    {path: numpy array}."""
    if isinstance(nt, dict):
        items = nt.items()
    elif isinstance(nt, tuple):
        items = zip(getattr(nt, "_fields", range(len(nt))), nt)
    else:
        return {prefix: np.asarray(nt.detach().cpu() if torch.is_tensor(nt)
                                   else nt)}
    out = {}
    for k, v in items:
        out.update(np_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def assert_close(name, got, want, rtol, atol):
    """np.testing.assert_allclose (NaN fails) that first prints the largest
    difference as `PORT_DIFF <name> max_abs=... max_rel=...` (max_rel:
    max |got - want| over max |want|); `pytest -rP` shows these lines for
    passing tests."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    max_abs = float(np.abs(got - want).max()) if want.size else 0.0
    ref = float(np.abs(want).max()) if want.size else 0.0
    max_rel = max_abs / ref if ref else max_abs
    print(f"PORT_DIFF {name} max_abs={max_abs:.3e} max_rel={max_rel:.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name,
                               equal_nan=False)


def assert_rel(name, got, want, tol):
    """assert_close at rtol = tol and atol = tol * max(1, max |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert_close(name, got, want, tol, tol * scale)
