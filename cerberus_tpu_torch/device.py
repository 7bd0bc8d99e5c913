"""Where the port's tensors live, and the matmul precision it runs at."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point makes its tensors on.

    The port runs on the card unless the caller names another device; it
    never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return dev


# TF32 allowed for float32 matmuls and convolutions, per precision name
_TF32 = {"highest": False, "high": True}


@contextlib.contextmanager
def matmul_precision(precision: str = "highest"):
    """Run float32 matmuls and convolutions at `precision` for the block,
    then restore `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32`.

    "highest": full float32, never TF32 — the counterpart of the JAX
    package's `jax.default_matmul_precision("highest")`; TF32 keeps ~3
    decimal digits, which swamps the weakest gradient directions (rho
    calibration, td) of the window assembly.
    "high": TF32 allowed, what `torch.set_float32_matmul_precision("high")`
    means on the card (~2x GEMM throughput at ~1e-3 relative error per
    product). This is not the JAX package's "high", which on the TPU is
    three bf16 passes (~1e-6 relative); check convergence costs before
    trusting results at "high".
    float64 and the CPU are unaffected: there both names compute the same.
    Any other name raises ValueError."""
    if precision not in _TF32:
        raise ValueError(f"matmul precision {precision!r}: want one of "
                         f"{sorted(_TF32)}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = _TF32[precision]
    torch.backends.cudnn.allow_tf32 = _TF32[precision]
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def side_stream(device: torch.device):
    """A stream of its own for a component that fetches from the card once
    per step (the tracker, the EKF), or None on the CPU. A fetch synchronises
    only its own stream, so it does not wait for the estimator's step queued
    on the default stream. PyTorch makes its streams non-blocking: they do
    not wait for the legacy default stream either."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream):
    """Make `stream` the current stream of this thread for the block (the
    current stream is per thread); a no-op for None."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def on_device(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """x (a tensor, a numpy array or a number) as a tensor on `dev`; float
    data in `dtype` when given, else in its own float type. A tensor that is
    already there in that type is returned as it is, with no copy."""
    if not torch.is_tensor(x):
        x = torch.tensor(np.asarray(x))   # a copy: the port owns its data
    if dtype is not None and x.is_floating_point():
        return x.to(device=dev, dtype=dtype)
    return x.to(device=dev)
