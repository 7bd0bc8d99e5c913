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


@contextlib.contextmanager
def full_f32_matmuls():
    """Run float32 matmuls and convolutions in full float32, never TF32.

    The counterpart of the JAX package's
    `jax.default_matmul_precision("highest")`: TF32 keeps ~3 decimal digits,
    which swamps the weakest gradient directions (rho calibration, td) of the
    window assembly. Sets `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` to False for the block and restores
    them after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
