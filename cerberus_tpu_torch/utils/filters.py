"""Streaming filters (port of `cerberus_tpu/utils/filters.py`).

MovingWindowFilter: O(1) moving average with Neumaier-compensated summation,
capability-equivalent of the reference's filter (reference:
src/utils/filter.hpp:15-75), a host-side NumPy class for the sensor
preprocessing path (the port's own copy; the same numbers).
`moving_average_batch` is the batched causal form on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


class MovingWindowFilter:
    """O(1) moving average over a fixed window with compensated summation."""

    def __init__(self, window_size: int, dim: int = 1):
        if window_size <= 0:
            raise ValueError(f"window_size must be positive, got {window_size}")
        self.window = window_size
        self.buf = np.zeros((window_size, dim))
        self.idx = 0
        self.count = 0
        self.sum = np.zeros(dim)
        self.correction = np.zeros(dim)

    def _neumaier_add(self, value):
        new_sum = self.sum + value
        big = np.abs(self.sum) >= np.abs(value)
        self.correction = self.correction + np.where(
            big, (self.sum - new_sum) + value, (value - new_sum) + self.sum)
        self.sum = new_sum

    def update(self, value) -> np.ndarray:
        value = np.atleast_1d(np.asarray(value, float))
        if self.count == self.window:
            self._neumaier_add(-self.buf[self.idx])
        else:
            self.count += 1
        self.buf[self.idx] = value
        self.idx = (self.idx + 1) % self.window
        self._neumaier_add(value)
        return (self.sum + self.correction) / self.count

    @property
    def average(self) -> np.ndarray:
        return (self.sum + self.correction) / max(self.count, 1)


def moving_average_batch(x: torch.Tensor, window: int) -> torch.Tensor:
    """Batched causal moving average along axis 0.

    x: (T, ...) -> (T, ...); mean over the trailing `window` samples
    (fewer at the start)."""
    c = torch.cumsum(x, dim=0)
    shifted = torch.cat([torch.zeros_like(c[:window]), c[:-window]], dim=0)
    n = torch.clamp(torch.arange(1, x.shape[0] + 1, device=x.device),
                    max=window)
    n = n.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    return (c - shifted) / n
