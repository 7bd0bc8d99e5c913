"""Structured metrics stream (JSONL) (port of
`cerberus_tpu/utils/metrics.py`).

The reference's observability is printf + ROS topics + a CSV
(reference: visualization.cpp:109-169, main.cpp:152-197). This is the
framework-native equivalent: an append-only JSONL stream of typed events
(one object per line, `kind` + fields + wall clock), cheap enough to leave
on in production and trivially machine-readable for dashboards/regression
tracking. The estimator emits `solve` and `reboot` events when a
MetricsLogger is attached (Estimator.metrics).
"""

from __future__ import annotations

import json
import time


class MetricsLogger:
    def __init__(self, path: str, flush_every: int = 50):
        self.f = open(path, "w")
        self.flush_every = flush_every
        self._n = 0
        self.t0 = time.time()

    def log(self, kind: str, **fields):
        rec = {"kind": kind, "wall_s": round(time.time() - self.t0, 4)}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in fields.items()})
        self.f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self.f.flush()

    def close(self):
        self.f.flush()
        self.f.close()


def read_metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]
