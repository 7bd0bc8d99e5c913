"""On the card (skips here): at a cell's own size, one seed's program
readings lie within the cell's limits and the control's (the program with
the next lower precision switched on: TF32 for a float32 cell, float32 for
a float64 one) break one of them. Each cell's readings come from the
command in a process of its own, as they do when the limits are set, with
the card's memory handed back by this process first: the float64 cell's
batch fills most of the card, and with two CUDA contexts on it, its
allocator is given expandable segments so that no block is left split.
Run with

    python -m pytest vilo_bench/tests/test_bench_control.py -m cuda
"""

import gc
import json
import os
import subprocess
import sys

import pytest
import torch

from vilo_bench import spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["fleet-f32-dense", "fleet-f64-dense",
                                  "fleet-f32-dim"])
def test_control_fails_and_program_passes(cuda, cell):
    gc.collect()
    torch.cuda.empty_cache()
    env = {**os.environ,
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    out = subprocess.run(
        [sys.executable, "-m", "vilo_bench.control", "--workload", cell,
         "--seeds", "11", "--control-seeds", "12", "--batches", "1"],
        cwd=spec.REPO, env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(l) for l in out.stdout.splitlines()]
    limits = spec.load_cell(cell).traffic["limits"]
    program, ctl = (r["numbers"] for r in rows)
    assert all(program[k] <= v for k, v in limits.items())
    assert any(ctl[k] > v for k, v in limits.items())
