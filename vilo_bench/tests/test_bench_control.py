"""On the card (skips here): at a cell's own size, one seed's program
readings lie within the cell's limits and the control's (the program with
the next lower precision switched on: TF32 for a float32 cell, float32 for
a float64 one) break one of them. Run with

    python -m pytest vilo_bench/tests/test_bench_control.py -m cuda
"""

import json

import pytest

from vilo_bench import control, spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["fleet-f32-dense", "fleet-f64-dense",
                                  "fleet-f32-dim"])
def test_control_fails_and_program_passes(cuda, cell, capsys):
    assert control.main(["--workload", cell, "--seeds", "11",
                         "--control-seeds", "12", "--batches", "1"]) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    limits = spec.load_cell(cell).traffic["limits"]
    program, ctl = (r["numbers"] for r in rows)
    assert all(program[k] <= v for k, v in limits.items())
    assert any(ctl[k] > v for k, v in limits.items())
