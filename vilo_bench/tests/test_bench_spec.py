"""The harness is driven by data: a cell, its traffic and a per-layer
metric added as files and BENCHMARK.json entries are found by name, with
no edit to any file that was there."""

import json

from vilo_bench import harness, spec
from vilo_bench.entries import fleet as FLEET



def test_finds_a_workload_and_a_metric_added_as_files(small):
    bench = json.loads((small / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (small / "vilo_bench/workloads/fleet-f32-dense.json").read_text())
    traffic["n_landmarks"] = 123
    (small / "vilo_bench/workloads/fleet-f32-new.json").write_text(
        json.dumps(traffic))
    (small / "vilo_bench/metrics/batch_windows.py").write_text(
        "def read(r):\n    return float(r.batch)\n")
    bench["workloads"].append({"name": "fleet-f32-new", "config": "a1-fleet-f32",
                               "traffic": "fleet-f32-new", "chips": 1,
                               "why": "a cell added as data"})
    bench["per_layer"].append({"name": "batch_windows", "unit": "windows",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "windows_per_s",
                               "workloads": ["fleet-f32-new"]})
    (small / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("fleet-f32-new", small)
    assert cell.traffic["n_landmarks"] == 123
    assert cell.cfg["name"] == "a1-fleet-f32"
    assert [m["name"] for m in cell.per_layer][-1] == "batch_windows"
    old = spec.load_cell("fleet-f32-dense", small)
    assert "batch_windows" not in [m["name"] for m in old.per_layer]
    r = FLEET.Reading(None, (0, 0), 12, 7, 222, "float32")
    assert harness.metric_reader("batch_windows", cell.root)(r) == 7.0


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["limits"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert (cell.root / "metrics" / f"{m['name']}.py").exists()
