"""The benchmark's files, found by the names in BENCHMARK.json: a cell's
configuration, its entry (`entries/<entry>.py`, named by the
configuration), its traffic file (`workloads/<traffic>.json`) and the
metric entries it reports. Imports nothing heavy, so that a run can start
its window workers before it imports torch."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
DEFAULT_ENTRY = "fleet"    # the entry of a configuration that names none


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list    # metric entries this cell reports with --trace 0
    per_layer: list     # metric entries this cell reports with --trace 1
    root: Path          # the benchmark folder the cell's files were read from
    entry: Path         # the entry module that runs the cell's requests


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def entry_path(name: str, root=ROOT) -> Path:
    """`root`/entries/<name>.py; raises FileNotFoundError, naming the file,
    where there is none."""
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_-]*", name):
        raise ValueError(f"entry {name!r} is not a module name")
    path = Path(root) / "entries" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no entry module {path} (entry {name!r})")
    return path


def load_cell(name: str, repo=REPO) -> Cell:
    """The cell `name` of `repo`/BENCHMARK.json with its configuration
    (the file its `configs` entry names), its traffic (workloads/), its
    metric entries and the path of its entry module."""
    repo = Path(repo)
    bench = load_json(repo / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {repo / 'BENCHMARK.json'}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    root = repo / ROOT.name
    cfg = load_json(repo / cfg_entry["file"])
    traffic = load_json(root / "workloads" / f"{w['traffic']}.json")
    return Cell(name, w["chips"], cfg, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root,
                entry_path(cfg.get("entry", DEFAULT_ENTRY), root))
