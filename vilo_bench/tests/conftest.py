"""A small copy of the benchmark for CPU tests: the repository's
BENCHMARK.json, the benchmark's data files and its entries in a temporary
directory, cut to F = 16 feature slots and batches of 4 windows."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def small_repo(tmp_path: Path, iters: int = 12) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for d in ("configs", "workloads", "metrics", "entries"):
        shutil.copytree(REPO / "vilo_bench" / d, tmp_path / "vilo_bench" / d)
    for p in (tmp_path / "vilo_bench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["max_features"] = 16
        c["solver"]["max_iters"] = iters
        p.write_text(json.dumps(c))
    for p in (tmp_path / "vilo_bench" / "workloads").glob("*.json"):
        t = json.loads(p.read_text())
        t["batch"] = 4
        p.write_text(json.dumps(t))
    return tmp_path


@pytest.fixture
def small(tmp_path):
    return small_repo(tmp_path)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lane kernel has no CPU mode")
    return torch.device("cuda")
