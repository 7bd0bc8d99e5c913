"""Nothing under vilo_bench/ imports JAX or the JAX package, and only the
harness's `Program` imports the program: the reference, the generator, the
trace reduction and the metric readers import nothing of it. Top-level
module names are compared whole (`cerberus_tpu_torch` is not
`cerberus_tpu`)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cerberus_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_the_program_only_in_the_harness(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if path.name != "harness.py":
        assert "cerberus_tpu_torch" not in names


def test_the_check_compares_whole_names():
    assert "cerberus_tpu_torch".split(".")[0] not in FORBIDDEN
    assert top_level_imports(BENCH / "harness.py") >= {"torch", "vilo_bench"}
